"""device_ms_per_req.localize.refine: device time of the operations launched
inside the program's ``localize.refine`` spans (the Gauss-Newton refine,
the final residuals, inlier counts and confidence), per request of the
traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "localize.refine" not in tr.in_range:
        return None
    return 1e3 * tr.in_range["localize.refine"] / w["requests"]
