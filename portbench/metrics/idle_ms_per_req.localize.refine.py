"""idle_ms_per_req.localize.refine: device idle time of the traced window
whose innermost open host range is the program's ``localize.refine`` span
(the Gauss-Newton refine, the final residuals, inlier counts and
confidence), per request of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "localize.refine" not in tr.idle:
        return None
    return 1e3 * tr.idle["localize.refine"] / w["requests"]
