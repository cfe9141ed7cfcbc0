"""device_ms_per_req.localize.ransac: device time of the operations launched
inside the program's ``localize.ransac`` spans (the Gumbel draw, then
sampling, minimal solves, scoring and the pick), per request of the traced
batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "localize.ransac" not in tr.in_range:
        return None
    return 1e3 * tr.in_range["localize.ransac"] / w["requests"]
