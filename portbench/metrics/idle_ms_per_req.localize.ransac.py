"""idle_ms_per_req.localize.ransac: device idle time of the traced window
whose innermost open host range is the program's ``localize.ransac`` span
(the Gumbel draw, then sampling, minimal solves, scoring and the pick), per
request of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "localize.ransac" not in tr.idle:
        return None
    return 1e3 * tr.idle["localize.ransac"] / w["requests"]
