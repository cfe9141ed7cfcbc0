"""idle_ms_per_req.serve.stack: device idle time of the traced window whose
innermost open host range is the program's ``serve.stack`` span (stacking a
group's query features and intrinsics onto the device: the features cell's
pageable copies), per request of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "serve.stack" not in tr.idle:
        return None
    return 1e3 * tr.idle["serve.stack"] / w["requests"]
