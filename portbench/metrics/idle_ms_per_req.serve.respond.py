"""idle_ms_per_req.serve.respond: device idle time of the traced window whose
innermost open host range is the program's ``serve.respond`` span (the
per-request ``fuse`` and answer dicts), per request of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "serve.respond" not in tr.idle:
        return None
    return 1e3 * tr.idle["serve.respond"] / w["requests"]
