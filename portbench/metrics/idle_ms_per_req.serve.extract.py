"""idle_ms_per_req.serve.extract: device idle time of the traced window whose
innermost open host range is the program's ``serve.extract`` span (the
service's own host code around extraction: grouping the image requests,
stacking a group's images, slicing the features per request), per request
of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "serve.extract" not in tr.idle:
        return None
    return 1e3 * tr.idle["serve.extract"] / w["requests"]
