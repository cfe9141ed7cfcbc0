"""idle_ms_per_req.localize.match: device idle time of the traced window whose
innermost open host range is the program's ``localize.match`` span (the
landmark mask, ``match_float_streaming`` (K4 and the ratio test), the
accepted matches, the landmark gather and the normalized keypoints), per
request of the traced batches."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"] or "localize.match" not in tr.idle:
        return None
    return 1e3 * tr.idle["localize.match"] / w["requests"]
