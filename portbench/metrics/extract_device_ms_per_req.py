"""extract_device_ms_per_req: device time of the operations launched inside
the program's ``extract`` ranges (``LOGGER.scope``), per request whose batch
started in the traced window."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["images"] or tr.in_range.get("extract", 0.0) <= 0:
        return None
    return 1e3 * tr.in_range["extract"] / w["requests"]
