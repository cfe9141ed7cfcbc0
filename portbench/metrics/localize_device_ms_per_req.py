"""localize_device_ms_per_req: device time of everything the batches
launched outside the program's ``extract`` ranges, per request."""


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["requests"]:
        return None
    total = sum(tr.by_name.values())
    if total <= 0:
        return None
    return 1e3 * (total - tr.in_range.get("extract", 0.0)) / w["requests"]
