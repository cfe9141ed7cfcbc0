"""serve_batch_mean: the service's mean batch over the window, from its own
counters (``ServiceStats.batches`` and ``total_batch_size``)."""


def read(ctx):
    s = ctx.get("service")
    if not s or not s["batches"]:
        return None
    return s["requests"] / s["batches"]
