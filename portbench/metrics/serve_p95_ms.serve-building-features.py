"""serve_p95_ms.serve-building-features: the 95th percentile (nearest rank) of the latency of
every request answered in the traced window, timed at the client (under
the profiler's overhead).  A per-layer reading: across untraced runs its
spread is too wide for a bound."""
from portbench import window


def read(ctx):
    lat = ctx["window"]["traced_latency_ms"]
    return window.percentile(lat, 95.0) if lat else None
