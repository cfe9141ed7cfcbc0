"""Window statistics, taken over every request and all the time of a window."""
from __future__ import annotations

import math


def completed_in(records, t_open: float, t_close: float) -> list:
    """Records whose answer came inside [t_open, t_close) and was not an error."""
    return [r for r in records if r["ok"] and t_open <= r["t_done"] < t_close]


def rate(n_done: int, seconds: float) -> float:
    """Requests completed in the window over the window's length."""
    return n_done / seconds


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (0 < q <= 100) over every value."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return float(s[max(0, math.ceil(q / 100.0 * len(s)) - 1)])
