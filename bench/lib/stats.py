"""The benchmark's own statistics: percentiles over every sample of a window
and rates over its whole length."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 ≤ q ≤ 100) of every value, interpolated
    linearly between the two nearest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, t_open: float, t_close: float) -> float:
    """``count`` over the whole window [t_open, t_close]."""
    if t_close <= t_open:
        raise ValueError("empty window")
    return count / (t_close - t_open)
