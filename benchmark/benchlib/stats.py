"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile of all values, interpolated linearly between order
    statistics (numpy's default): q = 0.95 over every call of the window."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, window_s: float) -> float:
    """The work of every call completed in the window over the window's length."""
    if window_s <= 0:
        raise ValueError("empty window")
    return work / window_s
