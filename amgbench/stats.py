"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(done: int, seconds: float) -> float:
    """Work done over the whole window's seconds."""
    return done / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, interpolated linearly
    between the two nearest ranks (NumPy's default); ``math.inf`` stands
    for a request that failed, so a tail that reaches a failure is
    infinite."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return math.inf if pos > lo or math.isinf(xs[lo]) else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
