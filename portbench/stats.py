"""The arithmetic of a run's numbers: percentiles, rates over a window,
relative gaps, and the spread the bounds are set from."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) of all ``values``, interpolated
    linearly between order statistics; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> Optional[float]:
    """Work per second over a window; None for an empty one."""
    if not count or seconds <= 0:
        return None
    return count / seconds


def mean(values: Sequence[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def rel_l2(got, want) -> float:
    """``|got - want| / |want|`` over every element, in float64."""
    import torch

    g = got.detach().to(torch.float64)
    w = want.detach().to(g.device, torch.float64)
    return float(torch.linalg.vector_norm(g - w) / torch.clamp_min(torch.linalg.vector_norm(w),
                                                                   1e-300))


def union_length(intervals: Iterable) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Iterable) -> List[list]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
