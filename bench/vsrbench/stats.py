"""The benchmark's own statistics: percentiles, spreads and whole-batch
windows.  The program's ``Metrics.percentile`` takes the floor index, so
the benchmark computes its own."""

from __future__ import annotations

import math
import statistics
from typing import List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0..100) by linear interpolation between the
    closest ranks (Hyndman and Fan's type 7, numpy's default).  A value
    that is infinite (a request that failed) counts as the largest; a
    percentile that reaches it is infinite."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    h = (len(xs) - 1) * p / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if h > lo else xs[lo]
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def whole_batches(batches: Sequence[Tuple[float, float]], t_open: float,
                  seconds: float) -> Optional[Tuple[int, int]]:
    """The batches ``[first, last]`` (indices into ``batches``, each a
    ``(start, end)`` pair in time order) of the window that opens at the
    start of the first batch that starts at or after ``t_open`` and closes
    at the end of the last batch that ends within ``seconds`` of that
    opening.  None when no batch fits."""
    first = next((i for i, (s, _) in enumerate(batches) if s >= t_open),
                 None)
    if first is None:
        return None
    close = batches[first][0] + seconds
    last = None
    for i in range(first, len(batches)):
        if batches[i][1] <= close:
            last = i
    return None if last is None else (first, last)


def mean(values) -> Optional[float]:
    """The mean of an iterable (None when it is empty)."""
    values = list(values)
    return sum(values) / len(values) if values else None


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[t0, t1]`` that no interval covers."""
    out, t = [], t0
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, t1)))
        t = max(t, e)
        if t >= t1:
            break
    if t < t1:
        out.append((t, t1))
    return [(s, e) for s, e in out if e > s]
