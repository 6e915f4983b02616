"""Percentiles, rates and spreads: the arithmetic every metric of the
benchmark shares, kept here so that a change to the program cannot move it.

A percentile is taken over all samples (nearest rank, so it is always one
of the samples and a tail needs no interpolation to exist); a rate is the
work of the whole window over the whole window; a spread is the distance
between the first and the third quartile as a share of the median, as
``statistics.quantiles(values, n=4)`` gives them.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it.
    None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[max(rank, 1) - 1]


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie strictly above the q-th percentile: a tail is
    worth reporting only where this is ten or more."""
    p = percentile(values, q)
    return 0 if p is None else sum(1 for v in values if v > p)


def rate(events: Iterable[Tuple[float, float]], t0: float, t1: float) -> float:
    """Sum of the amounts of the (time, amount) events with t0 <= time < t1,
    over the window's seconds."""
    if t1 <= t0:
        raise ValueError("empty window")
    return sum(a for t, a in events if t0 <= t < t1) / (t1 - t0)


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's default (exclusive) quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
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


def gaps(intervals: Iterable[Tuple[float, float]], t0: float,
         t1: float) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]
