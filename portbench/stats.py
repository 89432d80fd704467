"""The benchmark's arithmetic over what a run recorded: rates, percentiles
and the union of time intervals.  Frozen here so that a change to
the program cannot change the yardstick."""

from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(work: float, seconds: float) -> float:
    """Work completed over the whole window, per second."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return work / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile of all values (statistics.quantiles, inclusive
    method: linear between order statistics)."""
    if len(values) < 2:
        raise ValueError("a percentile needs at least two values")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals that cover exactly the given ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of [lo, hi] that the union of the intervals covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def overlap(intervals: Iterable[Tuple[float, float]],
            within: Iterable[Tuple[float, float]]) -> float:
    """Summed length of the intervals' parts that lie inside the union of
    `within` (each interval counted on its own)."""
    cover = union(within)
    starts = [s for s, _ in cover]
    total = 0.0
    for s, e in intervals:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(cover) and cover[i][0] < e:
            total += max(0.0, min(e, cover[i][1]) - max(s, cover[i][0]))
            i += 1
    return total
