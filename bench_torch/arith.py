"""The benchmark's arithmetic: the nearest-rank percentile over every
sample, the union of device intervals, the byte bound of the card, and the
quartile spread of a set of runs.  ``busy`` is a copy of ``chip_smoke.py``'s
``busy_ms``; ``percentile`` is its ``percentile`` taken by nearest rank."""

from __future__ import annotations

import bisect
import itertools
import math
import statistics

# published HBM3 bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def percentile(xs: list, q: float) -> float:
    """Nearest rank: the smallest sample with at least ``q`` % of all
    samples at or below it."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def busy(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def covering(spans):
    """A test of whether a time lies in any of the (start, end) intervals,
    start included, in O(log n) a call."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    reach = list(itertools.accumulate((b for _, b in spans), max))

    def covers(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and reach[i] > t

    return covers


def byte_bound_s(nbytes: float) -> float:
    """The least time the card needs to move ``nbytes`` once."""
    return nbytes / HBM_BYTES_PER_S


def spread(values: list) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
