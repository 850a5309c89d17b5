"""Log-bucketed latency histograms, copied from the JAX package's
``obs/metrics.py`` (the part the serving engine's latency percentiles
use).

``Histogram.observe`` is one ``bisect`` into precomputed geometric
bounds, so p50/p99 over any number of latencies cost a fixed few hundred
bytes; quantile error is bounded by the bucket growth factor (default
1.25, at most ~12% relative), with exact min/max kept to clamp the tails.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Iterable


def log_bounds(lo: float, hi: float, growth: float) -> tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` up to (and including the
    first bound ≥) ``hi``.  Shared by every histogram so merge only ever
    sees identical bounds for identical parameters."""
    if not (lo > 0 and hi > lo and growth > 1):
        raise ValueError(f"bad histogram bounds lo={lo} hi={hi} "
                         f"growth={growth}")
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * growth)
    return tuple(bounds)


class Histogram:
    """Log-bucketed histogram with percentile estimation.

    Bucket *i* counts observations ``v <= bounds[i]`` (and
    ``> bounds[i-1]``); one overflow bucket catches ``v > bounds[-1]``.
    Defaults cover 10 µs .. 100 s — the span from a decode tick to a
    checkpoint restore — at ≤ ~12% quantile error.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, lo: float = 1e-5, hi: float = 100.0,
                 growth: float = 1.25,
                 bounds: Iterable[float] | None = None) -> None:
        self.bounds = tuple(bounds) if bounds is not None \
            else log_bounds(lo, hi, growth)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Quantile estimate: walk the cumulative counts to the target
        rank, interpolate linearly inside the landing bucket, clamp to
        the exact observed [min, max]."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                # bucket i spans (lower, upper]
                lower = self.bounds[i - 1] if i > 0 else 0.0
                upper = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - cum) / c
                est = lower + frac * (upper - lower)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max
