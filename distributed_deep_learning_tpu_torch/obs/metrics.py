"""Process-local metrics: counters, gauges and log-bucketed histograms,
copied from the JAX package's ``obs/metrics.py``.

``Counter.inc`` is a float add and ``Histogram.observe`` one ``bisect``
into precomputed geometric bounds, so p50/p99 over any number of
latencies cost a fixed few hundred bytes; quantile error is bounded by the
bucket growth factor (default 1.25, at most ~12% relative), with exact
min/max kept to clamp the tails.  A :class:`MetricsRegistry` hands out
instruments by name and labels (look one up once, hold it in the loop);
``snapshot()`` is a JSON-able dict and :func:`merge_snapshots` combines
two (counters add, histograms add bucket-wise, gauges keep the later
value).  The fleet router and the KV migrator count with them.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Iterable


def _key(name: str, labels: dict) -> str:
    """Stable instrument key: ``name{k=v,...}`` with sorted labels (the
    Prometheus convention, so export is a string copy)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic event count (float so it can carry seconds too)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value (queue depth, slot occupancy, device bytes)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


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

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}

    @staticmethod
    def from_dict(d: dict) -> "Histogram":
        h = Histogram(bounds=d["bounds"])
        h.counts = list(d["counts"])
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = d["min"] if d.get("min") is not None else math.inf
        h.max = d["max"] if d.get("max") is not None else -math.inf
        return h


class MetricsRegistry:
    """Get-or-create instrument store, keyed by (name, labels)."""

    def __init__(self) -> None:
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        return self.counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self.gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, lo: float = 1e-5, hi: float = 100.0,
                  growth: float = 1.25, **labels) -> Histogram:
        key = _key(name, labels)
        h = self.histograms.get(key)
        if h is None:
            h = self.histograms[key] = Histogram(lo=lo, hi=hi, growth=growth)
        return h

    def snapshot(self) -> dict:
        """Plain JSON-able view of every instrument."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
        }


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two registry snapshots: counters add, gauges keep ``b``
    (latest wins), histograms add bucket-wise.  Histograms under one key
    must share bounds; differing bounds raise rather than mis-bin."""
    out = {"counters": dict(a.get("counters", {})),
           "gauges": dict(a.get("gauges", {})),
           "histograms": {k: dict(v)
                          for k, v in a.get("histograms", {}).items()}}
    for k, v in b.get("counters", {}).items():
        out["counters"][k] = out["counters"].get(k, 0.0) + v
    out["gauges"].update(b.get("gauges", {}))
    for k, hv in b.get("histograms", {}).items():
        if k not in out["histograms"]:
            out["histograms"][k] = dict(hv)
            continue
        ha = out["histograms"][k]
        if list(ha["bounds"]) != list(hv["bounds"]):
            raise ValueError(f"histogram {k!r}: cannot merge differing "
                             "bucket bounds")
        merged = Histogram.from_dict(ha)
        other = Histogram.from_dict(hv)
        merged.counts = [x + y for x, y in zip(merged.counts, other.counts)]
        merged.count += other.count
        merged.sum += other.sum
        merged.min = min(merged.min, other.min)
        merged.max = max(merged.max, other.max)
        out["histograms"][k] = merged.to_dict()
    return out
