"""Rolling-window aggregation: live signals over the trailing N seconds,
copied from the JAX package's ``obs/window.py``.

The gen-1 histograms (:mod:`..obs.metrics`) accumulate forever — perfect
for end-of-run rollups, useless for "what is the queue doing *right
now*".  A :class:`WindowedHistogram` is a ring of time-sliced
:class:`~..obs.metrics.Histogram` buckets: observations land in the
slice covering the current clock reading, reads merge the slices inside
the trailing window (EXACT merge — every slice shares the same bucket
bounds by construction), and slices that age out are lazily zeroed the
next time their ring position comes around.  Cost: ``observe`` is the
same single ``bisect`` as the base histogram plus one integer epoch
check; a read is a bounded sum over ``slices`` small count arrays.

:class:`LiveSignals` bundles the four signals the admission controller
and the fleet tier read — p50/p99 TTFT, inter-token latency, queue
depth, and slot occupancy over the trailing window — behind one object
the serve engines feed every tick.  Clock injection makes every number
deterministic under test.
"""

from __future__ import annotations

import time

from .metrics import Histogram

__all__ = ["WindowedHistogram", "LiveSignals"]


class WindowedHistogram:
    """A ring of ``slices`` time-sliced histograms covering the trailing
    ``window_s`` seconds.

    Each slice covers ``window_s / slices`` seconds of clock time and is
    keyed by its integer epoch (``now // slice_s``); a slice whose
    stored epoch is stale is reset before reuse, so neither observes nor
    reads ever pay for wall-clock gaps (an idle engine costs nothing).
    """

    def __init__(self, window_s: float = 10.0, slices: int = 10, *,
                 lo: float = 1e-5, hi: float = 100.0, growth: float = 1.25,
                 clock=time.monotonic) -> None:
        if window_s <= 0 or slices < 1:
            raise ValueError(f"bad window window_s={window_s} "
                             f"slices={slices}")
        self.window_s = float(window_s)
        self.n = int(slices)
        self.slice_s = self.window_s / self.n
        self.clock = clock
        self._lo, self._hi, self._growth = lo, hi, growth
        self._hists = [Histogram(lo=lo, hi=hi, growth=growth)
                       for _ in range(self.n)]
        self._epochs = [-1] * self.n

    def _slot(self, now: float) -> int:
        """The ring index for ``now``, with its slice reset if stale."""
        epoch = int(now // self.slice_s)
        i = epoch % self.n
        if self._epochs[i] != epoch:
            self._hists[i] = Histogram(lo=self._lo, hi=self._hi,
                                       growth=self._growth)
            self._epochs[i] = epoch
        return i

    def observe(self, v: float, now: float | None = None) -> None:
        if now is None:
            now = self.clock()
        self._hists[self._slot(now)].observe(v)

    def merged(self, now: float | None = None) -> Histogram:
        """The trailing window as ONE histogram (exact bucket-wise sum
        of the live slices; identical bounds by construction)."""
        if now is None:
            now = self.clock()
        epoch = int(now // self.slice_s)
        out = Histogram(lo=self._lo, hi=self._hi, growth=self._growth)
        for i in range(self.n):
            if not (epoch - self.n < self._epochs[i] <= epoch):
                continue  # stale (or never-written) slice: aged out
            h = self._hists[i]
            if not h.count:
                continue
            for j, c in enumerate(h.counts):
                out.counts[j] += c
            out.count += h.count
            out.sum += h.sum
            out.min = min(out.min, h.min)
            out.max = max(out.max, h.max)
        return out

    def percentile(self, p: float, now: float | None = None) -> float:
        return self.merged(now).percentile(p)

    def count(self, now: float | None = None) -> int:
        return self.merged(now).count

    def rate(self, now: float | None = None) -> float:
        """Events per second over the trailing window."""
        return self.count(now) / self.window_s


class LiveSignals:
    """The serve-side live-signal bundle: TTFT, inter-token latency,
    queue depth, and slot occupancy over the trailing window.

    The engine calls :meth:`observe_ttft` / :meth:`observe_itl` as
    latencies materialise and :meth:`sample` once per tick with the
    current queue depth and occupancy; :meth:`signals` renders the
    admission/autoscale view the fleet tier reads.  All four windows
    share one injected clock.
    """

    def __init__(self, window_s: float = 10.0, slices: int = 10, *,
                 clock=time.monotonic) -> None:
        self.window_s = float(window_s)
        self.clock = clock
        kw = dict(window_s=window_s, slices=slices, clock=clock)
        self.ttft = WindowedHistogram(**kw)
        self.itl = WindowedHistogram(**kw)
        # depth/occupancy are small integers: finer growth + a 0.5 floor
        # keeps the quantile error below one slot
        self.queue = WindowedHistogram(lo=0.5, hi=65536.0, growth=1.25,
                                       window_s=window_s, slices=slices,
                                       clock=clock)
        self.occupancy = WindowedHistogram(lo=0.5, hi=65536.0, growth=1.25,
                                           window_s=window_s, slices=slices,
                                           clock=clock)
        self._last_queue = 0.0
        self._last_occ = 0.0

    def observe_ttft(self, seconds: float, now: float | None = None) -> None:
        self.ttft.observe(seconds, now)

    def observe_itl(self, seconds: float, now: float | None = None) -> None:
        self.itl.observe(seconds, now)

    def sample(self, queue_depth: float, occupancy: float,
               now: float | None = None) -> None:
        """One per-tick sample of the instantaneous gauges."""
        self._last_queue = float(queue_depth)
        self._last_occ = float(occupancy)
        self.queue.observe(queue_depth, now)
        self.occupancy.observe(occupancy, now)

    def signals(self, now: float | None = None) -> dict:
        """The live view: percentiles over the trailing window plus the
        instantaneous last samples."""
        if now is None:
            now = self.clock()
        ttft = self.ttft.merged(now)
        itl = self.itl.merged(now)
        q = self.queue.merged(now)
        occ = self.occupancy.merged(now)
        return {
            "window_s": self.window_s,
            "ttft_p50_s": ttft.percentile(50),
            "ttft_p99_s": ttft.percentile(99),
            "ttft_count": ttft.count,
            "itl_p50_s": itl.percentile(50),
            "itl_p99_s": itl.percentile(99),
            "itl_count": itl.count,
            "queue_depth_p50": q.percentile(50),
            "queue_depth_max": q.max if q.count else 0.0,
            "queue_depth_last": self._last_queue,
            "occupancy_mean": occ.mean,
            "occupancy_last": self._last_occ,
            "request_rate_per_s": ttft.count / self.window_s,
            "token_rate_per_s": itl.count / self.window_s,
        }
