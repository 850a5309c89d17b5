"""Per-step span recording rolled up into a goodput breakdown, copied
from the JAX package's ``obs/timeline.py``.

A training run's wall-clock decomposes into a handful of span kinds the
trainer can actually attribute:

=============  ====================================================
kind           where it comes from
=============  ====================================================
``data_wait``  host blocked in ``next(loader)`` (input stall)
``h2d``        explicit host→device transfer outside the loader
``dispatch``   host time enqueueing the step's kernels (CUDA runs
               asynchronously: device time is not in it)
``compile``    first call of a given step fn (kernel builds, graph
               capture, allocator warm-up)
``device_sync``host blocked fetching device results (the one
               sync-per-phase barrier — device compute hides here)
``checkpoint`` save + integrity manifest time
``recovery``   elastic restart: restore_verified / failure handling
``reshard``    cross-topology redistribution during restore
=============  ====================================================

:meth:`Timeline.goodput` maps those onto the categories large-scale
fleet reports use: **productive** (dispatch + device_sync — the time the
device is doing model math, given the loop's async-dispatch design),
**input_stall** (data_wait + h2d), **checkpoint**, **recovery**
(recovery + reshard), **compile**, and **other** (unattributed wall).
Fractions are of elapsed wall-clock and sum to ≤ 1.0 by construction.

Hot-path contract: ``add(kind, dt)`` is two dict writes on interned
keys.  The ``span`` contextmanager is for cold paths (checkpoint,
recovery); hot loops should do their own ``perf_counter`` arithmetic and
call ``add``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

# span kind -> goodput category; anything unlisted lands in "other"
CATEGORY = {
    "dispatch": "productive",
    "device_sync": "productive",
    "data_wait": "input_stall",
    "h2d": "input_stall",
    "checkpoint": "checkpoint",
    "recovery": "recovery",
    "reshard": "recovery",
    "compile": "compile",
}

CATEGORIES = ("productive", "input_stall", "checkpoint", "recovery",
              "compile", "other")


class Timeline:
    """Accumulates (seconds, count) per span kind against a wall-clock
    origin.  ``clock`` is injectable for deterministic tests.

    ``tracer`` (:class:`..obs.trace.Tracer`, optional) additionally
    records every ``add`` as a causal span on the ``train`` track —
    the step/compile/checkpoint spans of the exported trace.  The end
    time is read from the shared clock at add time (``add`` receives a
    duration, not endpoints), costing one extra clock read per span —
    only when tracing is on; the tracer-less path is unchanged."""

    def __init__(self, clock=time.perf_counter, tracer=None,
                 trace_id: str = "train") -> None:
        self.clock = clock
        self.tracer = tracer
        self.trace_id = trace_id
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.steps = 0
        self._origin = clock()

    def add(self, kind: str, dt: float, n: int = 1) -> None:
        self.seconds[kind] = self.seconds.get(kind, 0.0) + dt
        self.counts[kind] = self.counts.get(kind, 0) + n
        if self.tracer is not None:
            t1 = self.clock()
            self.tracer.add(kind, t1 - dt, t1, self.trace_id,
                            track="train")

    @contextmanager
    def span(self, kind: str):
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(kind, self.clock() - t0)

    def step(self, n: int = 1) -> None:
        self.steps += n

    def elapsed(self) -> float:
        return self.clock() - self._origin

    def snapshot(self) -> dict:
        """Cheap copy for delta-based rollups (phase goodput = snapshot
        at phase end minus snapshot at phase start)."""
        return {"seconds": dict(self.seconds), "counts": dict(self.counts),
                "steps": self.steps, "elapsed": self.elapsed()}

    def goodput(self, since: dict | None = None) -> dict:
        """Roll spans up into the goodput breakdown.

        With ``since`` (an earlier :meth:`snapshot`), the breakdown
        covers only the delta — used for per-phase rollups while the
        run-level report spans the whole timeline.
        """
        now = self.snapshot()
        base_sec = since["seconds"] if since else {}
        wall = now["elapsed"] - (since["elapsed"] if since else 0.0)
        steps = now["steps"] - (since["steps"] if since else 0)

        cat_seconds = {c: 0.0 for c in CATEGORIES}
        for kind, sec in now["seconds"].items():
            d = sec - base_sec.get(kind, 0.0)
            cat_seconds[CATEGORY.get(kind, "other")] += d
        attributed = sum(cat_seconds.values())
        # Unattributed wall (python glue between spans) is "other".
        cat_seconds["other"] += max(0.0, wall - attributed)

        # Spans can very slightly over-cover wall on coarse clocks;
        # normalize against the larger of the two so fractions sum ≤ 1.
        denom = max(wall, sum(cat_seconds.values()), 1e-12)
        fractions = {c: s / denom for c, s in cat_seconds.items()}
        return {
            "wall_seconds": wall,
            "steps": steps,
            "seconds": cat_seconds,
            "fractions": fractions,
            "goodput_fraction": fractions["productive"],
        }
