"""Run telemetry: the port of ``distributed_deep_learning_tpu/obs``.

One :class:`RunTelemetry` a run threads through the train loop, elastic
recovery, the workload runner and the serving engines.  Layout:

* :mod:`.metrics`  — counters, gauges, log-bucketed histograms.
* :mod:`.window`   — rolling-window live signals (the engines').
* :mod:`.timeline` — per-step spans rolled up into a goodput breakdown.
* :mod:`.trace`    — causally linked spans, Chrome trace export.
* :mod:`.recorder` — the flight recorder (black box).
* :mod:`.mfu`      — model-FLOP accounting and the card's peak table.
* :mod:`.memory`   — the allocator's watermarks, OOM postmortems.
* :mod:`.export`   — JSONL event stream, Prometheus exposition.
* :mod:`.bench`    — the instrumentation-overhead harness.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .export import EventWriter
from .memory import MemoryTracker
from .metrics import MetricsRegistry
from .mfu import chip_peak_flops, device_kind, measure_step_flops, mfu_record
from .recorder import FlightRecorder
from .timeline import Timeline
from .trace import Tracer

__all__ = ["RunTelemetry", "MetricsRegistry", "Timeline", "EventWriter",
           "Tracer", "FlightRecorder", "MemoryTracker", "chip_peak_flops"]


class RunTelemetry:
    """The per-run telemetry hub every layer reports into (JAX's).

    ``path=None`` keeps the accounting in memory without a sidecar.
    ``trace_path`` turns on the span :class:`.trace.Tracer` (exported as a
    Chrome trace on :meth:`close`); ``recorder`` attaches a
    :class:`.recorder.FlightRecorder` that the train loop and the
    engines feed; ``rotate_mb`` size-caps the JSONL sidecar.  ``device``
    names the card the MFU record is keyed by (default: the current
    CUDA device, or the CPU).

    What the train loop's spans hold on the card: CUDA runs
    asynchronously, so ``dispatch`` is the host's time to enqueue a
    step's kernels (as on XLA), ``compile`` is a step function's first
    call (the kernels' builds, a graph's capture, the allocator's first
    blocks) and ``device_sync`` the phase's one wait for the card, where
    the device time that the host did not overlap shows.  Two kinds of
    host sync inside a step fold device time into its ``dispatch``: the
    sentinel's one ``.tolist()`` a step (``train/sentinel.py``,
    ``guarded_update``), and every gloo exchange of a CUDA tensor, which
    is staged through pinned host memory
    (``parallel.collectives.host_staged``: ``-m data`` over gloo, the
    pipeline grid's boundaries, ``--comm``'s collectives, ring
    attention's hops).  Nothing else in a step reads the card: the
    optimizers (LAMB's and Adafactor's Python loops too), the clip, the
    loader's pinned copies and the step clock's CUDA events do not.
    """

    def __init__(self, path: str | None = None,
                 clock=time.perf_counter, *,
                 trace_path: str | None = None,
                 tracer: "Tracer | None" = None,
                 recorder: "FlightRecorder | None" = None,
                 rotate_mb: float | None = None,
                 fsync_on_rollover: bool = False,
                 device: Any = None) -> None:
        self.registry = MetricsRegistry()
        self.tracer = tracer if tracer is not None else (
            Tracer(clock=clock) if trace_path else None)
        self.trace_path = trace_path
        self.recorder = recorder
        self.timeline = Timeline(clock=clock, tracer=self.tracer)
        self.writer = EventWriter(
            path, clock=clock,
            max_bytes=int(rotate_mb * 1e6) if rotate_mb else None,
            fsync_on_rollover=fsync_on_rollover)
        self.clock = clock
        self.device = device
        self.memory = MemoryTracker(self.registry, device=device)
        # model-FLOP state (filled by measure_flops / note_train)
        self.step_flops: float | None = None
        self.n_devices: int | None = None
        self.train_steps = 0.0
        self.train_seconds = 0.0
        self.train_examples = 0.0
        self._dispatched_fns: set[int] = set()
        self._count_flops = False
        self._closed = False

    # -- compile attribution ------------------------------------------
    def dispatch_kind(self, fn: Any) -> str:
        """A step function's first call is ``"compile"``, every later one
        ``"dispatch"``."""
        key = id(fn)
        if key in self._dispatched_fns:
            return "dispatch"
        self._dispatched_fns.add(key)
        return "compile"

    # -- model-FLOP accounting ----------------------------------------
    def count_train_flops(self, n_devices: int = 1) -> None:
        """Count the FLOPs of the run's first train step (the train loop
        runs it under the counter) over ``n_devices`` ranks."""
        self.n_devices = n_devices
        self._count_flops = True

    def counts_flops(self, kind: str) -> bool:
        """Whether a train step's call of ``kind`` (``compile`` /
        ``dispatch``) runs under the FLOP counter: the first one, once
        :meth:`count_train_flops` asked for it."""
        return self._count_flops and kind == "compile" and \
            self.step_flops is None

    def measure_flops(self, step_fn: Callable, *args, **kwargs) -> Any:
        """Call the train step ``step_fn(*args)`` under the FLOP counter,
        record its global FLOPs (over :meth:`count_train_flops`' ranks)
        and return its result."""
        self.step_flops, out = measure_step_flops(
            step_fn, *args, n_devices=self.n_devices, **kwargs)
        return out

    def note_train(self, steps: float, seconds: float,
                   examples: float = 0.0) -> None:
        """Accumulate productive-phase totals for the run MFU number."""
        self.train_steps += steps
        self.train_seconds += seconds
        self.train_examples += examples

    def mfu(self) -> dict:
        return mfu_record(self.step_flops, self.train_steps,
                          self.train_seconds, self.n_devices or 1,
                          device_kind(self.device))

    # -- rollups -------------------------------------------------------
    def phase_rollup(self, scope: str, since: dict | None = None) -> dict:
        """Emit (and return) a goodput breakdown for a phase delta."""
        gp = self.timeline.goodput(since=since)
        self.writer.emit("obs_goodput", scope=scope, **gp)
        return gp

    def close(self) -> dict:
        """Run-level rollup: whole-timeline goodput, MFU, the metrics
        snapshot (and memory, the trace), then close the sidecar.
        Idempotent; returns the summary dict."""
        if self._closed:
            return {}
        self._closed = True
        gp = self.timeline.goodput()
        rec = self.mfu()
        snap = self.registry.snapshot()
        self.writer.emit("obs_goodput", scope="run", **gp)
        self.writer.emit("obs_mfu", **rec)
        self.writer.emit("obs_snapshot", snapshot=snap)
        summary = {"goodput": gp, "mfu": rec, "snapshot": snap}
        if self.memory.samples or self.memory.steps:
            mem = self.memory.summary()
            self.writer.emit("obs_memory", **mem)
            summary["memory"] = mem
        if self.tracer is not None and self.trace_path:
            n = self.tracer.export(self.trace_path)
            self.writer.emit("obs_trace", path=self.trace_path, spans=n,
                             dropped=self.tracer.dropped)
            summary["trace"] = {"path": self.trace_path, "spans": n}
        self.writer.close()
        return summary
