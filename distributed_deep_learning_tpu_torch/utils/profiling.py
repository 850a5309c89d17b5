"""Profiling: the port of ``distributed_deep_learning_tpu/utils/profiling.py``.

* :func:`trace` — a ``torch.profiler`` window under ``log_dir``, written
  as a Chrome trace (``trace.<pid>.json``, loadable in Perfetto or
  ``chrome://tracing``).  On a card it records the card's activity only:
  the host's op records cost ~10 s a window to process on an NVIDIA
  H100 80GB HBM3 (700 W) and the windows are read for device time.  On
  the CPU it records the host's ops.
* :func:`annotate` — a named region (``record_function``) that shows on
  the trace.
* :func:`cost_analysis` — one call's FLOPs from the FLOP counter
  (:func:`..obs.mfu.count_flops`), under XLA's ``flops`` key.
* :func:`memory_analysis` — one call's memory from the caching
  allocator's statistics, under XLA's field names (see
  :mod:`..obs.memory`).
* :class:`StepTimer` and :func:`measure_async_overlap` — rates and the
  enqueue-versus-completion split, each with an honest
  ``torch.cuda.synchronize``.

:func:`hlo_text` and :func:`compiled_text` print XLA's compiler text,
which eager PyTorch does not have; they raise (``ROADMAP.md`` §3, "By
design").
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator

import torch


def _sync(device=None) -> None:
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


def trace_file(log_dir: str) -> str:
    """Where :func:`trace` writes this process's Chrome trace."""
    return os.path.join(log_dir, f"trace.{os.getpid()}.json")


@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[Any]:
    """Profile the body into ``log_dir`` (a no-op when None); yields the
    profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    _sync()
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(trace_file(log_dir))


def annotate(name: str):
    """Named region context manager; shows on the trace timeline."""
    return torch.profiler.record_function(name)


def _by_design(name: str):
    return NotImplementedError(
        f"{name} prints XLA's compiler text, which eager PyTorch does not "
        f"have (ROADMAP.md §3, By design)")


def hlo_text(fn: Callable, *args, **kwargs) -> str:
    raise _by_design("hlo_text")


def compiled_text(fn: Callable, *args, **kwargs) -> str:
    raise _by_design("compiled_text")


def cost_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """One call's cost: ``{"flops": ...}`` from the FLOP counter (the
    flash kernels by their registered formulas)."""
    from distributed_deep_learning_tpu_torch.obs.mfu import count_flops

    flops, _ = count_flops(fn, *args, **kwargs)
    return {"flops": flops}


def memory_analysis(fn: Callable, *args, device=None,
                    **kwargs) -> dict[str, int]:
    """One call of ``fn`` measured by the caching allocator: bytes live
    at entry (``argument_size_in_bytes``), bytes it left live
    (``output_size_in_bytes``) and its peak above what it left
    (``temp_size_in_bytes``).  ``alias_size_in_bytes`` is 0 and listed
    under ``memory_fields_missing``.  ``{}`` on the CPU."""
    if device is None:
        device = torch.cuda.current_device() if torch.cuda.is_available() \
            else "cpu"
    if torch.device(device).type != "cuda":
        return {}
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    fn(*args, **kwargs)
    _sync(device)
    after = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {"argument_size_in_bytes": int(before),
            "output_size_in_bytes": int(max(0, after - before)),
            "temp_size_in_bytes": int(max(0, peak - max(after, before))),
            "alias_size_in_bytes": 0,
            "memory_fields_missing": ["alias_size_in_bytes"]}


class StepTimer:
    """Steps/sec and examples/sec with warm-up exclusion (JAX's).
    ``summary(sync=True)`` waits for the card before it reads the
    clock."""

    def __init__(self, warmup: int = 1, clock=time.perf_counter):
        self.warmup = warmup
        self.clock = clock
        self.reset()

    def reset(self) -> None:
        self._ticks = 0
        self._examples = 0
        self._t0: float | None = None
        self._last: float | None = None

    def tick(self, examples: int = 0) -> None:
        now = self.clock()
        self._ticks += 1
        if self._ticks == self.warmup:
            self._t0 = now
            self._examples = 0
        elif self._ticks > self.warmup:
            self._examples += examples
        self._last = now

    @property
    def measured_steps(self) -> int:
        return max(0, self._ticks - self.warmup)

    def summary(self, sync: Any = None) -> dict[str, float]:
        """Rates over the post-warm-up window.  A truthy ``sync`` (a
        tensor, or True) waits for the card first."""
        if sync is not None and sync is not False:
            _sync(sync.device if isinstance(sync, torch.Tensor) else None)
            if self._t0 is not None:
                self._last = max(self.clock(), self._t0)
        if self._t0 is None or self._last is None or self.measured_steps == 0:
            return {"steps_per_sec": 0.0, "examples_per_sec": 0.0,
                    "seconds": 0.0}
        dt = max(self._last - self._t0, 1e-9)
        return {
            "steps_per_sec": self.measured_steps / dt,
            "examples_per_sec": self._examples / dt,
            "seconds": dt,
        }


def measure_async_overlap(fn: Callable, *args, warmup: bool = True,
                          **kwargs) -> dict[str, float]:
    """How far ahead of the card the host runs ``fn``: ``dispatch_s``
    (until the call returns, its kernels enqueued), ``total_s`` (until
    the card finished them) and ``overlap_fraction = 1 - dispatch_s /
    total_s``."""
    if warmup:
        fn(*args, **kwargs)
        _sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    t1 = time.perf_counter()
    _sync()
    t2 = time.perf_counter()
    dispatch, total = t1 - t0, max(t2 - t0, 1e-9)
    return {"dispatch_s": dispatch, "total_s": total,
            "overlap_fraction": 1.0 - dispatch / total}


def busy_ms(prof) -> float | None:
    """Milliseconds of the card's kernels a finished profiler window
    recorded (annotated ranges excluded: they cover kernels counted on
    their own), None when it recorded no device time."""
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 if us else None
