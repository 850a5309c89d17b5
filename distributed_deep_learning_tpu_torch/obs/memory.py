"""Memory observability: the port of
``distributed_deep_learning_tpu/obs/memory.py``.

* :class:`MemoryTracker` polls the card's caching allocator
  (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
  ``.peak``, the card's total memory as the limit) into watermark and
  in-use gauges, with a bounded per-step peak-delta timeline and host
  RSS.  The CPU reports nothing, so the tracker disarms itself after the
  first empty sample and its per-step hook is one attribute read.
* :func:`pytree_bytes` / :func:`top_leaves` name the largest tensors of
  a state (a module's parameters and buffers, an optimizer's moments, a
  :class:`..train.state.TrainState`, or nested dicts and lists of
  tensors).
* :func:`buffer_attribution` / :func:`donation_audit` read the dict of
  :func:`..utils.profiling.memory_analysis`: JAX reads XLA's compiled
  memory breakdown, the port the allocator's statistics around one call
  (argument = bytes live at entry, output = bytes it left live, temp =
  its peak above that).  PyTorch has no buffer donation (updates run in
  place), so no alias count exists: ``alias_size_in_bytes`` is reported
  missing and the audit's verdict reads it as 0.
* :func:`record_oom_postmortem` dumps the watermark timeline, the top
  tensors and the active plan into a :class:`.recorder.FlightRecorder`
  when ``torch.cuda.OutOfMemoryError`` surfaces.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Iterable, Sequence

import torch

#: gauge names the tracker maintains (JAX's names)
GAUGE_IN_USE = "mem_hbm_bytes_in_use"
GAUGE_LIMIT = "mem_hbm_bytes_limit"
GAUGE_PEAK = "mem_hbm_peak_bytes"
GAUGE_HOST_RSS = "mem_host_rss_bytes"


def is_oom_error(err: BaseException) -> bool:
    """Does this exception say the card ran out of memory?"""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return ("RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()
            or "OOM" in msg)


def host_rss_bytes() -> int | None:
    """Resident set size of this process, from ``/proc/self/status``
    falling back to ``resource.getrusage``; None when neither works."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return None


@functools.cache
def _total_memory(device: torch.device) -> int:
    return int(torch.cuda.get_device_properties(device).total_memory)


def device_memory_stats(device: Any) -> dict[str, int]:
    """The allocator's counters under JAX's ``memory_stats()`` keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), ``{}`` on
    the CPU or when the call raises.  One ``torch.cuda.memory_stats``
    call (``memory_allocated`` and ``max_memory_allocated`` each make
    one)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    try:
        s = torch.cuda.memory_stats(device)
        return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use":
                    int(s.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": _total_memory(device)}
    except Exception:
        return {}


def _named_tensors(tree: Any, path: str = ""):
    """``(path, tensor)`` for every tensor of a state, in a fixed walk."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield f"{path}[{name!r}]", t
    elif isinstance(tree, torch.optim.Optimizer):
        names = {id(p): i for i, p in enumerate(
            p for g in tree.param_groups for p in g["params"])}
        for p, st in tree.state.items():
            for key, t in st.items():
                if isinstance(t, torch.Tensor):
                    yield f"{path}.state[{names.get(id(p))}][{key!r}]", t
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named_tensors(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _named_tensors(value, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _named_tensors(getattr(tree, f.name),
                                      f"{path}.{f.name}")


def pytree_bytes(tree: Any) -> int:
    """Exact byte footprint of every tensor in ``tree`` (shared tensors
    counted once)."""
    seen, total = set(), 0
    for _, t in _named_tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def top_leaves(tree: Any, n: int = 10) -> list[dict[str, Any]]:
    """The ``n`` largest tensors of a state by bytes, with their paths:
    bytes descending, then path."""
    rows = [{"path": path, "shape": list(t.shape),
             "dtype": str(t.dtype).replace("torch.", ""),
             "bytes": t.numel() * t.element_size()}
            for path, t in _named_tensors(tree)]
    rows.sort(key=lambda r: (-r["bytes"], r["path"]))
    return rows[:n]


class MemoryTracker:
    """Live device-memory gauges plus a bounded per-step timeline
    (JAX's tracker over the caching allocator's statistics).

    :meth:`sample` at span boundaries, :meth:`on_step` from the hot loop
    (a sample every ``every`` steps).  Reading the allocator's counters
    does not synchronise the card."""

    def __init__(self, registry, *, device: Any = None, every: int = 8,
                 capacity: int = 256) -> None:
        self.registry = registry
        self.device = device
        self.every = max(1, int(every))
        self.capacity = max(1, int(capacity))
        self.timeline: list[dict[str, Any]] = []
        self.samples = 0
        self.steps = 0
        self.peak_bytes = 0
        self._last_peak: int | None = None
        self._armed: bool | None = None   # unknown until the first sample

    @property
    def enabled(self) -> bool:
        """True until the device proves it reports nothing."""
        return self._armed is not False

    def _resolve_device(self) -> Any:
        if self.device is None:
            self.device = (torch.device("cuda", torch.cuda.current_device())
                           if torch.cuda.is_available()
                           else torch.device("cpu"))
        return self.device

    def on_step(self) -> None:
        """Hot-loop hook: sample every ``self.every`` trained steps."""
        self.steps += 1
        if self._armed is False or self.steps % self.every:
            return
        self.sample(step=self.steps)

    def sample(self, step: int | None = None) -> dict[str, Any] | None:
        """Poll the allocator once; update gauges and the timeline.
        None when the device reports nothing (host RSS is still gauged
        on the first empty sample)."""
        stats = device_memory_stats(self._resolve_device())
        if not stats:
            if self._armed is None:
                self._armed = False
                rss = host_rss_bytes()
                if rss is not None:
                    self.registry.gauge(GAUGE_HOST_RSS).set(rss)
            return None
        self._armed = True
        in_use = int(stats.get("bytes_in_use", 0))
        limit = int(stats.get("bytes_limit", 0))
        peak = int(stats.get("peak_bytes_in_use", in_use))
        self.peak_bytes = max(self.peak_bytes, peak)
        delta = peak - self._last_peak if self._last_peak is not None else 0
        self._last_peak = peak
        self.registry.gauge(GAUGE_IN_USE).set(in_use)
        self.registry.gauge(GAUGE_PEAK).set(self.peak_bytes)
        if limit:
            self.registry.gauge(GAUGE_LIMIT).set(limit)
        rss = host_rss_bytes()
        if rss is not None:
            self.registry.gauge(GAUGE_HOST_RSS).set(rss)
        sample = {"step": step if step is not None else self.steps,
                  "bytes_in_use": in_use, "peak_bytes": peak,
                  "peak_delta": delta, "host_rss_bytes": rss}
        self.timeline.append(sample)
        if len(self.timeline) > self.capacity:
            del self.timeline[:len(self.timeline) - self.capacity]
        self.samples += 1
        return sample

    def summary(self) -> dict[str, Any]:
        """The run-level memory rollup (the ``obs_memory`` event body)."""
        return {
            "samples": self.samples,
            "steps": self.steps,
            "device_reports_memory": bool(self._armed),
            "peak_bytes": self.peak_bytes or None,
            "host_rss_bytes": host_rss_bytes(),
            "timeline_tail": self.timeline[-16:],
        }


def donation_audit(memory: dict[str, int],
                   donated_bytes: int | None) -> dict[str, Any]:
    """JAX's audit of donated bytes that failed to alias an output, over
    a :func:`..utils.profiling.memory_analysis` dict (see the module
    docstring: torch reports no aliasing)."""
    aliased = int(memory.get("alias_size_in_bytes", 0))
    out: dict[str, Any] = {"aliased_bytes": aliased,
                           "donated_bytes": donated_bytes}
    if donated_bytes is None:
        out["unaliased_donated_bytes"] = None
        out["ok"] = None
        return out
    unaliased = max(0, int(donated_bytes) - aliased)
    out["unaliased_donated_bytes"] = unaliased
    out["ok"] = unaliased <= max(4096, int(donated_bytes) * 0.01)
    return out


def buffer_attribution(memory: dict[str, int], *, state: Any = None,
                       donated_bytes: int | None = None,
                       top_n: int = 10) -> dict[str, Any]:
    """The memory story of one call: the breakdown of ``memory`` (a
    :func:`..utils.profiling.memory_analysis` dict), the largest tensors
    of ``state`` by name, and the donation audit."""
    breakdown = {k: memory.get(k, 0) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes")}
    if donated_bytes is None and state is not None:
        donated_bytes = pytree_bytes(state)
    return {
        "breakdown": breakdown,
        "total_bytes": sum(v for v in breakdown.values()
                           if isinstance(v, int)),
        "missing_fields": list(memory.get("memory_fields_missing", ())),
        "top_leaves": top_leaves(state, top_n) if state is not None else [],
        "donation": donation_audit(memory, donated_bytes),
    }


def record_oom_postmortem(recorder, *, error: BaseException | str,
                          plan: dict | None = None,
                          top_buffers: Sequence[dict] | None = None,
                          watermarks: Iterable[dict] | None = None,
                          attribution: dict | None = None,
                          context: str = "train") -> bool:
    """Write the OOM story into a flight recorder and trip it; True when
    a postmortem was recorded (the error was an OOM and a recorder
    exists)."""
    if recorder is None:
        return False
    if isinstance(error, BaseException):
        if not is_oom_error(error):
            return False
        error = f"{type(error).__name__}: {error}"[:500]
    elif "RESOURCE_EXHAUSTED" not in error and "OOM" not in error \
            and "out of memory" not in error.lower():
        return False
    recorder.record(
        "oom_postmortem",
        context=context,
        error=error,
        plan=plan,
        top_buffers=list(top_buffers or ()),
        watermark_timeline=list(watermarks or ()),
        attribution=attribution,
    )
    recorder.trip("oom_postmortem")
    return True
