"""Per-request distributed tracing: causally-linked spans, Chrome export,
copied from the JAX package's ``obs/trace.py``.

The run-level ``obs/`` layer answers
"how did the run do on average"; this module answers "why was THIS
request slow".  Every unit of work the serving engine performs for a
request — admission, prefix match, copy-on-write, each prefill chunk,
each decode tick, retirement — becomes a :class:`Span` carrying the
request's trace id and a parent link to the span that caused it, so the
whole life of a request reads as a tree.  Train-side spans
(data-wait / dispatch / compile / checkpoint, via
:class:`..obs.timeline.Timeline`) land in the same tracer under the
``train`` trace id.

Export is the Chrome trace-event JSON format (``ph: "X"`` complete
events with microsecond ``ts``/``dur``), which both ``chrome://tracing``
and https://ui.perfetto.dev load directly — a ``--obs --obs-trace`` run
produces a file you drop into a real trace viewer.  Causality that the
viewer's (pid, tid) nesting cannot express (a request's decode span is
*caused by* its admit, but *timed inside* the engine's batched tick) is
preserved in every event's ``args``: ``trace_id`` / ``span_id`` /
``parent_id`` round-trip losslessly through :func:`read_chrome_trace`.

Hot-path contract (same bar as :mod:`..obs.metrics`): :meth:`Tracer.add`
is one list append of a tuple-backed :class:`Span` plus one integer
increment — no string formatting, no dict merging unless the caller
passes attrs.  The span ring is bounded (``capacity``); old spans fall
off rather than growing a multi-hour run without bound, and ``dropped``
reports how many did.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterable, Optional

__all__ = ["Span", "Tracer", "chrome_trace_events", "write_chrome_trace",
           "read_chrome_trace", "request_trace_id"]


def request_trace_id(uid: int) -> str:
    """The canonical trace id for serving request ``uid`` — shared by
    every layer (scheduler, block manager, engine) that reports spans
    about it."""
    return f"req-{uid}"


class Span:
    """One traced unit of work: ``[t0, t1]`` seconds on the tracer's
    clock, a ``trace_id`` naming the causal chain it belongs to, and a
    ``parent_id`` linking to the span that caused it (None = root)."""

    __slots__ = ("name", "t0", "t1", "trace_id", "span_id", "parent_id",
                 "track", "attrs")

    def __init__(self, name: str, t0: float, t1: float, trace_id: str,
                 span_id: int, parent_id: Optional[int],
                 track: str, attrs: Optional[dict]) -> None:
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.track = track
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "track": self.track}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Tracer:
    """Bounded span collector with an injectable clock.

    ``capacity`` bounds memory (a span is ~200 bytes; the default ring
    holds the last 64k spans ≈ a few minutes of busy serving).
    ``on_span`` — optional callback fired with every COMPLETED span
    (the flight-recorder wiring point); it must be cheap.
    """

    def __init__(self, clock=time.perf_counter, capacity: int = 65536,
                 on_span=None) -> None:
        self.clock = clock
        self.spans: deque[Span] = deque(maxlen=capacity)
        self.capacity = capacity
        self.emitted = 0                 # total ever completed
        self.on_span = on_span
        self._next_id = 1
        self._open: dict[int, Span] = {}

    @property
    def dropped(self) -> int:
        """Completed spans that have fallen off the ring."""
        return self.emitted - len(self.spans)

    # -- hot path ------------------------------------------------------
    def add(self, name: str, t0: float, t1: float, trace_id: str,
            parent: Optional[int] = None, track: str = "main",
            **attrs: Any) -> int:
        """Record a completed span; returns its span id (usable as a
        later span's ``parent``)."""
        sid = self._next_id
        self._next_id = sid + 1
        sp = Span(name, t0, t1, trace_id, sid, parent, track,
                  attrs or None)
        self.spans.append(sp)
        self.emitted += 1
        if self.on_span is not None:
            self.on_span(sp)
        return sid

    # -- open/close (long-lived spans, e.g. a whole request) -----------
    def begin(self, name: str, trace_id: str, parent: Optional[int] = None,
              track: str = "main", t0: Optional[float] = None,
              **attrs: Any) -> int:
        """Open a span whose end is not yet known (a request's root span
        opens at arrival and closes at retire)."""
        sid = self._next_id
        self._next_id = sid + 1
        self._open[sid] = Span(name, t0 if t0 is not None else self.clock(),
                               -1.0, trace_id, sid, parent, track,
                               attrs or None)
        return sid

    def end(self, span_id: int, t1: Optional[float] = None,
            **attrs: Any) -> Optional[Span]:
        """Close an open span (no-op on an unknown id — a retire racing
        a ring overflow must not raise)."""
        sp = self._open.pop(span_id, None)
        if sp is None:
            return None
        sp.t1 = t1 if t1 is not None else self.clock()
        if attrs:
            sp.attrs = {**(sp.attrs or {}), **attrs}
        self.spans.append(sp)
        self.emitted += 1
        if self.on_span is not None:
            self.on_span(sp)
        return sp

    @contextmanager
    def span(self, name: str, trace_id: str, parent: Optional[int] = None,
             track: str = "main", **attrs: Any):
        """Cold-path convenience; hot loops should call :meth:`add` with
        their own clock arithmetic (same contract as Timeline.span)."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(name, t0, self.clock(), trace_id, parent=parent,
                     track=track, **attrs)

    def drain_open(self) -> None:
        """Close every still-open span at the current clock (end-of-run
        flush so an aborted request still shows in the trace)."""
        now = self.clock()
        for sid in list(self._open):
            self.end(sid, t1=now, truncated=True)

    # -- export --------------------------------------------------------
    def export(self, path: str) -> int:
        """Atomically write the ring as a Chrome/Perfetto trace JSON;
        returns the number of spans written."""
        self.drain_open()
        spans = list(self.spans)
        write_chrome_trace(path, spans)
        return len(spans)


def chrome_trace_events(spans: Iterable[Span],
                        process_name: str = "ddl") -> list[dict]:
    """Spans → Chrome trace-event dicts.

    Each track becomes a tid with a ``thread_name`` metadata event;
    every event is a ``ph: "X"`` complete event with microsecond
    ``ts``/``dur`` and the causal links in ``args``.  Zero-duration
    spans get a 1 µs floor so viewers render them.
    """
    events: list[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    tids: dict[str, int] = {}
    for sp in spans:
        tid = tids.get(sp.track)
        if tid is None:
            tid = tids[sp.track] = len(tids) + 1
            events.append({"ph": "M", "pid": 0, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": sp.track}})
        args = {"trace_id": sp.trace_id, "span_id": sp.span_id,
                "parent_id": sp.parent_id}
        if sp.attrs:
            args.update(sp.attrs)
        events.append({
            "ph": "X", "pid": 0, "tid": tid, "name": sp.name,
            "ts": sp.t0 * 1e6,
            "dur": max((sp.t1 - sp.t0) * 1e6, 1.0),
            "cat": sp.trace_id,
            "args": args,
        })
    return events


def write_chrome_trace(path: str, spans: Iterable[Span],
                       process_name: str = "ddl") -> None:
    """Atomic write (the checkpoint-sidecar tmp+rename pattern — a
    killed run leaves the previous complete trace, never a torn one)."""
    doc = {"traceEvents": chrome_trace_events(spans, process_name),
           "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # atomic on POSIX


def read_chrome_trace(path: str) -> list[dict]:
    """Load a trace file back as the list of ``ph: "X"`` span events
    (metadata events filtered out) — what the causality tests and
    ``obs_report --trace`` consume."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]
