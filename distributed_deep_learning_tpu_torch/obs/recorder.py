"""Crash flight recorder: a bounded black box dumped on failure, copied
from the JAX package's ``obs/recorder.py``.

When a run dies — sentinel anomaly, SLO collapse, SIGTERM from a
preempting scheduler — the post-mortem question is always "what were
the last things it did".  A :class:`FlightRecorder` keeps the trailing
``capacity`` events in a ring (admits, retires, chaos injections,
anomaly verdicts, trace spans if wired) and dumps them ATOMICALLY
(the checkpoint-sidecar tmp+``os.replace`` pattern — a dump can never
be torn, and a crash mid-dump leaves the previous complete one) when:

* something trips it explicitly (:meth:`trip` — the sentinel-anomaly
  and SLO-breach paths), or
* the process dies (:meth:`install` registers an ``atexit`` hook and
  signal handlers that dump, then re-deliver the signal).

Determinism contract: with ``clock=None`` events carry only a
monotonically increasing ``seq`` — no wall times — and dumps are
serialized with sorted keys, so a seeded drill (``utils/chaos.py``)
produces BIT-IDENTICAL dump bytes on every run.  With an injected or
real clock each event also carries ``t``.
"""

from __future__ import annotations

import atexit
import json
import os
import signal as _signal
from collections import deque
from typing import Any, Optional

__all__ = ["FlightRecorder"]

DUMP_FORMAT = 1


class FlightRecorder:
    """Bounded in-memory event ring with atomic black-box dumps.

    ``clock=None`` (the default) records logical sequence only — the
    deterministic mode chaos drills replay bit-identically; pass a
    clock (``time.perf_counter`` or an injected fake) to timestamp
    events.  ``capacity`` bounds memory; ``dropped`` counts what fell
    off the ring.
    """

    def __init__(self, capacity: int = 4096, clock=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.events: deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0          # total ever recorded
        self.dump_path: Optional[str] = None
        self.trips: list[str] = []
        self._installed: list[tuple[int, Any]] = []
        self._atexit_registered = False

    @property
    def dropped(self) -> int:
        return self.recorded - len(self.events)

    # -- recording -----------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        ev = {"seq": self.recorded, "kind": kind}
        if self.clock is not None:
            ev["t"] = self.clock()
        ev.update(fields)
        self.events.append(ev)
        self.recorded += 1

    def note_span(self, span) -> None:
        """Tracer ``on_span`` adapter: fold completed spans into the
        ring (name + ids + duration; attrs dropped — the black box
        favours breadth over per-span detail)."""
        self.record("span", name=span.name, trace_id=span.trace_id,
                    span_id=span.span_id, parent_id=span.parent_id,
                    dur_s=span.t1 - span.t0)

    # -- dumping -------------------------------------------------------
    def arm(self, path: str) -> None:
        """Set the default dump destination (required before
        :meth:`trip`, :meth:`install`, or the atexit hook can write)."""
        self.dump_path = path

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Atomically write the ring as JSON; returns the path written
        (None when no destination is known).  Sorted keys + no wall
        times (``clock=None``) ⇒ bit-identical bytes for identical
        event sequences."""
        path = path or self.dump_path
        if path is None:
            return None
        doc = {"format": DUMP_FORMAT, "reason": reason,
               "captured": len(self.events), "dropped": self.dropped,
               "trips": list(self.trips), "events": list(self.events)}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, default=str)
        os.replace(tmp, path)  # atomic on POSIX
        return path

    def trip(self, reason: str) -> Optional[str]:
        """An anomaly fired: record it, then dump if armed.  Returns
        the dump path (None when unarmed — recording still happened,
        so a later trip or exit dump carries the evidence)."""
        self.trips.append(reason)
        self.record("trip", reason=reason)
        return self.dump(reason=reason)

    @staticmethod
    def read(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    # -- process-death hooks -------------------------------------------
    def install(self, path: Optional[str] = None,
                signals=(_signal.SIGTERM,)) -> None:
        """Arm + register the process-death hooks: an ``atexit`` dump
        and, per signal, a handler that dumps then re-delivers the
        signal to the previous disposition (default or chained), so
        the process still dies the way its parent expects."""
        if path is not None:
            self.arm(path)
        if self.dump_path is None:
            raise ValueError("install() needs a dump path (arm() first "
                             "or pass path=)")
        if not self._atexit_registered:
            atexit.register(self._atexit_dump)
            self._atexit_registered = True
        for sig in signals:
            prev = _signal.signal(sig, self._make_handler(sig))
            self._installed.append((sig, prev))

    def uninstall(self) -> None:
        """Restore previous signal dispositions and drop the atexit
        hook (tests; long-lived embedding processes)."""
        for sig, prev in reversed(self._installed):
            _signal.signal(sig, prev)
        self._installed.clear()
        if self._atexit_registered:
            atexit.unregister(self._atexit_dump)
            self._atexit_registered = False

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except OSError:  # a dead disk must not mask the real exit
            pass

    def _make_handler(self, sig: int):
        def handler(signum, frame):
            try:
                self.dump(reason=f"signal:{signum}")
            except OSError:
                pass
            # re-deliver under the previous disposition so exit status
            # and parent-visible behaviour are unchanged
            prev = next((p for s, p in self._installed if s == signum),
                        _signal.SIG_DFL)
            if callable(prev):
                prev(signum, frame)
            else:
                _signal.signal(signum,
                               prev if prev is not None else _signal.SIG_DFL)
                _signal.raise_signal(signum)
        return handler
