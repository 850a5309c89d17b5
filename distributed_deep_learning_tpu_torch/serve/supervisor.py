"""Engine supervisor: tick watchdog, crash containment, zero-loss replay
(the port of the JAX package's ``serve/supervisor.py``).

The serving analogue of the train-side sentinel/recovery stack:
one NaN logit, stalled tick, or crashed engine must cost a warm restart,
never a request.  Three mechanisms compose:

* **Watchdog** — the engine calls ``on_tick(report)`` after every tick's
  compute but BEFORE recording its tokens (:class:`..serve.engine.
  TickReport`).  The supervisor checks device-computed finiteness flags
  and wall-clock stall budgets there; a raising check discards the tick,
  so nothing an anomaly produced ever enters a committed stream.
* **Ledger** — :class:`RequestLedger` mirrors the scheduler's retirement
  rules (EOS or token budget) over the SAME reports, so the supervisor
  always knows every request's prompt + committed tokens.  That is the
  whole replay state: no engine internals survive a fault.
* **Containment + replay** — any exception out of ``engine.run()`` is
  caught, the engine warm-restarts (``engine.reset()``: the cache
  pools and prefix index zeroed in place — poisoned KV dies — under the
  SAME captured ticks, so ``decode_captures`` never moves), and every
  non-retired request is re-dispatched as ``prompt + committed`` with
  its remaining budget.  Zero requests are lost and every committed
  token stands.  The replay recomputes the committed positions through
  the chunk prefill, whose arithmetic differs in the last bits from the
  decode tick's, so a replayed continuation may part from the fault-free
  one, and only at a near-tie of its top two logits (the determinism
  rule of ROADMAP.md item 13).

Per-request deadlines and bounded retries put a ceiling on how long a
fault loop can hold a request hostage; ``max_restarts`` bounds the
supervisor itself (a crash-looping engine eventually re-raises).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np

from distributed_deep_learning_tpu_torch.serve.engine import TickReport
from distributed_deep_learning_tpu_torch.serve.scheduler import Request


class EngineCrash(RuntimeError):
    """The engine process died mid-tick (raised by the chaos injector to
    rehearse exactly that; a real deployment maps SIGCHLD and CUDA
    errors to the same containment path)."""


class TickAnomaly(RuntimeError):
    """Watchdog verdict: a tick produced non-finite output (NaN/inf in
    some request's attention window — poisoned KV, corrupted weights)."""


class TickStall(RuntimeError):
    """Watchdog verdict: the gap between consecutive tick reports blew
    the stall budget (hung collective, livelocked host loop)."""


class _Entry:
    """Ledger row: one request's full supervised lifetime."""

    __slots__ = ("request", "committed", "retired", "error", "attempts",
                 "dispatch_wall", "retire_wall")

    def __init__(self, request: Request):
        self.request = request
        self.committed: list[int] = []
        self.retired = False
        self.error: Optional[str] = None
        self.attempts = 0
        self.dispatch_wall: Optional[float] = None
        self.retire_wall: Optional[float] = None


class RequestLedger:
    """Source of truth for replay: prompt + committed tokens per uid.

    ``commit`` mirrors ``SlotScheduler.record`` exactly — append, then
    retire on EOS or budget — so the ledger's streams are always what
    the engine's ``results`` would be.  Tokens reported for an
    already-retired uid are dropped, matching the engine's own
    truncation of a speculative round that crossed EOS."""

    def __init__(self, eos_id: Optional[int]):
        self.eos_id = eos_id
        self.entries: dict[int, _Entry] = {}

    def add(self, request: Request) -> None:
        self.entries[request.uid] = _Entry(request)

    def commit(self, uid: int, token: int) -> bool:
        """Record one token; True when the request just retired."""
        e = self.entries[uid]
        if e.retired or e.error is not None:
            return False
        e.committed.append(int(token))
        if (len(e.committed) >= e.request.max_new_tokens
                or (self.eos_id is not None
                    and int(token) == self.eos_id)):
            e.retired = True
            return True
        return False

    def snapshot(self) -> dict[int, int]:
        """Committed-token counts per uid — the rollback anchor a canary
        takes before any candidate-weight token can land."""
        return {uid: len(e.committed) for uid, e in self.entries.items()}

    def truncate(self, snapshot: dict[int, int]) -> int:
        """Rewind every stream to a snapshot (canary rollback): tokens
        past the anchor are discarded and retirement is re-derived, so
        the subsequent replay regenerates them under the STABLE weights."""
        dropped = 0
        for uid, n in snapshot.items():
            e = self.entries.get(uid)
            if e is None or len(e.committed) <= n:
                continue
            dropped += len(e.committed) - n
            e.committed = e.committed[:n]
            e.retired = bool(e.committed) and (
                len(e.committed) >= e.request.max_new_tokens
                or (self.eos_id is not None
                    and e.committed[-1] == self.eos_id))
            if not e.retired:
                e.retire_wall = None
        return dropped

    def results(self) -> dict[int, np.ndarray]:
        return {uid: np.asarray(e.committed, dtype=e.request.prompt.dtype)
                for uid, e in self.entries.items() if e.retired}

    def open_entries(self) -> list[_Entry]:
        return [e for e in self.entries.values()
                if not e.retired and e.error is None]


class ServeSupervisor:
    """Run an engine under watchdog + containment + replay.

    Works with both engines (:class:`..serve.engine.ServeEngine` and
    :class:`..serve.engine.PagedEngine` share the ``run()`` contract,
    ``reset()``, and the ``on_tick`` seam).  ``chaos`` is a
    :class:`..utils.chaos.ChaosPlan` whose ``serve_hook`` fires inside
    the watchdog; ``reload`` is a :class:`..serve.reload.ReloadManager`
    polled between ticks; ``admission`` is passed through to the
    engine's admit loop.
    """

    def __init__(self, engine, *, deadline_ms: Optional[float] = None,
                 retries: int = 2, max_restarts: int = 8,
                 stall_timeout_s: Optional[float] = None,
                 chaos=None, reload=None, admission=None, recorder=None,
                 clock=time.monotonic, fleet_hook=None,
                 fatal: tuple = ()):
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got "
                             f"{deadline_ms}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s must be positive, got "
                             f"{stall_timeout_s}")
        self.engine = engine
        self.deadline_ms = deadline_ms
        self.retries = retries
        self.max_restarts = max_restarts
        self.stall_timeout_s = stall_timeout_s
        if recorder is not None:
            raise NotImplementedError(
                "the flight recorder is not ported to the PyTorch engine "
                "yet (ROADMAP.md queue 1 item 14)")
        self.chaos = chaos
        self.reload = reload
        self.admission = admission
        self._clock = clock
        #: fleet seam: called once per tick with the TickReport, AFTER
        #: the chaos hook (so fleet-level injections see the same tick a
        #: router's health tracker observes).  Exceptions propagate like
        #: engine faults.
        self.fleet_hook = fleet_hook
        #: exception types this supervisor must NOT contain: the fault
        #: is recorded, then re-raised for a higher tier (the fleet
        #: router) to handle — no restart, no reset.
        self.fatal = tuple(fatal)
        self.ledger = RequestLedger(engine.eos_id)
        self.faults: list[dict] = []
        self.restarts = 0
        self.ticks_seen = 0
        self.deadline_misses = 0
        self._last_beat: Optional[float] = None
        self._last_report: Optional[TickReport] = None
        self._dispatched: set[int] = set()

    # --- watchdog ---------------------------------------------------------
    def _on_tick(self, report: TickReport) -> None:
        self.ticks_seen += 1
        self._last_report = report
        if self.chaos is not None:
            self.chaos.serve_hook(report.engine, report)
        if self.fleet_hook is not None:
            self.fleet_hook(report)
        now = self._clock()
        if (self.stall_timeout_s is not None
                and self._last_beat is not None
                and now - self._last_beat > self.stall_timeout_s):
            dt = now - self._last_beat
            raise TickStall(
                f"tick {report.tick} report arrived {dt:.3f}s after the "
                f"previous one (stall budget {self.stall_timeout_s}s)")
        self._last_beat = now
        bad = sorted(uid for uid, ok in report.finite.items() if not ok)
        if bad:
            raise TickAnomaly(
                f"non-finite {report.kind} output for request(s) {bad} "
                f"at tick {report.tick} (poisoned KV or weights)")
        for uid, tok in report.emitted:
            if self.ledger.commit(uid, tok):
                e = self.ledger.entries[uid]
                e.retire_wall = now
                if (self.deadline_ms is not None
                        and e.dispatch_wall is not None
                        and (now - e.dispatch_wall) * 1e3
                        > self.deadline_ms):
                    self.deadline_misses += 1
        # between-tick actions last: the tick has fully landed, so a
        # promote swaps weights AFTER it and a rollback's truncation
        # anchor is consistent with what replay will regenerate
        if self.reload is not None:
            self.reload.on_tick(report, self.ledger)

    # --- replay -----------------------------------------------------------
    def _replay_requests(self, now: float) -> list[Request]:
        out = []
        for e in self.ledger.open_entries():
            r = e.request
            if (self.deadline_ms is not None
                    and e.dispatch_wall is not None
                    and (now - e.dispatch_wall) * 1e3 > self.deadline_ms):
                e.error = (f"deadline: {self.deadline_ms:g}ms exceeded "
                           f"with {len(e.committed)} of "
                           f"{r.max_new_tokens} tokens committed")
                continue
            if e.attempts > self.retries:
                e.error = (f"retries: request survived {e.attempts - 1} "
                           f"engine fault(s), exceeding the retry "
                           f"budget {self.retries}")
                continue
            if e.committed:
                prompt = np.concatenate(
                    [np.asarray(r.prompt),
                     np.asarray(e.committed, dtype=r.prompt.dtype)])
                arrival = 0
            else:
                prompt = r.prompt
                arrival = r.arrival_tick
            out.append(Request(
                uid=r.uid, prompt=prompt,
                max_new_tokens=r.max_new_tokens - len(e.committed),
                arrival_tick=arrival, slo_ttft_ms=r.slo_ttft_ms,
                slo_e2e_ms=r.slo_e2e_ms, priority=r.priority))
        return out

    # --- main loop --------------------------------------------------------
    def run(self, requests: Iterable[Request], telemetry=None) -> dict:
        """Serve a trace under supervision.

        Returns ``{"results", "errors", "stats"}`` — the engines' own
        contract, so callers swap a bare engine for a supervised one
        without changes.  ``results`` comes from the LEDGER (the replay
        source of truth); ``stats`` adds the supervision record
        (restarts, faults, deadline misses, ``requests_lost``) on top
        of the final attempt's engine stats.
        """
        for req in requests:
            self.ledger.add(req)
        engine_stats = None
        engine_errors: dict[int, str] = {}
        t_start = self._clock()

        while True:
            now = self._clock()
            todo = self._replay_requests(now)
            if not todo:
                break
            for r in todo:
                e = self.ledger.entries[r.uid]
                if e.dispatch_wall is None:
                    e.dispatch_wall = now
                e.attempts += 1
            self._dispatched = {r.uid for r in todo}
            self._last_beat = None
            try:
                out = self.engine.run(todo, telemetry=telemetry,
                                      on_tick=self._on_tick,
                                      admission=self.admission)
            except Exception as exc:  # noqa: BLE001 — containment seam
                t_fault = self._clock()
                tick = (self._last_report.tick
                        if self._last_report is not None else None)
                snap = getattr(exc, "ledger_snapshot", None)
                if snap is not None:
                    self.ledger.truncate(snap)
                if isinstance(exc, self.fatal):
                    # fleet-tier fault: the whole REPLICA is gone, not
                    # just a tick — record it and escalate.  No restart
                    # and no reset here; the router owns recovery (it
                    # harvests this ledger and replays elsewhere).
                    self.faults.append({
                        "kind": type(exc).__name__,
                        "message": str(exc),
                        "tick": tick,
                        "recovery_s": None,
                        "rolled_back": snap is not None,
                        "escalated": True,
                    })
                    raise
                self.restarts += 1
                crash_looping = self.restarts > self.max_restarts
                if crash_looping:
                    raise
                self.engine.reset()
                recovery_s = self._clock() - t_fault
                self.faults.append({
                    "kind": type(exc).__name__,
                    "message": str(exc),
                    "tick": tick,
                    "recovery_s": recovery_s,
                    "rolled_back": snap is not None,
                })
                continue
            # clean completion: fold the engine's per-request errors
            # (validation rejects, admission sheds) into the ledger
            engine_stats = out["stats"]
            for uid, msg in out["errors"].items():
                e = self.ledger.entries.get(uid)
                if e is not None and not e.retired and e.error is None:
                    e.error = msg
                engine_errors[uid] = msg
            break

        errors = {uid: e.error for uid, e in self.ledger.entries.items()
                  if e.error is not None}
        results = self.ledger.results()
        lost = [uid for uid, e in self.ledger.entries.items()
                if not e.retired and e.error is None]
        stats = {
            "requests": len(self.ledger.entries),
            "completed": len(results),
            "errored": len(errors),
            "requests_lost": len(lost),
            "lost_uids": lost,
            "restarts": self.restarts,
            "faults": self.faults,
            "ticks": self.ticks_seen,
            "deadline_misses": self.deadline_misses,
            "deadline_ms": self.deadline_ms,
            "retries": self.retries,
            "total_seconds": self._clock() - t_start,
            "engine": engine_stats,
        }
        if self.reload is not None:
            stats["reload"] = self.reload.stats()
        if self.admission is not None:
            stats["admission"] = self.admission.stats()
        return {"results": results, "errors": errors, "stats": stats}
