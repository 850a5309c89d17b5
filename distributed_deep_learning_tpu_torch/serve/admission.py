"""SLO-aware admission control: degrade gracefully, shed fairly (the
JAX package's ``serve/admission.py``, copied).

Protects serving SLOs under overload with a ladder of increasingly
blunt instruments, applied host-side between ticks (never inside a
captured tick):

* level 0 — healthy, everything admitted at full quality;
* level 1 — drop speculative decoding (draft work steals verify-tick
  budget from latency; turning it off trades throughput for ITL);
* level 2 — shrink the prefill chunk budget to one chunk per tick
  (prefill compute is the main decode-tick latency thief);
* level 3 — shed: NEW arrivals with ``priority >= shed_priority`` are
  refused at admission with a ``"shed: ..."`` error instead of being
  queued into an SLO miss.  Priority 0 (interactive) is NEVER shed,
  and requests already holding slots are never evicted.

Escalation keys off the windowed ITL p99 and queue depth
(:mod:`..obs.window` signals the engines already maintain) with
hysteresis — ``patience`` consecutive overloaded ticks to step up,
``cool`` consecutive healthy ticks to step down — so one slow tick
does not flap quality.  A hard queue-depth cap backstops the ladder:
beyond it, sheddable work is refused regardless of level (a queue
that long cannot meet anyone's deadline anyway).

The engine seams this relies on (``set_spec_enabled``,
``chunks_per_tick`` / ``_base_chunks_per_tick``) are probed with
``hasattr`` so the same controller drives both the slot and paged
engines.
"""

from __future__ import annotations

import time
from typing import Optional


class AdmissionController:
    """Degradation ladder + load shedder for a serving engine.

    Wired into ``engine.run(..., admission=ctrl)``: the engine asks
    ``should_shed(req, queue_depth)`` before placing each arrival, and
    calls ``observe(live, queue_depth, now)`` + ``apply(engine)`` once
    per decode tick."""

    def __init__(self, *, itl_p99_ms: float = 200.0,
                 max_queue_depth: int = 64,
                 shed_priority: int = 1,
                 patience: int = 3, cool: int = 6,
                 clock=time.monotonic):
        if itl_p99_ms <= 0:
            raise ValueError(f"itl_p99_ms must be > 0, got {itl_p99_ms}")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        if shed_priority < 1:
            # priority 0 is the interactive class and must stay
            # unsheddable by construction
            raise ValueError(f"shed_priority must be >= 1, got "
                             f"{shed_priority}")
        if patience < 1 or cool < 1:
            raise ValueError("patience and cool must be >= 1")
        self.itl_p99_ms = float(itl_p99_ms)
        self.max_queue_depth = int(max_queue_depth)
        self.shed_priority = int(shed_priority)
        self.patience = int(patience)
        self.cool = int(cool)
        self._clock = clock
        self.level = 0
        self._hot = 0       # consecutive overloaded ticks
        self._cold = 0      # consecutive healthy ticks
        self.shed_total = 0
        self.shed_by_priority: dict[int, int] = {}
        self.level_changes: list[tuple[int, int]] = []  # (from, to)
        self._applied_level: Optional[int] = None

    # --- admission gate (called by the engine per arrival) ----------------
    def should_shed(self, req, queue_depth: int) -> Optional[str]:
        """Return a shed reason, or None to admit."""
        prio = getattr(req, "priority", 1)
        if prio < self.shed_priority:
            return None
        reason = None
        if queue_depth > self.max_queue_depth:
            reason = (f"queue depth {queue_depth} exceeds hard cap "
                      f"{self.max_queue_depth} (priority {prio})")
        elif self.level >= 3:
            reason = (f"overload level {self.level}, shedding priority "
                      f">= {self.shed_priority} (priority {prio})")
        if reason is not None:
            self.shed_total += 1
            self.shed_by_priority[prio] = (
                self.shed_by_priority.get(prio, 0) + 1)
        return reason

    # --- per-tick control loop --------------------------------------------
    def observe(self, live, queue_depth: int,
                now: Optional[float] = None) -> None:
        """Fold one decode tick's live signals into the hysteresis
        counters and move the degradation level."""
        t = self._clock() if now is None else now
        itl_p99_ms = 1e3 * live.itl.percentile(99, t)
        overloaded = (live.itl.count(t) > 0
                      and itl_p99_ms > self.itl_p99_ms)
        overloaded = overloaded or queue_depth > self.max_queue_depth
        if overloaded:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.patience and self.level < 3:
                self._step(self.level + 1)
                self._hot = 0
        else:
            self._cold += 1
            self._hot = 0
            if self._cold >= self.cool and self.level > 0:
                self._step(self.level - 1)
                self._cold = 0

    def _step(self, new_level: int) -> None:
        self.level_changes.append((self.level, new_level))
        self.level = new_level

    def apply(self, engine) -> None:
        """Project the current level onto the engine's quality knobs.
        Idempotent; only touches knobs when the level changed."""
        if self._applied_level == self.level:
            return
        self._applied_level = self.level
        if hasattr(engine, "set_spec_enabled"):
            engine.set_spec_enabled(self.level < 1)
        if hasattr(engine, "_base_chunks_per_tick"):
            engine.chunks_per_tick = (
                1 if self.level >= 2 else engine._base_chunks_per_tick)

    def pressure(self) -> float:
        """Scalar overload signal in ``[0, 1]`` — the degradation level
        normalised by its ceiling.  The fleet router folds this into
        per-replica health: a replica running hot (deep in its ladder)
        is DEGRADED and deprioritised for new placements even though it
        is still serving."""
        return self.level / 3.0

    def stats(self) -> dict:
        return {
            "level": self.level,
            "itl_p99_ms_target": self.itl_p99_ms,
            "max_queue_depth": self.max_queue_depth,
            "shed_priority": self.shed_priority,
            "shed_total": self.shed_total,
            "shed_by_priority": dict(sorted(
                self.shed_by_priority.items())),
            "level_changes": list(self.level_changes),
        }
