"""Elastic fleet sizing: a hysteresis control loop over live signals.

The :class:`..serve.admission.AdmissionController` answers "the fleet
is overloaded, shed work"; the autoscaler answers the next question —
"the fleet is the wrong SIZE, change it".  :class:`FleetAutoscaler` is
the decision half: a pure, clock-free control loop over the windowed
queue-depth / occupancy / ITL gauges (:class:`..obs.window.LiveSignals`
shapes them; the router summarises them per round), mirroring the
admission ladder's patience/cool hysteresis so a transient spike never
births a replica and a momentary lull never kills one.  The actuation
half lives in :class:`..serve.fleet.FleetRouter` (grow = warm a new
replica from the published weights + ``clone_prefix`` of the hottest
shared prefixes; shrink = drain protocol: stop placement → evacuate
open slots → retire) — keeping ``observe`` pure makes the hysteresis
unit-testable with injected signal dicts.

The port of the JAX package's ``serve/autoscaler.py`` less its
``PoolRebalancer``, which moves workers between disaggregated serving's
pools (ROADMAP.md queue 1 item 13's remainder, disaggregation).
"""

from __future__ import annotations

from typing import Optional


class FleetAutoscaler:
    """Grow/shrink decisions for a supervised replica set.

    ``observe(signals, n_replicas)`` consumes one round's fleet summary
    — ``queue_depth`` (open requests), ``occupancy`` (live-slot
    fraction), optional ``itl_p99_s`` — and returns ``"grow"``,
    ``"shrink"`` or ``None``.  A round is HOT when the queue holds more
    than ``grow_queue_per_replica`` open requests per live replica (or
    occupancy crosses ``grow_occupancy``, or ITL p99 crosses
    ``grow_itl_p99_s`` when given); COLD when occupancy sits below
    ``shrink_occupancy`` with an empty queue.  ``patience`` consecutive
    hot rounds trigger a grow, ``cool`` consecutive cold rounds a
    shrink — the admission ladder's hysteresis shape, so load between
    the two bands parks the fleet where it is.  ``min_replicas`` /
    ``max_replicas`` clamp the actuation; ``events`` records every
    decision for the drill record."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 patience: int = 2, cool: int = 2,
                 grow_queue_per_replica: float = 4.0,
                 grow_occupancy: float = 0.9,
                 grow_itl_p99_s: Optional[float] = None,
                 shrink_occupancy: float = 0.25):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < "
                             f"min_replicas {min_replicas}")
        if patience < 1 or cool < 1:
            raise ValueError(f"patience/cool must be >= 1, got "
                             f"patience={patience} cool={cool}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.patience = int(patience)
        self.cool = int(cool)
        self.grow_queue_per_replica = float(grow_queue_per_replica)
        self.grow_occupancy = float(grow_occupancy)
        self.grow_itl_p99_s = grow_itl_p99_s
        self.shrink_occupancy = float(shrink_occupancy)
        self._hot = 0
        self._cold = 0
        self.events: list[dict] = []

    def _is_hot(self, signals: dict, n: int) -> bool:
        q = float(signals.get("queue_depth", 0.0))
        if q > self.grow_queue_per_replica * max(n, 1):
            return True
        if float(signals.get("occupancy", 0.0)) >= self.grow_occupancy:
            return True
        itl = signals.get("itl_p99_s")
        return (self.grow_itl_p99_s is not None and itl is not None
                and float(itl) > self.grow_itl_p99_s)

    def _is_cold(self, signals: dict) -> bool:
        return (float(signals.get("queue_depth", 0.0)) == 0.0
                and float(signals.get("occupancy", 1.0))
                < self.shrink_occupancy)

    def observe(self, signals: dict, n_replicas: int):
        """One control-loop step; returns ``"grow"``/``"shrink"``/None.

        Counters are mutually exclusive (a hot round zeroes the cold
        streak and vice versa) and reset after every decision, so an
        oscillating load (the ``scale_thrash`` drill) pays full
        patience/cool for EVERY action — bounded thrash by
        construction."""
        n = int(n_replicas)
        if self._is_hot(signals, n):
            self._hot += 1
            self._cold = 0
        elif self._is_cold(signals):
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        if self._hot >= self.patience and n < self.max_replicas:
            self._hot = self._cold = 0
            self.events.append({"action": "grow", "replicas": n,
                                "signals": dict(signals)})
            return "grow"
        if self._cold >= self.cool and n > self.min_replicas:
            self._hot = self._cold = 0
            self.events.append({"action": "shrink", "replicas": n,
                                "signals": dict(signals)})
            return "shrink"
        return None

    def stats(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "patience": self.patience,
            "cool": self.cool,
            "scale_events": len(self.events),
            "grows": sum(1 for e in self.events
                         if e["action"] == "grow"),
            "shrinks": sum(1 for e in self.events
                           if e["action"] == "shrink"),
        }
