"""Fleet tier: N supervised engines behind a health-checked router (the
port of the JAX package's ``serve/fleet.py``).

"Millions of users" means no single engine is ever the whole story —
the unit of serving becomes a FLEET of replicas, and the interesting
failure modes move up a layer: a replica crashing must not lose
requests, a straggling replica must stop receiving traffic before it
drags tail latency, and a router blind-spot must degrade placement
quality, not correctness.  :class:`FleetRouter` drives N
:class:`..serve.engine.PagedEngine` replicas, each under its own
:class:`..serve.supervisor.ServeSupervisor`, and owns the three
fleet-level behaviors:

* **Routing on predicted prefix hits.**  Each replica exports a cheap
  chain-hash summary of its prefix index
  (:meth:`..serve.paged.BlockManager.prefix_summary`); the router walks
  a prompt's block hashes against each summary
  (:func:`..serve.paged.predict_shared_len`) and places where the most
  prompt tokens are already cached, tiebreaking on least queue depth
  then replica id.  Placements feed back into the summary, so requests
  sharing a system prompt co-locate even before any of them finishes.
* **Zero-loss failover.**  Replica supervisors run with
  ``fatal=(ReplicaCrash,)``: a fleet-level crash escalates instead of
  being contained, the router quarantines the replica, warm-resets its
  engine (same captured tick — ``decode_captures`` stays 1), and
  replays the crashed replica's in-flight requests from the fleet
  :class:`..serve.supervisor.RequestLedger` onto healthy replicas, so
  ``requests_lost == 0`` by construction (the replay recomputes the
  committed prefix; ROADMAP.md item 13's determinism rule says where
  it may part from a fault-free run).
* **Health tracking.**  Heartbeats (per-tick observations through the
  supervisor's ``fleet_hook``) and supervisor stats drive a three-state
  health machine — ``healthy`` / ``degraded`` (slow ticks beyond the
  budget, or deep in the admission ladder) / ``quarantined`` (crashed)
  — and the router prefers healthy replicas at placement time.

Execution is ROUND-BASED on one box: per round the router places every
open request, runs each replica's supervisor to completion, then
harvests every supervisor ledger into the fleet ledger.  That keeps the
whole tier deterministic and drillable; the routing, failover, and
health logic are exactly what a concurrent deployment would run between
ticks.  The replicas share one copy of the weights (engines built on one
model hold the same module), each with its own pools and captured tick.
``telemetry=`` routes the router's and the engines' metrics into one
registry; ``recorder=`` (:class:`..obs.recorder.FlightRecorder`) gets
the routing, health, evacuation and scaling events.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np

from distributed_deep_learning_tpu_torch.obs.metrics import MetricsRegistry
from distributed_deep_learning_tpu_torch.serve import migrate as migrate_mod
from distributed_deep_learning_tpu_torch.serve import paged, rebalance
from distributed_deep_learning_tpu_torch.serve.load import merge_slo_reports
from distributed_deep_learning_tpu_torch.serve.scheduler import Request
from distributed_deep_learning_tpu_torch.serve.supervisor import (
    RequestLedger, ServeSupervisor)

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
#: terminal state a scale-down drain leaves a replica in: its warm KV
#: was evacuated to survivors and it takes no further placements
RETIRED = "retired"

_HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, QUARANTINED: 2, RETIRED: 3}


class ReplicaCrash(RuntimeError):
    """A whole replica died (process gone, device wedged) — the fault
    class a single engine's supervisor cannot contain.  Supervisors in
    a fleet run with ``fatal=(ReplicaCrash,)`` so it escalates to the
    router, which owns quarantine + cross-replica replay."""


@dataclasses.dataclass
class _Replica:
    """Router-side record of one engine replica."""

    rid: int
    engine: object
    supervisor_kw: dict
    health: str = HEALTHY
    assigned: list = dataclasses.field(default_factory=list)
    summary: set = dataclasses.field(default_factory=set)
    ticks: int = 0
    slow_ticks: int = 0
    crashes: int = 0
    placements: int = 0
    draining: bool = False            # scale-down drain: no placements
    stats: Optional[dict] = None      # last clean supervisor stats

    @property
    def strikes(self) -> int:
        """Recent-trouble score: crashes weigh heavier than slow
        ticks.  Routing prefers fewer strikes among otherwise-equal
        candidates, and the total-outage fallback leads with the
        least-struck replica."""
        return 10 * self.crashes + self.slow_ticks


def _prompt_hashes(prompt, block_size: int) -> list:
    """The chain hashes a prompt's full blocks will register under once
    prefilled — what a placement adds to the routed replica's PREDICTED
    summary (same ``len - 1`` cap as the real index)."""
    toks = np.asarray(prompt)
    L = len(toks)
    h = b""
    out = []
    i = 0
    while (i + 1) * block_size <= L - 1:
        h = paged.chain_hash(
            h, tuple(int(t) for t in toks[i * block_size:
                                          (i + 1) * block_size]))
        out.append(h)
        i += 1
    return out


class FleetRouter:
    """Health-checked router over N supervised engine replicas.

    ``engines`` share one model geometry (any mix of quantization /
    speculation settings with identical greedy outputs is fine — greedy
    continuations must be replica-invariant for failover to replay them).
    ``chaos`` is a :class:`..utils.chaos.ChaosPlan` whose fleet kinds
    fire through the per-replica tick observer (``replica_crash``,
    ``replica_straggler``) and the placement path (``router_flake``).
    ``admissions`` optionally maps replica id -> its
    :class:`..serve.admission.AdmissionController` (each replica needs
    its own ladder state).

    ``run()`` returns the engines' ``{"results", "errors", "stats"}``
    contract; ``stats`` adds the fleet record — per-replica health,
    routing decisions, faults, and a merged per-priority SLO report.
    """

    def __init__(self, engines, *, chaos=None, deadline_ms=None,
                 retries: int = 2, max_restarts: int = 8,
                 stall_timeout_s=None, slow_tick_s: Optional[float] = None,
                 degrade_after: int = 2, degrade_pressure: float = 0.67,
                 admissions: Optional[dict] = None,
                 share_prefixes: bool = False, telemetry=None,
                 recorder=None, clock=time.monotonic,
                 evacuate_on: str = "off", autoscaler=None,
                 engine_factory=None, hotspot=None):
        engines = list(engines)
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if degrade_after < 1:
            raise ValueError(f"degrade_after must be >= 1, got "
                             f"{degrade_after}")
        if evacuate_on not in ("off", "degraded", "hotspot"):
            raise ValueError(f"evacuate_on must be one of 'off', "
                             f"'degraded', 'hotspot'; got "
                             f"{evacuate_on!r}")
        eos = {e.eos_id for e in engines}
        if len(eos) != 1:
            raise ValueError(f"replicas disagree on eos_id: {sorted(map(str, eos))}")
        self.chaos = chaos
        self.telemetry = telemetry
        self.recorder = recorder
        self.retries = int(retries)
        self.slow_tick_s = slow_tick_s
        self.degrade_after = int(degrade_after)
        self.degrade_pressure = float(degrade_pressure)
        self.admissions = dict(admissions or {})
        self._clock = clock
        sup_kw = dict(deadline_ms=deadline_ms, retries=retries,
                      max_restarts=max_restarts,
                      stall_timeout_s=stall_timeout_s)
        self.replicas = [_Replica(rid=i, engine=e, supervisor_kw=sup_kw)
                         for i, e in enumerate(engines)]
        self.ledger = RequestLedger(engines[0].eos_id)
        self.faults: list[dict] = []
        self.rounds = 0
        self.route_seq = 0
        self.flake_degraded = 0
        self.predicted_hit_tokens = 0
        self.shared_prefix_moves = 0
        self.shared_prefix_tokens = 0
        reg = telemetry.registry if telemetry is not None \
            else MetricsRegistry()
        self._registry = reg
        # warm prefix sharing: when placement lands off the warm
        # replica (health outranks hits), migrate the donor's committed
        # prefix blocks to the chosen one instead of recomputing them
        self._migrator = migrate_mod.BlockMigrator(
            engines[0].blocks_per_slot, registry=reg) \
            if share_prefixes else None
        # live rebalancing: evacuation + autoscaler share one migrator
        # (like the prefix-share path)
        self.evacuate_on = str(evacuate_on)
        self.autoscaler = autoscaler
        self.engine_factory = engine_factory
        self._hotspot = None
        if self.evacuate_on == "hotspot":
            self._hotspot = (hotspot if hotspot is not None
                             else rebalance.HotspotDetector())
        self._evac_migrator = None
        if self.evacuate_on != "off" or autoscaler is not None:
            self._evac_migrator = migrate_mod.BlockMigrator(
                engines[0].blocks_per_slot, registry=reg)
        self._evac_chaos = (chaos.evac_corruptor()
                            if chaos is not None else None)
        self._fatal = ((ReplicaCrash, rebalance.EvacuationSignal)
                       if self.evacuate_on != "off"
                       else (ReplicaCrash,))
        self._pins: dict[int, int] = {}      # uid -> resume replica id
        self._recent_prompts: list = []      # warm-up pool for scale-up
        self.evacuations: list[dict] = []
        self._evac_seq = 0
        self._scale_ticks = 0
        self._g_health = {r.rid: reg.gauge("fleet_replica_health",
                                           replica=str(r.rid))
                          for r in self.replicas}
        self._g_assigned = {r.rid: reg.gauge("fleet_replica_assigned",
                                             replica=str(r.rid))
                            for r in self.replicas}
        self._g_ticks = {r.rid: reg.gauge("fleet_replica_ticks",
                                          replica=str(r.rid))
                         for r in self.replicas}

    # --- health -----------------------------------------------------------
    def _observe_tick(self, rep: _Replica, report) -> None:
        """Per-tick heartbeat from a replica's supervisor (the
        ``fleet_hook`` seam): fires due fleet chaos, folds the tick's
        wall time into the straggler and hot-spot detectors, and — when
        evacuation is armed — raises
        :class:`..serve.rebalance.EvacuationSignal` on a
        healthy→degraded transition so the replica drains its live
        slots BEFORE it crashes (the supervisor escalates the signal
        like a fatal fault; the router answers with a verified KV
        migration instead of a discard)."""
        rep.ticks += 1
        extra = 0.0
        if self.chaos is not None:
            extra = self.chaos.fleet_hook(rep.rid, report)
        elapsed = report.elapsed_s + extra
        if (self.slow_tick_s is not None
                and elapsed > self.slow_tick_s):
            rep.slow_ticks += 1
            if (rep.slow_ticks >= self.degrade_after
                    and rep.health == HEALTHY):
                rep.health = DEGRADED
                if self.recorder is not None:
                    self.recorder.record("replica_degraded",
                                         replica=rep.rid,
                                         slow_ticks=rep.slow_ticks)
                if self.evacuate_on != "off":
                    raise rebalance.EvacuationSignal(rep.rid, "degraded")
        if self._hotspot is not None and report.kind == "decode":
            hot = self._hotspot.observe(rep.rid, elapsed)
            if hot and rep.health == HEALTHY:
                rep.health = DEGRADED
                if self.recorder is not None:
                    self.recorder.record("replica_degraded",
                                         replica=rep.rid,
                                         reason="hotspot")
                raise rebalance.EvacuationSignal(rep.rid, "hotspot")

    def _export_gauges(self) -> None:
        for rep in self.replicas:
            self._g_health[rep.rid].set(_HEALTH_CODE[rep.health])
            self._g_assigned[rep.rid].set(len(rep.assigned))
            self._g_ticks[rep.rid].set(rep.ticks)

    # --- routing ----------------------------------------------------------
    def _route_one(self, req: Request, candidates: list) -> _Replica:
        """Place one request: most predicted prefix-hit tokens wins,
        healthy replicas outrank degraded ones, queue depth then
        replica id break ties.  A ``router_flake`` window blanks the
        hit signal (placement quality degrades; correctness never
        depends on it).  A request freshly evacuated to a replica is
        PINNED there for one round — its committed KV blocks live in
        that replica's pools, so resuming anywhere else would recompute
        what the migration just carried."""
        pinned = self._pins.pop(req.uid, None)
        if pinned is not None:
            rep = next((r for r in candidates if r.rid == pinned), None)
            if rep is not None:
                rep.assigned.append(req)
                rep.placements += 1
                rep.summary.update(_prompt_hashes(
                    req.prompt, rep.engine.block_size))
                if self.recorder is not None:
                    self.recorder.record("route", uid=req.uid,
                                         replica=rep.rid, pinned=True)
                return rep
        flaky = (self.chaos is not None
                 and self.chaos.route_hook(self.route_seq))
        self.route_seq += 1
        if flaky:
            self.flake_degraded += 1
        hits = {}
        for rep in candidates:
            if flaky:
                hits[rep.rid] = 0
            else:
                hits[rep.rid] = paged.predict_shared_len(
                    rep.summary, req.prompt, rep.engine.block_size)
        best = sorted(
            candidates,
            key=lambda rep: (0 if rep.health == HEALTHY else 1,
                             -hits[rep.rid], len(rep.assigned),
                             rep.strikes, rep.rid))[0]
        self.predicted_hit_tokens += hits[best.rid]
        if self._migrator is not None and not flaky:
            donor = max((r for r in candidates if r.rid != best.rid),
                        key=lambda r: hits[r.rid], default=None)
            if donor is not None and hits[donor.rid] > hits[best.rid]:
                # best-effort: moves only blocks the donor's REAL index
                # holds and the destination can adopt; 0 is fine
                moved = migrate_mod.clone_prefix(
                    donor.engine, best.engine, req.prompt,
                    self._migrator)
                if moved:
                    self.shared_prefix_moves += 1
                    self.shared_prefix_tokens += moved
                    if self.recorder is not None:
                        self.recorder.record(
                            "prefix_share", uid=req.uid,
                            donor=donor.rid, replica=best.rid,
                            tokens=moved)
        best.assigned.append(req)
        best.placements += 1
        # feed the placement back: the routed prompt's blocks will be
        # indexed there, so same-prefix followers co-locate immediately
        best.summary.update(_prompt_hashes(req.prompt,
                                           best.engine.block_size))
        # scale-up warm pool: the most recent prompts approximate the
        # hottest shared prefixes (shared-prefix traces repeat them)
        self._recent_prompts.append(req.prompt)
        del self._recent_prompts[:-16]
        if self.recorder is not None:
            self.recorder.record("route", uid=req.uid, replica=best.rid,
                                 predicted_hit=hits[best.rid],
                                 flaky=flaky)
        return best

    def _live_candidates(self) -> list:
        cands = [r for r in self.replicas
                 if r.health not in (QUARANTINED, RETIRED)
                 and not r.draining]
        if not cands:
            # total-outage fallback: every serving replica crashed at
            # least once.  The engines were warm-reset at quarantine
            # time, so return them to service DEGRADED rather than
            # losing work — least-struck replica first (the routing
            # tiebreak on ``strikes`` makes the preference real), and
            # a ``fleet_fallback`` flight-recorder event so the
            # postmortem can see the fleet ran on known-bad hardware.
            pool = sorted((r for r in self.replicas
                           if r.health != RETIRED),
                          key=lambda r: (r.strikes, r.rid))
            for r in pool:
                r.health = DEGRADED
                r.draining = False
            cands = pool
            if self.recorder is not None and pool:
                self.recorder.record(
                    "fleet_fallback", preferred=pool[0].rid,
                    strikes={r.rid: r.strikes for r in pool})
        return cands

    # --- live rebalancing -------------------------------------------------
    def _evac_target(self, src: _Replica) -> Optional[_Replica]:
        """Where a drained slot should land: a live, non-draining peer
        — healthy first, then fewest strikes, then least queue."""
        targets = [r for r in self.replicas
                   if r is not src
                   and r.health not in (QUARANTINED, RETIRED)
                   and not r.draining]
        if not targets:
            return None
        return sorted(targets,
                      key=lambda r: (0 if r.health == HEALTHY else 1,
                                     r.strikes, len(r.assigned),
                                     r.rid))[0]

    def evacuate(self, rep, uids, *, reason: str = "drain") -> list:
        """Migrate the committed KV of the given open requests off
        replica ``rep`` onto live peers — the mid-request slot
        evacuation primitive.

        Per uid: the fleet ledger gives the exact committed token
        stream (prompt + tail), the source's prefix index maps it to
        physical blocks, and :func:`..serve.rebalance.evacuate_slot`
        carries them digest-verified into the target's pools, rolling
        back (``unadopt``) on a corrupted payload so the request simply
        replays cold — zero loss either way.  Successful moves pin the
        request to the target for the next round's placement.

        Priority-0 requests evacuate LAST: they keep their source
        blocks (still valid — evacuation copies, never destroys) until
        every lower class has a confirmed landing, so a mid-drain
        failure strands the cheapest work first.  Returns the per-uid
        evacuation records (also appended to ``self.evacuations``)."""
        if isinstance(rep, int):
            rep = self.replicas[rep]
        if self._evac_migrator is None:
            self._evac_migrator = migrate_mod.BlockMigrator(
                rep.engine.blocks_per_slot, registry=self._registry)
        order = sorted(
            (uid for uid in uids if uid in self.ledger.entries),
            key=lambda uid:
            (self.ledger.entries[uid].request.priority == 0, uid))
        records = []
        for uid in order:
            e = self.ledger.entries[uid]
            if e.retired or e.error is not None:
                continue
            self._evac_seq += 1
            tgt = self._evac_target(rep)
            if tgt is None:
                records.append({"uid": uid, "source": rep.rid,
                                "target": None, "ok": False,
                                "rolled_back": False, "aborted": None,
                                "reason": reason,
                                "error": "no live evacuation target"})
                continue
            if (self.chaos is not None
                    and self.chaos.evac_crash_hook(self._evac_seq)):
                # the TARGET dies mid-evacuation: quarantine it (warm
                # reset, like any crash) and abort this move — the
                # source still holds every block, the request stays
                # open, and the ledger replay recovers it
                tgt.crashes += 1
                tgt.health = QUARANTINED
                tgt.engine.reset()
                self.faults.append({
                    "replica": tgt.rid, "kind": "ReplicaCrash",
                    "message": "injected target crash mid-evacuation",
                    "tick": None, "round": self.rounds,
                    "recovery_s": None, "_t_fault": self._clock()})
                if self.recorder is not None:
                    self.recorder.record("replica_quarantined",
                                         replica=tgt.rid,
                                         during="evacuation")
                records.append({"uid": uid, "source": rep.rid,
                                "target": tgt.rid, "ok": False,
                                "rolled_back": False,
                                "aborted": "target_crash",
                                "reason": reason,
                                "error": "target crashed mid-evac"})
                continue
            stream = np.concatenate(
                [np.asarray(e.request.prompt),
                 np.asarray(e.committed,
                            dtype=e.request.prompt.dtype)]) \
                if e.committed else np.asarray(e.request.prompt)
            t0 = self._clock()
            rec = rebalance.evacuate_slot(
                rep.engine, tgt.engine, stream, self._evac_migrator,
                chaos=self._evac_chaos)
            rec.update(uid=uid, source=rep.rid, target=tgt.rid,
                       reason=reason, aborted=None,
                       priority=int(e.request.priority),
                       committed=len(e.committed),
                       seconds=self._clock() - t0)
            if rec["ok"] and rec["tokens"] > 0:
                self._pins[uid] = tgt.rid
            records.append(rec)
            if self.recorder is not None:
                self.recorder.record(
                    "evacuation", uid=uid, source=rep.rid,
                    target=tgt.rid, blocks=rec.get("blocks", 0),
                    rolled_back=rec.get("rolled_back", False),
                    reason=reason)
        self.evacuations.extend(records)
        return records

    # --- elastic autoscaling ----------------------------------------------
    def _autoscale_round(self, override=None):
        """One autoscaler control-loop step (end of every round): fold
        the round's queue/occupancy into a fleet signal dict, let the
        hysteresis decide, actuate.  ``override`` ("hot"/"cold") is the
        ``scale_thrash`` chaos seam — it replaces the measured signals
        with saturated/idle ones, proving the hysteresis bounds how
        often an oscillating load can move the fleet."""
        live = [r for r in self.replicas
                if r.health not in (QUARANTINED, RETIRED)
                and not r.draining]
        open_n = sum(1 for e in self.ledger.entries.values()
                     if not e.retired and e.error is None)
        cap = sum(r.engine.max_slots for r in live)
        sig = {
            "queue_depth": float(open_n),
            "occupancy": (sum(len(r.assigned) for r in live) / cap)
            if cap else 1.0,
        }
        self._scale_ticks += 1
        if override is None and self.chaos is not None:
            override = self.chaos.scale_hook(self._scale_ticks)
        if override == "hot":
            sig = {"queue_depth": 1e9, "occupancy": 1.0}
        elif override == "cold":
            sig = {"queue_depth": 0.0, "occupancy": 0.0}
        action = self.autoscaler.observe(sig, len(live))
        if action == "grow":
            self._scale_up()
        elif action == "shrink":
            self._scale_down()
        return action

    def _scale_up(self) -> Optional[_Replica]:
        """Grow the replica set by one: a fresh engine from the
        factory (the published-weights seam — same params every replica
        serves), warmed with ``clone_prefix`` of the hottest recent
        prompts so its first placements already hit cache."""
        if self.engine_factory is None:
            if self.recorder is not None:
                self.recorder.record("scale_up_skipped",
                                     reason="no engine_factory")
            return None
        eng = self.engine_factory()
        rid = len(self.replicas)
        rep = _Replica(rid=rid, engine=eng,
                       supervisor_kw=self.replicas[0].supervisor_kw)
        warmed = 0
        if self._evac_migrator is not None:
            donors = [r for r in self.replicas
                      if r.health not in (QUARANTINED, RETIRED)
                      and not r.draining]
            for prompt in self._recent_prompts[-4:]:
                for d in donors:
                    moved = migrate_mod.clone_prefix(
                        d.engine, eng, prompt, self._evac_migrator)
                    if moved:
                        warmed += moved
                        break
        self.replicas.append(rep)
        reg = self._registry
        self._g_health[rid] = reg.gauge("fleet_replica_health",
                                        replica=str(rid))
        self._g_assigned[rid] = reg.gauge("fleet_replica_assigned",
                                          replica=str(rid))
        self._g_ticks[rid] = reg.gauge("fleet_replica_ticks",
                                       replica=str(rid))
        if self.recorder is not None:
            self.recorder.record("scale_up", replica=rid,
                                 warm_tokens=warmed)
        return rep

    def _scale_down(self) -> Optional[_Replica]:
        """Shrink by one via the drain protocol: pick a victim
        (quarantined > degraded > fewest placements), stop placing on
        it, evacuate every open request's committed KV it holds to
        survivors, then retire it.  Survivors keep their captured ticks
        — ``decode_captures`` stays 1."""
        live = [r for r in self.replicas
                if r.health != RETIRED and not r.draining]
        serving = [r for r in live if r.health != QUARANTINED]
        if len(serving) <= 1:
            return None        # never drain the last serving replica
        victim = sorted(live,
                        key=lambda r: (-_HEALTH_CODE[r.health],
                                       r.placements, -r.rid))[0]
        victim.draining = True          # 1) stop placement
        open_uids = [uid for uid, e in self.ledger.entries.items()
                     if not e.retired and e.error is None]
        self.evacuate(victim, open_uids, reason="drain")  # 2) evacuate
        for uid, rid in list(self._pins.items()):
            if rid == victim.rid:
                del self._pins[uid]
        victim.engine.reset()           # 3) retire (warm: programs kept)
        victim.health = RETIRED
        victim.draining = False
        if self.recorder is not None:
            self.recorder.record("scale_down", replica=victim.rid)
        return victim

    # --- replay (fleet ledger -> next round's requests) -------------------
    def _open_requests(self) -> list:
        out = []
        for e in self.ledger.open_entries():
            r = e.request
            if e.attempts > self.retries:
                e.error = (f"retries: request survived {e.attempts - 1} "
                           f"replica fault(s), exceeding the fleet "
                           f"retry budget {self.retries}")
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
    def run(self, requests: Iterable[Request]) -> dict:
        for req in requests:
            self.ledger.add(req)
        t_start = self._clock()
        slo_reports: list[dict] = []
        errors: dict = {}
        max_rounds = len(self.replicas) + 2 + self.retries

        while True:
            todo = self._open_requests()
            if not todo or self.rounds >= max_rounds:
                break
            self.rounds += 1
            for e in self.ledger.entries.values():
                if not e.retired and e.error is None:
                    e.attempts += 1
            # route this round's work over live replicas, freshest
            # REAL index summaries first (placement feedback stacks on
            # top for the requests routed within the round)
            cands = self._live_candidates()
            for rep in cands:
                rep.assigned = []
                rep.summary = set(rep.engine.manager.prefix_summary())
            for req in sorted(todo, key=lambda r: (r.arrival_tick,
                                                   r.uid)):
                self._route_one(req, cands)
            self._export_gauges()

            for rep in cands:
                if not rep.assigned:
                    continue
                sup = ServeSupervisor(
                    rep.engine, chaos=None,
                    admission=self.admissions.get(rep.rid),
                    recorder=self.recorder,
                    fleet_hook=(lambda report, _rep=rep:
                                self._observe_tick(_rep, report)),
                    fatal=self._fatal, **rep.supervisor_kw)
                t0 = self._clock()
                evac_signal = None
                try:
                    out = sup.run(list(rep.assigned),
                                  telemetry=self.telemetry)
                except rebalance.EvacuationSignal as exc:
                    # proactive drain: the replica is degrading, not
                    # dead — after the ledger harvest below, its open
                    # slots migrate to peers (verified, bit-exact) and
                    # the engine warm-resets
                    evac_signal = exc
                    out = None
                except ReplicaCrash as exc:
                    rep.crashes += 1
                    rep.health = QUARANTINED
                    fault_tick = (sup.faults[-1]["tick"]
                                  if sup.faults else None)
                    # warm reset NOW so the replica can return to
                    # service under its captured tick (decode_captures
                    # stays 1)
                    rep.engine.reset()
                    self.faults.append({
                        "replica": rep.rid,
                        "kind": type(exc).__name__,
                        "message": str(exc),
                        "tick": fault_tick,
                        "round": self.rounds,
                        "recovery_s": None,   # filled when replays land
                        "_t_fault": t0,
                    })
                    if self.recorder is not None:
                        self.recorder.record("replica_quarantined",
                                             replica=rep.rid,
                                             tick=fault_tick)
                    out = None
                finally:
                    # EVERY supervisor ledger is harvested — crashed
                    # rounds contribute the tokens their ticks already
                    # committed, so replay resumes instead of restarting
                    for uid, entry in sup.ledger.entries.items():
                        for tok in entry.committed:
                            self.ledger.commit(uid, tok)
                if evac_signal is not None:
                    # the harvest above synced the fleet ledger, so the
                    # committed tail is authoritative — now move the
                    # live slots' KV, then warm-reset the source (same
                    # captured tick; decode_captures stays 1)
                    open_uids = [
                        r.uid for r in rep.assigned
                        if (e := self.ledger.entries.get(r.uid))
                        is not None and not e.retired
                        and e.error is None]
                    self.evacuate(rep, open_uids,
                                  reason=evac_signal.reason)
                    rep.engine.reset()
                if out is not None:
                    rep.stats = out["stats"]
                    slo_reports.append(out["stats"]["engine"]["slo"])
                    for uid, msg in out["errors"].items():
                        e = self.ledger.entries.get(uid)
                        if e is not None and not e.retired \
                                and e.error is None:
                            e.error = msg
                    # admission-ladder pressure marks a hot replica
                    adm = self.admissions.get(rep.rid)
                    if (adm is not None and rep.health == HEALTHY
                            and adm.pressure() >= self.degrade_pressure):
                        rep.health = DEGRADED
            # a completed round means every replayed request from prior
            # faults has landed — close their recovery clocks
            now = self._clock()
            for f in self.faults:
                if f["recovery_s"] is None:
                    f["recovery_s"] = now - f.pop("_t_fault")
            if self.autoscaler is not None:
                self._autoscale_round()
            self._export_gauges()

        for uid, e in self.ledger.entries.items():
            if e.error is not None:
                errors[uid] = e.error
        results = self.ledger.results()
        lost = [uid for uid, e in self.ledger.entries.items()
                if not e.retired and e.error is None]
        for f in self.faults:                 # never leak the raw clock
            f.pop("_t_fault", None)
        stats = {
            "fleet": True,
            "replicas": len(self.replicas),
            "health": {r.rid: r.health for r in self.replicas},
            "rounds": self.rounds,
            "requests": len(self.ledger.entries),
            "completed": len(results),
            "errored": len(errors),
            "requests_lost": len(lost),
            "lost_uids": lost,
            "faults": self.faults,
            "total_seconds": self._clock() - t_start,
            "routing": {
                "decisions": self.route_seq,
                "assignments": {r.rid: r.placements
                                for r in self.replicas},
                "predicted_hit_tokens": self.predicted_hit_tokens,
                "flake_degraded": self.flake_degraded,
                "shared_prefix_moves": self.shared_prefix_moves,
                "shared_prefix_tokens": self.shared_prefix_tokens,
            },
            "per_replica": {
                r.rid: {
                    "health": r.health,
                    "ticks": r.ticks,
                    "slow_ticks": r.slow_ticks,
                    "crashes": r.crashes,
                    "placements": r.placements,
                    "decode_captures": r.engine._tick.captures,
                    "restarts": r.engine.restarts,
                    "stats": r.stats,
                } for r in self.replicas},
            # merge against the LEDGER's priority universe: a class no
            # replica served this run still shows up with zero counts,
            # so attainment keeps its shape across rounds
            "slo": merge_slo_reports(
                slo_reports,
                classes={e.request.priority
                         for e in self.ledger.entries.values()}),
        }
        evac_ok = [r for r in self.evacuations if r.get("ok")]
        stats["rebalance"] = {
            "evacuate_on": self.evacuate_on,
            "evacuations": len(self.evacuations),
            "evacuated_slots": sum(1 for r in evac_ok
                                   if r.get("tokens", 0) > 0),
            "evacuated_blocks": sum(r.get("blocks", 0)
                                    for r in evac_ok),
            "evacuated_tokens": sum(r.get("tokens", 0)
                                    for r in evac_ok),
            "rolled_back": sum(1 for r in self.evacuations
                               if r.get("rolled_back")),
            "aborted": sum(1 for r in self.evacuations
                           if r.get("aborted")),
            "evac_seconds": sum(r.get("seconds", 0.0)
                                for r in self.evacuations),
            "hotspot_detections": (len(self._hotspot.detections)
                                   if self._hotspot is not None else 0),
            "records": self.evacuations,
        }
        if self.autoscaler is not None:
            stats["autoscaler"] = {
                **self.autoscaler.stats(),
                "replicas_final": sum(1 for r in self.replicas
                                      if r.health != RETIRED),
                "replicas_retired": sum(1 for r in self.replicas
                                        if r.health == RETIRED),
            }
        for rid, adm in sorted(self.admissions.items()):
            stats.setdefault("admission", {})[rid] = adm.stats()
        return {"results": results, "errors": errors, "stats": stats}
