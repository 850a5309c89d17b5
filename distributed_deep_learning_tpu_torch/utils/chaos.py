"""Deterministic fault injection: the port of
``distributed_deep_learning_tpu/utils/chaos.py``.

A :class:`ChaosPlan` is a seeded list of :class:`ChaosEvent`\\ s, a fault
kind at a global train step, so the same plan replays bit-identically.

* In-band (``nan_batch``, ``grad_spike``, ``worker_failure``,
  ``stale_heartbeat``): :meth:`ChaosPlan.batch_hook`, which
  :func:`..train.loop.fit` calls on every train batch, fires each event at
  most once (a replay after recovery must not poison its batch again).
* Out-of-band (``ckpt_truncate``, ``ckpt_bitflip``, ``fs_error``): static
  injectors called against a checkpoint directory, a heartbeat file or a
  monitor, for faults that strike between steps.

* Serving and fleet (``SERVE_KINDS``, ``FLEET_KINDS``): fired from the
  supervisor's tick watchdog (:meth:`ChaosPlan.serve_hook`), the fleet
  router's per-replica tick observer (:meth:`ChaosPlan.fleet_hook`), its
  placement path (:meth:`ChaosPlan.route_hook`), the KV-migration
  payloads (:meth:`ChaosPlan.migrate_corruptor`,
  :meth:`ChaosPlan.evac_corruptor`), evacuation attempts
  (:meth:`ChaosPlan.evac_crash_hook`) and the autoscaler's rounds
  (:meth:`ChaosPlan.scale_hook`).  ``step`` means a decode tick, a
  routing decision, a transfer, an evacuation attempt or a round there.

:func:`run_resilience_drill` chains the whole detect, contain and recover
path on a small MLP and returns its record;
:func:`run_serve_resilience_drill`, :func:`run_fleet_resilience_drill`
and :func:`run_rebalance_drill` do the same for one supervised engine,
a fleet of three and its rebalancing; :func:`run_blackbox_drill` leaves
a flight recorder's dump behind a contained anomaly.  The topology fault,
:meth:`ChaosPlan.shrink_topology`, drives :mod:`..reshard.drill`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

KINDS = ("nan_batch", "grad_spike", "worker_failure", "stale_heartbeat")
INJECTOR_KINDS = ("ckpt_truncate", "ckpt_bitflip", "fs_error")
#: serve-side in-band kinds, fired by :meth:`ChaosPlan.serve_hook` from
#: inside the supervisor's tick watchdog (``step`` means decode TICK
#: here, not train step)
SERVE_KINDS = ("nan_logits", "stalled_tick", "corrupt_block",
               "engine_crash", "slow_tick")
#: fleet-tier in-band kinds: ``replica_crash`` / ``replica_straggler``
#: fire through :meth:`ChaosPlan.fleet_hook` inside a replica's tick
#: watchdog (``target`` selects the replica id); ``router_flake``
#: degrades the router's placement signal through
#: :meth:`ChaosPlan.route_hook` (``step`` means routing SEQUENCE number
#: there, ``magnitude`` the window width in placements);
#: ``migrate_drop`` corrupts one KV transfer through
#: :meth:`ChaosPlan.migrate_corruptor` (``step`` means MIGRATION number
#: — the n-th payload is damaged in flight, tripping the end-to-end
#: digest and forcing a ledger replay).
#:
#: Rebalance-tier kinds: ``evac_drop`` corrupts the n-th EVACUATION
#: payload through :meth:`ChaosPlan.evac_corruptor` (``step`` counts
#: evacuation transfers — the digest trips and the destination rolls
#: back via ``unadopt``); ``target_crash_mid_evac`` kills the
#: evacuation TARGET at evacuation attempt ``step`` through
#: :meth:`ChaosPlan.evac_crash_hook` (the move aborts, the source keeps
#: its blocks, the ledger replays); ``scale_thrash`` oscillates the
#: autoscaler's input signals hot/cold each round over the window
#: ``[step, step + magnitude)`` through :meth:`ChaosPlan.scale_hook`
#: (the hysteresis must bound the resulting scale events).
FLEET_KINDS = ("replica_crash", "replica_straggler", "router_flake",
               "migrate_drop", "evac_drop", "target_crash_mid_evac",
               "scale_thrash")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One planned fault: ``kind`` fired at global train step ``step``.

    ``magnitude`` scales the fault where meaningful (NaN fraction for
    ``nan_batch``, input blow-up factor for ``grad_spike``, staleness
    seconds for ``stale_heartbeat``); ``target`` is kind-specific (the
    dead rank for ``worker_failure``, the heartbeat dir for
    ``stale_heartbeat``)."""

    step: int
    kind: str
    magnitude: float = 0.0
    target: str | int | None = None

    def __post_init__(self):
        if self.kind not in KINDS + SERVE_KINDS + FLEET_KINDS:
            raise ValueError(f"chaos event kind {self.kind!r}: in-band "
                             f"kinds are {KINDS} (train), "
                             f"{SERVE_KINDS} (serve) and {FLEET_KINDS} "
                             f"(fleet; use the static injectors for "
                             f"{INJECTOR_KINDS})")
        if self.step < 1:
            raise ValueError(f"chaos event step must be >= 1, got "
                             f"{self.step}")


class ChaosPlan:
    """A seeded, replayable schedule of in-band faults.

    ``fired`` records every event that actually triggered as
    ``(global_step, kind)``: the evidence that the fault happened.
    ``sleep`` is how the stall kinds spend their time (``time.sleep``;
    a test passes its fake clock's, so nothing sleeps).  ``recorder``
    (:class:`..obs.recorder.FlightRecorder`) gets a ``chaos_fired``
    record a fired fault."""

    def __init__(self, events, seed: int = 0, sleep=time.sleep,
                 recorder=None):
        self.events = sorted(events, key=lambda e: e.step)
        self.seed = int(seed)
        self.sleep = sleep
        self.recorder = recorder
        self.fired: list[tuple[int, str]] = []
        self._done: set[int] = set()  # indices of one-shot events consumed

    def _record(self, step: int, kind: str, **fields) -> None:
        """A fired fault into the flight recorder, when one is attached."""
        if self.recorder is not None:
            self.recorder.record("chaos_fired", step=step, fault=kind,
                                 **fields)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ChaosPlan":
        """``"nan_batch@5,worker_failure@12"`` → a plan (CLI surface)."""
        events = []
        for part in spec.split(","):
            kind, _, step = part.strip().partition("@")
            if not step or not step.isdigit():
                raise ValueError(f"chaos spec entry {part!r}: expected "
                                 "'<kind>@<global-step>', e.g. "
                                 "'nan_batch@5'")
            events.append(ChaosEvent(step=int(step), kind=kind))
        return cls(events, seed=seed)

    def _rng(self, event: ChaosEvent) -> np.random.Generator:
        # seeded per (plan seed, event step): the poison mask is a pure
        # function of the plan, never of execution order
        return np.random.default_rng((self.seed, event.step))

    # -- in-band hook (fit's train loop) ------------------------------------
    def batch_hook(self, global_step: int, x, y):
        """Apply every due event to this train batch; may raise.

        Called by :func:`..train.loop.fit` before the step.  NaN and
        spike events rewrite a copy of the feature batch (on its
        device); ``worker_failure`` raises
        :class:`..utils.failures.WorkerFailure`; ``stale_heartbeat`` ages
        a heartbeat file so the monitor (not this hook) detects it."""
        for i, ev in enumerate(self.events):
            if i in self._done or ev.step != global_step:
                continue
            self._done.add(i)
            self.fired.append((global_step, ev.kind))
            self._record(global_step, ev.kind)
            if ev.kind == "nan_batch":
                x = self._poison(x, ev, np.nan)
            elif ev.kind == "grad_spike":
                x = self._scale(x, ev)
            elif ev.kind == "worker_failure":
                from distributed_deep_learning_tpu_torch.utils.failures import (
                    WorkerFailure)

                rank = int(ev.target) if ev.target is not None else 1
                raise WorkerFailure([rank])
            elif ev.kind == "stale_heartbeat":
                self.stale_heartbeat(str(ev.target),
                                     rank=1, age=ev.magnitude or 3600.0)
        return x, y

    def _poison(self, x, ev: ChaosEvent, value: float):
        """A copy of ``x`` with a seeded fraction set to ``value`` (>= 1
        site)."""
        xh = x.detach().cpu().numpy().copy()
        frac = ev.magnitude or 0.01
        flat = xh.reshape(-1)
        k = max(1, int(frac * flat.size))
        idx = self._rng(ev).choice(flat.size, size=k, replace=False)
        flat[idx] = value
        return torch.from_numpy(xh).to(x.device)

    def _scale(self, x, ev: ChaosEvent):
        factor = ev.magnitude or 1e6
        xh = x.detach().cpu().numpy() * factor
        return torch.from_numpy(xh.astype(xh.dtype)).to(x.device)

    # -- serve-side in-band hook (supervisor tick watchdog) ------------------
    def serve_hook(self, engine, report) -> None:
        """Apply every due serve fault at this tick; may raise.

        Called by :meth:`..serve.supervisor.ServeSupervisor._on_tick`
        with the engine and its :class:`..serve.engine.TickReport`,
        AFTER the tick's compute but before its tokens commit.  An
        event is due once ``report.tick`` reaches its ``step`` (prefill
        and decode share the counter); KV-poison kinds additionally wait
        for a live slot to poison.  One-shot like :meth:`batch_hook`: the
        supervisor's replay after containment must not re-inject the
        fault it is recovering from."""
        for i, ev in enumerate(self.events):
            if (i in self._done or ev.kind not in SERVE_KINDS
                    or ev.step > report.tick):
                continue
            if (ev.kind in ("nan_logits", "corrupt_block")
                    and not report.slots):
                continue  # defer until there is a live slot to poison
            self._done.add(i)
            self.fired.append((report.tick, ev.kind))
            self._record(report.tick, ev.kind)
            if ev.kind == "engine_crash":
                from distributed_deep_learning_tpu_torch.serve.supervisor \
                    import EngineCrash

                raise EngineCrash(
                    f"injected engine crash at tick {report.tick}")
            if ev.kind in ("stalled_tick", "slow_tick"):
                self.sleep(ev.magnitude
                           or (0.25 if ev.kind == "stalled_tick" else 0.02))
                continue
            slot = (int(ev.target) if ev.target is not None
                    else int(self._rng(ev).choice(sorted(report.slots))))
            self._poison_kv(engine, slot,
                            np.nan if ev.kind == "nan_logits" else np.inf,
                            first_block_only=ev.kind == "corrupt_block")

    @staticmethod
    @torch.no_grad()
    def _poison_kv(engine, slot: int, value: float,
                   first_block_only: bool = False) -> None:
        """Overwrite ``slot``'s committed KV with ``value`` in place — the
        serve analogue of :meth:`_poison`: the NEXT tick's attention over
        the poisoned window yields non-finite hidden states, which the
        device-computed finiteness flags surface to the watchdog.  Every
        floating cache tensor is poisoned (an int8 pool's scales)."""
        from distributed_deep_learning_tpu_torch.serve import paged, quant

        def floats(layer):
            for t in layer.values():
                for x in ((t.q, t.s) if quant.is_quant(t) else (t,)):
                    if x.dim() >= 2 and x.is_floating_point():
                        yield x

        mgr = getattr(engine, "manager", None)
        if mgr is not None:                      # PagedEngine: block pools
            blocks = [int(b) for b in mgr.tables[slot]
                      if int(b) != paged.TRASH]
            if first_block_only:
                blocks = blocks[:1]
            if not blocks:
                return
            idx = torch.as_tensor(blocks, device=engine.device)
            for layer in engine.pools:
                for x in floats(layer):
                    x[idx] = value
            return
        for layer in engine.slots["layers"]:     # ServeEngine: slot table
            for x in floats(layer):
                x[slot] = value

    # -- fleet-tier in-band hooks -------------------------------------------
    def fleet_hook(self, rid: int, report) -> float:
        """Apply every due fleet fault to replica ``rid`` at this tick.

        Called by the :class:`..serve.fleet.FleetRouter`'s per-replica
        tick observer.  ``target`` narrows an event to one replica id
        (None hits whichever replica ticks first).  ``replica_crash``
        raises :class:`..serve.fleet.ReplicaCrash` — the FATAL kind the
        replica's supervisor escalates instead of containing;
        ``replica_straggler`` returns extra virtual seconds
        (``magnitude``, default 1.0) the health tracker adds to the
        tick's wall time.  One-shot, recorded in ``fired``."""
        extra = 0.0
        for i, ev in enumerate(self.events):
            if (i in self._done
                    or ev.kind not in ("replica_crash",
                                       "replica_straggler")
                    or ev.step > report.tick):
                continue
            if ev.target is not None and int(ev.target) != int(rid):
                continue
            self._done.add(i)
            self.fired.append((report.tick, ev.kind))
            self._record(report.tick, ev.kind, replica=int(rid))
            if ev.kind == "replica_crash":
                from distributed_deep_learning_tpu_torch.serve.fleet import \
                    ReplicaCrash

                raise ReplicaCrash(
                    f"injected replica crash on replica {rid} at tick "
                    f"{report.tick}")
            extra += ev.magnitude or 1.0
        return extra

    def route_hook(self, seq: int) -> bool:
        """True while a ``router_flake`` window covers routing decision
        ``seq`` — the router must place WITHOUT its prefix-hit signal
        (health and queue depth only).  The window spans
        ``[step, step + magnitude)`` placements (width default 4);
        ``fired`` records the first placement it degrades."""
        flaky = False
        for i, ev in enumerate(self.events):
            if i in self._done or ev.kind != "router_flake":
                continue
            width = int(ev.magnitude) or 4
            if seq >= ev.step + width:
                self._done.add(i)          # window passed, stop scanning
                continue
            if seq >= ev.step:
                if (ev.step, ev.kind) not in self.fired:
                    self.fired.append((ev.step, ev.kind))
                    self._record(ev.step, ev.kind)
                flaky = True
        return flaky

    @staticmethod
    def _damage_largest_leaf(payload):
        """A copy of a payload (a list or dict of tensors) with its
        largest tensor's first element damaged: +1 for floating point,
        negated for bool, the low bit flipped for integers — a transfer
        corrupted in transit."""
        keys = list(payload) if isinstance(payload, dict) \
            else list(range(len(payload)))
        out = dict(payload) if isinstance(payload, dict) else list(payload)
        k = max(keys, key=lambda j: payload[j].numel())
        bad = payload[k].clone()
        flat = bad.view(-1)
        if bad.is_floating_point():
            flat[0] += 1
        elif bad.dtype == torch.bool:
            flat[0] = ~flat[0]
        else:
            flat[0] ^= 1
        out[k] = bad
        return out

    def _corruptor(self, kind: str):
        calls = {"n": 0}

        def corrupt(payload):
            calls["n"] += 1
            for i, ev in enumerate(self.events):
                if (i in self._done or ev.kind != kind
                        or ev.step > calls["n"]):
                    continue
                self._done.add(i)
                self.fired.append((calls["n"], ev.kind))
                self._record(calls["n"], ev.kind)
                payload = self._damage_largest_leaf(payload)
            return payload

        return corrupt

    def migrate_corruptor(self):
        """Payload->payload corruptor for ``migrate_drop`` events.

        Install on a :class:`..serve.engine.PagedEngine`'s
        ``_migrate_chaos`` seam (device-path preemption spill) or pass
        as :meth:`..serve.migrate.BlockMigrator.migrate`'s ``chaos=``.
        Counts the transfers flowing through it; when transfer number
        ``event.step`` passes, its largest leaf is damaged IN FLIGHT —
        after the sender's digest, before the receiver's recheck.  The
        recheck then raises ``MigrationError`` and the supervisor's
        ledger replay recovers.  One-shot per event."""
        return self._corruptor("migrate_drop")

    def evac_corruptor(self):
        """Payload->payload corruptor for ``evac_drop`` events — the
        evacuation analogue of :meth:`migrate_corruptor`: the n-th
        evacuation transfer is damaged in flight, the digest recheck
        raises ``MigrationError`` BEFORE anything scatters, the
        destination rolls its adopted blocks back (``unadopt``), and the
        request replays from the ledger with zero loss."""
        return self._corruptor("evac_drop")

    def evac_crash_hook(self, seq: int) -> bool:
        """True when a ``target_crash_mid_evac`` event is due at
        evacuation attempt ``seq`` — the router treats the evacuation
        TARGET as crashed mid-transfer (quarantine + warm reset) and
        aborts the move; the source keeps its blocks and the request
        replays from the ledger.  One-shot per event."""
        for i, ev in enumerate(self.events):
            if (i in self._done or ev.kind != "target_crash_mid_evac"
                    or ev.step > seq):
                continue
            self._done.add(i)
            self.fired.append((seq, ev.kind))
            self._record(seq, ev.kind)
            return True
        return False

    def scale_hook(self, round_no: int):
        """The ``scale_thrash`` window: over rounds
        ``[step, step + magnitude)`` (width default 4) the autoscaler's
        measured signals are replaced with an oscillation — saturated
        ("hot") on even offsets, idle ("cold") on odd.  Returns
        ``"hot"``/``"cold"``/None; ``fired`` records the first round it
        distorts."""
        for i, ev in enumerate(self.events):
            if i in self._done or ev.kind != "scale_thrash":
                continue
            width = int(ev.magnitude) or 4
            if round_no >= ev.step + width:
                self._done.add(i)      # window passed, stop scanning
                continue
            if round_no >= ev.step:
                if (ev.step, ev.kind) not in self.fired:
                    self.fired.append((ev.step, ev.kind))
                    self._record(ev.step, ev.kind)
                return ("hot" if (round_no - ev.step) % 2 == 0
                        else "cold")
        return None

    # -- out-of-band injectors ---------------------------------------------
    @staticmethod
    def _step_files(ckpt_dir: str, step: int) -> list[str]:
        """The files of ``step``'s checkpoint, largest first: the one
        ``ckpt-<step>.pt`` of :class:`..checkpoint.Checkpointer` (where
        the JAX package's orbax step is a directory of files)."""
        path = os.path.join(ckpt_dir, f"ckpt-{step}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint file for step {step} in {ckpt_dir}")
        return [path]

    @classmethod
    def truncate_checkpoint(cls, ckpt_dir: str, step: int,
                            keep_fraction: float = 0.5) -> str:
        """The torn-write drill: cut the step's largest file short."""
        target = cls._step_files(ckpt_dir, step)[0]
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(1, int(size * keep_fraction)))
        return target

    @classmethod
    def bitflip_checkpoint(cls, ckpt_dir: str, step: int,
                           seed: int = 0) -> str:
        """The silent-corruption drill: flip one seeded bit in the step's
        largest file (size unchanged — only checksums can catch it)."""
        target = cls._step_files(ckpt_dir, step)[0]
        size = os.path.getsize(target)
        rng = np.random.default_rng((seed, step))
        offset = int(rng.integers(0, size))
        bit = int(rng.integers(0, 8))
        with open(target, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)[0]
            f.seek(offset)
            f.write(bytes([byte ^ (1 << bit)]))
        return target

    @staticmethod
    def bitflip_file(path: str, seed: int = 0) -> str:
        """Flip one seeded bit in an arbitrary file (the published-
        weights analogue of :meth:`bitflip_checkpoint` — size unchanged,
        only the integrity manifest's checksums can catch it)."""
        size = os.path.getsize(path)
        rng = np.random.default_rng((seed, size))
        offset = int(rng.integers(0, size))
        bit = int(rng.integers(0, 8))
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)[0]
            f.seek(offset)
            f.write(bytes([byte ^ (1 << bit)]))
        return path

    @staticmethod
    def stale_heartbeat(hb_dir: str, rank: int, age: float = 3600.0) -> None:
        """Age `rank`'s beat file `age` seconds into the past (mtime — the
        clock :func:`..utils.failures.detect_failures` actually reads)."""
        from distributed_deep_learning_tpu_torch.utils.failures import _hb_path

        path = _hb_path(hb_dir, rank)
        past = time.time() - age
        os.utime(path, (past, past))

    @staticmethod
    def flaky_io(monitor, failures: int,
                 exc: type = OSError) -> None:
        """Make `monitor.check` raise `exc` for the next `failures` calls,
        then behave normally — the transient shared-FS drill for the
        monitor's I/O tolerance."""
        real, left = monitor.check, {"n": failures}

        def check():
            if left["n"] > 0:
                left["n"] -= 1
                raise exc("injected transient shared-FS error")
            return real()

        monitor.check = check

    @staticmethod
    def shrink_topology(devices, kill: int = 2,
                        seed: int = 0) -> tuple[list, list[int]]:
        """The pod-shrink drill: seed-pick `kill` devices (ranks) to
        "lose" and return ``(survivors, dead_indices)``.

        Like every injector here it is a pure function of its seed —
        ``(seed, n_devices, kill)`` keys the rng, as in the JAX package —
        so a drill replays bit-identically: same seed, same dead workers,
        same surviving mesh, same re-plan."""
        devices = list(devices)
        if not 0 < kill < len(devices):
            raise ValueError(
                f"shrink_topology: kill must be in (0, {len(devices)}), "
                f"got {kill}")
        rng = np.random.default_rng((seed, len(devices), kill))
        dead = set(rng.choice(len(devices), size=kill,
                              replace=False).tolist())
        survivors = [d for i, d in enumerate(devices) if i not in dead]
        return survivors, sorted(dead)


# ---------------------------------------------------------------------------
# The drill: the whole detect, contain and recover chain, timed
# ---------------------------------------------------------------------------

def run_resilience_drill(seed: int = 0, device: str = "cpu") -> dict:
    """Exercise the chain on a small MLP on ``device``; returns the
    ``resilience`` record (seconds of wall time), JAX's sections and
    keys:

    1. **sentinel**: a NaN batch under ``policy=skip``: the detection
       latency in steps, containment (the final parameters bit-identical
       to a run that never trained the batch), the contained count, and
       the sentinel's per-step overhead on this model;
    2. **integrity**: the latest of two saves truncated: the restore falls
       back to the older step and quarantines the bad one;
    3. **recovery**: an injected ``worker_failure`` in epoch 2 under
       ``fit_with_recovery``: the wall time from failure to a finished
       run over a clean run's, the restarts, and parity with the clean
       run's parameters."""
    import tempfile

    from distributed_deep_learning_tpu_torch.data.datasets import \
        synthetic_mqtt
    from distributed_deep_learning_tpu_torch.data.loader import make_loaders
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split
    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.train.elastic import \
        fit_with_recovery
    from distributed_deep_learning_tpu_torch.train.loop import fit
    from distributed_deep_learning_tpu_torch.train.objectives import \
        cross_entropy_loss
    from distributed_deep_learning_tpu_torch.train.sentinel import (
        SentinelConfig, attach_sentinel)
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer

    ds = synthetic_mqtt(1024, seed=21)
    splits = train_val_test_split(len(ds), seed=42)
    loaders = make_loaders(ds, splits, 64, device)
    cfg = SentinelConfig(policy="skip", warmup_steps=2)

    def make_state(sentinel=True):
        s = create_train_state(MLP(48, hidden_size=16), 7,
                               Optimizer("sgd", 0.05), device=device)
        return attach_sentinel(s) if sentinel else s

    def params_equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in
                   zip(a.model.state_dict().values(),
                       b.model.state_dict().values()))

    plain_step, eval_step = make_step_fns(cross_entropy_loss)
    sent_step, _ = make_step_fns(cross_entropy_loss, sentinel=cfg)
    record: dict = {}

    # --- 1. sentinel: detection latency, containment, overhead ----------
    inject_at = 5
    plan = ChaosPlan([ChaosEvent(step=inject_at, kind="nan_batch")],
                     seed=seed)
    state, _ = fit(make_state(), sent_step, eval_step, *loaders, epochs=1,
                   sentinel=cfg, chaos=plan)
    ref, _ = fit(make_state(), sent_step, eval_step, *loaders, epochs=1,
                 sentinel=cfg, skip_steps={inject_at})
    record["detection_latency_steps"] = 1   # the verdict is in the step
    record["containment_bit_identical"] = params_equal(state, ref)
    record["anomalies_contained"] = int(state.sentinel.anomalies)
    record["faults_fired"] = list(plan.fired)

    def step_time(step_fn, state, n=30):
        x, y = next(iter(loaders[0]))
        state, m = step_fn(state, x, y)           # warm
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step_fn(state, x, y)
        float(m["loss"])
        return (time.perf_counter() - t0) / n

    t_plain = step_time(plain_step, make_state(sentinel=False))
    t_sent = step_time(sent_step, make_state())
    record["sentinel_overhead_frac"] = round(max(0.0, t_sent / t_plain - 1),
                                             4)

    # --- 2. integrity: corrupt the latest, fall back and quarantine -----
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, shared=False)
        ck.save(1, state, wait=True)
        ck.save(2, state, wait=True)
        ChaosPlan.truncate_checkpoint(d, 2)
        t0 = time.perf_counter()
        _, used = ck.restore_verified(make_state())
        record["corrupt_restore_fallback_seconds"] = round(
            time.perf_counter() - t0, 3)
        record["corrupt_restore_fell_back"] = used == 1
        record["quarantined"] = sorted(os.listdir(
            os.path.join(d, "quarantine")))
        ck.close()

    # --- 3. recovery: a worker failure in epoch 2, elastic restart ------
    spe = len(loaders[0])
    fail_at = spe + 3                             # epoch 2, batch 3
    plan = ChaosPlan([ChaosEvent(step=fail_at, kind="worker_failure")],
                     seed=seed)
    t0 = time.perf_counter()
    ref2, _ = fit(make_state(), sent_step, eval_step, *loaders, epochs=2,
                  sentinel=cfg)
    t_clean = time.perf_counter() - t0
    live = make_state()
    initial = [v.clone() for v in live.model.state_dict().values()]

    def fresh():
        with torch.no_grad():
            for v, s0 in zip(live.model.state_dict().values(), initial):
                v.copy_(s0)
        live.optimizer.state.clear()
        live.step = 0
        return attach_sentinel(live)

    with tempfile.TemporaryDirectory() as d:
        with Checkpointer(d, shared=False) as ck:
            t0 = time.perf_counter()
            rec_state, _ = fit_with_recovery(
                fresh, sent_step, eval_step, loaders, epochs=2,
                checkpointer=ck, sentinel=cfg, chaos=plan, max_restarts=2)
            t_chaos = time.perf_counter() - t0
    record["recovery_seconds"] = round(max(0.0, t_chaos - t_clean), 3)
    record["restarts_used"] = 1
    record["recovered_bit_identical"] = params_equal(rec_state, ref2)
    record["faults_fired"] += list(plan.fired)
    return record


# ---------------------------------------------------------------------------
# The serving drills: one supervised engine, a fleet, its rebalancing
# ---------------------------------------------------------------------------

#: the drills' model, the JAX drills' geometry
DRILL_MODEL = dict(vocab_size=128, num_layers=1, d_model=64, num_heads=2,
                   mlp_dim=128, max_len=96)


def _drill_model(seed, device, model):
    from distributed_deep_learning_tpu_torch.serve.bench import build_model

    return model if model is not None else build_model(seed, device,
                                                       **DRILL_MODEL)


def _same_results(out, ref) -> bool:
    return (set(out["results"]) == set(ref["results"]) and all(
        np.array_equal(out["results"][u], ref["results"][u])
        for u in ref["results"]))


def _fleet_trace(model, seed):
    from distributed_deep_learning_tpu_torch.serve.bench import \
        DEFAULT_PRIORITY_CLASSES
    from distributed_deep_learning_tpu_torch.serve.load import (LoadSpec,
                                                                make_load)

    spec = LoadSpec(n_requests=14, arrival="poisson", rate=2.0,
                    prompt_short=(4, 12), prompt_long=(16, 24),
                    long_frac=0.25, shared_prefix_len=16, shared_frac=0.5,
                    new_tokens=(6, 14), slo_ttft_ms=30000.0,
                    slo_e2e_ms=30000.0,
                    priority_classes=DEFAULT_PRIORITY_CLASSES)
    return make_load(spec, vocab_size=model.vocab_size, seed=seed)


def run_blackbox_drill(seed: int = 0, dump_path: str | None = None,
                       device: str = "cpu") -> dict:
    """Seeded chaos to a deterministic flight-recorder dump (JAX's
    drill): the resilience drill's sentinel section with a
    :class:`..obs.recorder.FlightRecorder` in sequence-only mode
    (``clock=None``) wired into the chaos plan and the train loop.  The
    planted ``nan_batch`` fires, the sentinel contains it and the
    containment trips the recorder, whose dump's bytes are the same on
    every run of a seed.  Returns the dump's path, its sha256, its trips
    and events, and what fired."""
    import hashlib
    import json
    import tempfile

    from distributed_deep_learning_tpu_torch.data.datasets import \
        synthetic_mqtt
    from distributed_deep_learning_tpu_torch.data.loader import make_loaders
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split
    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.obs import RunTelemetry
    from distributed_deep_learning_tpu_torch.obs.recorder import \
        FlightRecorder
    from distributed_deep_learning_tpu_torch.train.loop import fit
    from distributed_deep_learning_tpu_torch.train.objectives import \
        cross_entropy_loss
    from distributed_deep_learning_tpu_torch.train.sentinel import (
        SentinelConfig, attach_sentinel)
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns

    ds = synthetic_mqtt(1024, seed=21)
    splits = train_val_test_split(len(ds), seed=42)
    loaders = make_loaders(ds, splits, 64, device)
    cfg = SentinelConfig(policy="skip", warmup_steps=2)
    state = attach_sentinel(create_train_state(
        MLP(48, hidden_size=16), 7, Optimizer("sgd", 0.05), device=device))
    sent_step, eval_step = make_step_fns(cross_entropy_loss, sentinel=cfg)
    if dump_path is None:
        dump_path = os.path.join(tempfile.mkdtemp(prefix="blackbox_"),
                                 "blackbox.json")
    rec = FlightRecorder(clock=None)   # sequence-only: deterministic bytes
    rec.arm(dump_path)
    plan = ChaosPlan([ChaosEvent(step=5, kind="nan_batch")], seed=seed,
                     recorder=rec)
    telemetry = RunTelemetry(path=None, recorder=rec)
    fit(state, sent_step, eval_step, *loaders, epochs=1, sentinel=cfg,
        chaos=plan, telemetry=telemetry)
    telemetry.close()
    with open(dump_path, "rb") as f:
        raw = f.read()
    doc = json.loads(raw)
    return {
        "dump_path": dump_path,
        "dump_sha256": hashlib.sha256(raw).hexdigest(),
        "trips": doc["trips"],
        "events_captured": doc["captured"],
        "faults_fired": list(plan.fired),
    }


def run_serve_resilience_drill(seed: int = 0, device: str = "cpu",
                               model=None, clock=None) -> dict:
    """The serve-side self-healing chain end to end on one small
    :class:`..serve.engine.PagedEngine` (``model``, or the drill's seeded
    one, on ``device``); returns JAX's ``serve_resilience`` record.

    The engine survives the whole gauntlet — every scenario warm-restarts
    it (``reset()``) rather than rebuilding, so ``decode_captures``
    staying at 1 on the card is itself evidence that containment, weight
    swap and canary all reuse the captured tick.  Sections: **clean**
    (the supervised reference), **faults** (``engine_crash``,
    ``nan_logits``, ``corrupt_block``, ``stalled_tick`` mid-decode:
    detection ticks, recovery seconds, ``requests_lost == 0``, results
    equal to the reference), **slo** (``slow_tick`` bursts under a 400
    ms e2e SLO with admission control) and **swap** (publish identical
    weights → canary → PROMOTE; zeroed weights → canary → ROLLBACK;
    bit-flipped → manifest REJECT and quarantine, a torn publish
    invisible throughout).  ``clock`` (with a ``sleep``) replaces the
    wall clock of the supervisors and the stall kinds, so a test never
    sleeps."""
    import tempfile

    from distributed_deep_learning_tpu_torch.serve import reload as reload_mod
    from distributed_deep_learning_tpu_torch.serve.admission import (
        AdmissionController)
    from distributed_deep_learning_tpu_torch.serve.bench import (
        make_trace, paged_max_len)
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.serve.scheduler import Request
    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor

    model = _drill_model(seed, device, model)
    clk = {} if clock is None else {"clock": clock}
    sleep = time.sleep if clock is None else clock.sleep
    cap = paged_max_len(model.max_len, 8, False, 0)
    eng = PagedEngine(model, device=device, max_slots=4, max_len=cap,
                      kv_block_size=8, prefill_chunk=16)
    trace = make_trace(8, vocab_size=model.vocab_size, seed=seed,
                       prompt_lens=(4, 12), new_tokens=(6, 14))

    def supervised(chaos=None, **kw):
        sup = ServeSupervisor(eng, chaos=chaos, **clk, **kw)
        return sup.run(list(trace)), sup

    ref, _ = supervised()
    if ref["errors"] or len(ref["results"]) != len(trace):
        raise RuntimeError(f"reference run incomplete: "
                           f"{len(ref['results'])}/{len(trace)} results, "
                           f"errors {ref['errors']}")

    def identical(out):
        return _same_results(out, ref)

    record: dict = {
        "metric": ("serve self-healing: detection ticks / recovery "
                   "seconds / requests lost / SLO under faults"),
        "model": {k: getattr(model, k) for k in DRILL_MODEL},
        "requests": len(trace), "scenarios": {},
    }
    detect, recover = [], []
    lost_total = 0
    all_ok = True

    cases = {
        "engine_crash": ([ChaosEvent(step=5, kind="engine_crash")], {}),
        "nan_logits": ([ChaosEvent(step=5, kind="nan_logits")], {}),
        "corrupt_block": ([ChaosEvent(step=5, kind="corrupt_block")], {}),
        "stalled_tick": ([ChaosEvent(step=5, kind="stalled_tick",
                                     magnitude=0.3)],
                         dict(stall_timeout_s=0.1)),
    }
    for name, (events, sup_kw) in cases.items():
        plan = ChaosPlan(events, seed=seed, sleep=sleep)
        out, _ = supervised(chaos=plan, **sup_kw)
        st = out["stats"]
        fired_tick = plan.fired[0][0] if plan.fired else None
        fault = st["faults"][0] if st["faults"] else None
        det = (fault["tick"] - fired_tick
               if fault and fired_tick is not None
               and fault["tick"] is not None else None)
        same = identical(out)
        ok = (same and st["requests_lost"] == 0 and not out["errors"]
              and st["restarts"] == 1 and det is not None)
        record["scenarios"][name] = {
            "fired": list(plan.fired),
            "detection_ticks": det,
            "recovery_s": (round(fault["recovery_s"], 3)
                           if fault else None),
            "restarts": st["restarts"],
            "requests_lost": st["requests_lost"],
            "bit_identical": same,
            "passed": ok,
        }
        all_ok = all_ok and ok
        lost_total += st["requests_lost"]
        if det is not None:
            detect.append(det)
        if fault is not None:
            recover.append(fault["recovery_s"])

    slo_trace = [Request(r.uid, r.prompt, r.max_new_tokens,
                         arrival_tick=r.arrival_tick,
                         slo_ttft_ms=1000.0, slo_e2e_ms=400.0)
                 for r in trace]

    def slo_run(chaos=None):
        adm = AdmissionController(itl_p99_ms=30.0, max_queue_depth=32,
                                  patience=2, cool=4, **clk)
        sup = ServeSupervisor(eng, chaos=chaos, admission=adm, **clk)
        return sup.run(list(slo_trace))["stats"]

    clean = slo_run()
    slow = ChaosPlan([ChaosEvent(step=s, kind="slow_tick", magnitude=0.12)
                      for s in range(4, 8)], seed=seed, sleep=sleep)
    faulted = slo_run(slow)
    eng.chunks_per_tick = eng._base_chunks_per_tick  # undo degradation
    record["slo_attainment_clean"] = clean["engine"]["slo"][
        "slo_attainment"]
    record["slo_attainment_faulted"] = faulted["engine"]["slo"][
        "slo_attainment"]
    record["slo_degradation_level_changes"] = faulted["admission"][
        "level_changes"]
    lost_total += clean["requests_lost"] + faulted["requests_lost"]

    swap: dict = {}
    rm_kw = dict(canary_slots=2, canary_ticks=2, min_compare=4,
                 min_acceptance=0.7, max_drift_p99=2.0, **clk)
    consumed: set = set()

    def manager(d):
        rm = reload_mod.ReloadManager(d, **rm_kw)
        rm.watcher.seen |= consumed
        return rm

    host_params = {k: v.detach().cpu().clone()
                   for k, v in eng.params.items()}
    with tempfile.TemporaryDirectory() as d:
        reload_mod.publish_weights(d, 1, host_params)
        rm = manager(d)
        out, _ = supervised(reload=rm)
        consumed.add(1)
        swap["promote"] = {
            "swaps": rm.swaps, "rollbacks": rm.rollbacks,
            "bit_identical": identical(out),
            "passed": (rm.swaps == 1 and rm.rollbacks == 0
                       and identical(out)
                       and out["stats"]["requests_lost"] == 0),
        }

        bad = {k: torch.zeros_like(v) for k, v in host_params.items()}
        reload_mod.publish_weights(d, 2, bad)
        rm = manager(d)
        out, _ = supervised(reload=rm)
        consumed.add(2)
        swap["rollback"] = {
            "swaps": rm.swaps, "rollbacks": rm.rollbacks,
            "restarts": out["stats"]["restarts"],
            "requests_lost": out["stats"]["requests_lost"],
            "bit_identical": identical(out),
            "passed": (rm.swaps == 0 and rm.rollbacks == 1
                       and out["stats"]["restarts"] == 1
                       and identical(out)
                       and out["stats"]["requests_lost"] == 0),
        }
        recover.extend(f["recovery_s"] for f in out["stats"]["faults"])

        reload_mod.publish_weights(d, 3, host_params)
        ChaosPlan.bitflip_file(reload_mod._weights_path(d, 3), seed=seed)
        # a torn publish (payload, no manifest) must stay invisible
        np.savez(os.path.join(d, "weights-00000004.npz"),
                 leaf_00000=np.zeros(1))
        rm = manager(d)
        out, _ = supervised(reload=rm)
        consumed.add(3)
        qdir = os.path.join(d, "quarantine")
        quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) \
            else []
        swap["reject"] = {
            "rejected": rm.rejected, "swaps": rm.swaps,
            "bit_identical": identical(out),
            "torn_publish_invisible":
                reload_mod.latest_published(d) == 1,
            "quarantined": quarantined,
            "passed": (rm.rejected == 1 and rm.swaps == 0
                       and identical(out)
                       and reload_mod.latest_published(d) == 1
                       and any(n.startswith("weights-00000003")
                               for n in quarantined)),
        }
        final_stats = out["stats"]["engine"]

    all_ok = all_ok and all(s["passed"] for s in swap.values())
    record["swap"] = swap
    record["detection_ticks_max"] = max(detect) if detect else None
    record["recovery_seconds_max"] = (round(max(recover), 3)
                                      if recover else None)
    record["requests_lost_total"] = lost_total
    record["decode_captures"] = final_stats["decode_captures"]
    want_captures = 1 if eng.device.type == "cuda" else 0
    record["drill_passed"] = bool(
        all_ok and lost_total == 0
        and final_stats["decode_captures"] == want_captures
        and record["slo_attainment_clean"]
        >= record["slo_attainment_faulted"])
    return record


def run_fleet_resilience_drill(seed: int = 0, device: str = "cpu",
                               model=None) -> dict:
    """The FLEET tier end to end over three small paged replicas (on one
    ``device``, sharing ``model``'s weights); returns JAX's
    ``fleet_resilience`` record.  Sections: **clean** (the fleet
    reference), **replica_crash** (replica 1 killed mid-round:
    quarantined, its requests replayed on the survivors),
    **replica_straggler** (slow ticks push replica 2 to DEGRADED),
    **router_flake** (placements without the prefix-hit signal),
    **preemption** (a 2-slot engine under priority pressure: spilled and
    resumed outputs equal to uncontended runs, priority 0 never
    preempted) and **migrate_drop** (a device-path spill corrupted in
    flight: the digest trips, the ledger replays)."""
    from distributed_deep_learning_tpu_torch.serve.bench import paged_max_len
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.serve.fleet import (
        QUARANTINED, FleetRouter)
    from distributed_deep_learning_tpu_torch.serve.scheduler import Request
    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor

    model = _drill_model(seed, device, model)
    cap = paged_max_len(model.max_len, 8, False, 0)
    engines = [PagedEngine(model, device=device, max_slots=4, max_len=cap,
                           kv_block_size=8, prefill_chunk=16)
               for _ in range(3)]
    trace = _fleet_trace(model, seed)
    want_captures = 1 if engines[0].device.type == "cuda" else 0

    def fleet(chaos=None, **kw):
        return FleetRouter(engines, chaos=chaos, **kw)

    ref = fleet().run(list(trace))
    if ref["errors"] or ref["stats"]["requests_lost"]:
        raise RuntimeError(
            f"fleet reference run incomplete: errors {ref['errors']}, "
            f"lost {ref['stats']['lost_uids']}")

    def identical(out):
        return _same_results(out, ref)

    record: dict = {
        "metric": ("fleet self-healing: detection ticks / recovery "
                   "seconds / requests lost / SLO by priority under "
                   "replica faults"),
        "model": {k: getattr(model, k) for k in DRILL_MODEL},
        "replicas": 3, "requests": len(trace), "scenarios": {},
    }
    detect, recover = [], []
    lost_total = 0
    all_ok = True

    plan = ChaosPlan([ChaosEvent(step=3, kind="replica_crash", target=1)],
                     seed=seed)
    out = fleet(chaos=plan).run(list(trace))
    st = out["stats"]
    fired_tick = plan.fired[0][0] if plan.fired else None
    fault = st["faults"][0] if st["faults"] else None
    det = (fault["tick"] - fired_tick
           if fault and fired_tick is not None
           and fault["tick"] is not None else None)
    surviving = [v["decode_captures"]
                 for r, v in st["per_replica"].items() if r != 1]
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and st["health"][1] == QUARANTINED
          and det is not None
          and all(c == want_captures for c in surviving))
    record["scenarios"]["replica_crash"] = {
        "fired": list(plan.fired),
        "detection_ticks": det,
        "recovery_s": (round(fault["recovery_s"], 3) if fault else None),
        "health": dict(st["health"]),
        "rounds": st["rounds"],
        "requests_lost": st["requests_lost"],
        "decode_captures_surviving": surviving,
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]
    if det is not None:
        detect.append(det)
    if fault is not None and fault["recovery_s"] is not None:
        recover.append(fault["recovery_s"])

    plan = ChaosPlan([ChaosEvent(step=2, kind="replica_straggler",
                                 target=2, magnitude=5.0)], seed=seed)
    out = fleet(chaos=plan, slow_tick_s=1.0, degrade_after=1).run(
        list(trace))
    st = out["stats"]
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and st["health"][2] == "degraded"
          and bool(plan.fired))
    record["scenarios"]["replica_straggler"] = {
        "fired": list(plan.fired),
        "health": dict(st["health"]),
        "slow_ticks": st["per_replica"][2]["slow_ticks"],
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    plan = ChaosPlan([ChaosEvent(step=1, kind="router_flake",
                                 magnitude=6.0)], seed=seed)
    out = fleet(chaos=plan).run(list(trace))
    st = out["stats"]
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"]
          and st["routing"]["flake_degraded"] > 0)
    record["scenarios"]["router_flake"] = {
        "fired": list(plan.fired),
        "flake_degraded": st["routing"]["flake_degraded"],
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    preqs = preemption_requests(model.vocab_size, seed)
    pref = {}
    for r in preqs:
        solo = PagedEngine(model, device=device, max_slots=2, max_len=48,
                           kv_block_size=8, prefill_chunk=8)
        pref[r.uid] = solo.run([Request(uid=r.uid, prompt=r.prompt,
                                        max_new_tokens=r.max_new_tokens)
                                ])["results"][r.uid]
    peng = PagedEngine(model, device=device, max_slots=2, max_len=48,
                       kv_block_size=8, prefill_chunk=8, preempt=True)
    pout = peng.run(list(preqs), keep_timeline=True)
    ps = pout["stats"]["preempt"]
    preempted_uids = [u for ev in pout["timeline"] for u in ev["preempted"]]
    prio0 = {r.uid for r in preqs if r.priority == 0}
    pre_identical = all(
        pout["results"].get(u) is not None
        and np.array_equal(pout["results"][u], pref[u]) for u in pref)
    ok = (pre_identical and ps["preemptions"] > 0 and ps["resumes"] > 0
          and ps["still_spilled"] == 0 and not pout["errors"]
          and not (set(preempted_uids) & prio0)
          and pout["stats"]["decode_captures"] == want_captures)
    record["scenarios"]["preemption"] = {
        "preemptions": ps["preemptions"],
        "resumes": ps["resumes"],
        "still_spilled": ps["still_spilled"],
        "preempted_uids": preempted_uids,
        "priority0_preempted": sorted(set(preempted_uids) & prio0),
        "bit_identical": pre_identical,
        "decode_captures": pout["stats"]["decode_captures"],
        "passed": ok,
    }
    all_ok = all_ok and ok

    # the device-path spill parks KV in a tensor on the engine's own
    # device, so this scenario needs no second device
    plan = ChaosPlan([ChaosEvent(step=1, kind="migrate_drop")], seed=seed)
    meng = PagedEngine(model, device=device, max_slots=2, max_len=48,
                       kv_block_size=8, prefill_chunk=8, preempt=True,
                       migrate="device")
    meng._migrate_chaos = plan.migrate_corruptor()
    sup = ServeSupervisor(meng, retries=2)
    mout = sup.run(list(preqs))
    ms = mout["stats"]
    m_identical = all(
        mout["results"].get(u) is not None
        and np.array_equal(mout["results"][u], pref[u]) for u in pref)
    fault_kinds = [f.get("kind") for f in ms["faults"]]
    ok = (m_identical and bool(plan.fired)
          and ms["requests_lost"] == 0 and not mout["errors"]
          and "MigrationError" in fault_kinds
          and meng._tick.captures == want_captures)
    record["scenarios"]["migrate_drop"] = {
        "fired": list(plan.fired),
        "faults": fault_kinds,
        "restarts": ms["restarts"],
        "requests_lost": ms["requests_lost"],
        "spill_path": ms["engine"]["preempt"]["spill_path"],
        "migration_moves": ms["engine"]["preempt"]["migration_moves"],
        "bit_identical": m_identical,
        "decode_captures": meng._tick.captures,
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += ms["requests_lost"]

    record["detection_ticks_max"] = max(detect) if detect else None
    record["recovery_seconds_max"] = (round(max(recover), 3)
                                      if recover else None)
    record["requests_lost_total"] = lost_total
    record["decode_captures"] = max(
        v["decode_captures"] for v in ref["stats"]["per_replica"].values())
    record["slo_attainment"] = ref["stats"]["slo"]["slo_attainment"]
    record["slo_by_priority"] = {
        p: s["slo_attainment"]
        for p, s in ref["stats"]["slo"].get("by_priority", {}).items()}
    record["drill_passed"] = bool(
        all_ok and lost_total == 0
        and record["decode_captures"] == want_captures)
    return record


def preemption_requests(vocab_size: int, seed: int = 0) -> list:
    """The fleet drill's priority-pressure trace: two priority-2 requests
    at tick 0, then a priority-0 and a priority-1 arrival at tick 2 on a
    2-slot engine (the JAX drill's, from the same seeded generator)."""
    from distributed_deep_learning_tpu_torch.serve.scheduler import Request

    rng = np.random.default_rng((seed, 99))

    def preq(uid, prio, arr):
        return Request(
            uid=uid,
            prompt=rng.integers(1, vocab_size, size=8).astype(np.int64),
            max_new_tokens=10, arrival_tick=arr, priority=prio)

    return [preq(0, 2, 0), preq(1, 2, 0), preq(2, 0, 2), preq(3, 1, 2)]


def run_rebalance_drill(seed: int = 0, device: str = "cpu",
                        model=None, disagg_devices=None) -> dict:
    """Live fleet REBALANCING end to end; returns JAX's
    ``fleet_rebalance`` record.  Sections, each against a clean fleet
    reference on the same trace: **evacuation (f32)** and **(int8)**
    (a straggler degrades with ``evacuate_on="degraded"``: its open
    slots' committed KV migrates digest-verified to peers, at rest and
    exact), **evac_drop** (the first evacuation payload corrupted: the
    digest trips before any scatter, the destination rolls back),
    **target_crash_mid_evac** (the target dies mid-move: quarantined,
    aborted, replayed), **autoscaler drain** (grow by one, shrink back
    through the drain protocol) and **scale_thrash** (an oscillating
    signal the hysteresis must damp).  **pool elasticity** runs, as in
    JAX, given at least three ``disagg_devices`` (a device may repeat:
    ``[device] * 3`` puts every pool on one card): a disaggregated engine
    (one prefill, two decode workers) serves the trace, the pool
    rebalancer judges its ``prefill_util``, ``reassign`` moves a worker,
    and the reset engine serves the trace again, token for token as the
    unified engine; without them it is recorded as skipped, as JAX's is
    on fewer than three devices."""
    from distributed_deep_learning_tpu_torch.serve.autoscaler import (
        FleetAutoscaler)
    from distributed_deep_learning_tpu_torch.serve.bench import paged_max_len
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.serve.fleet import (
        DEGRADED, RETIRED, FleetRouter)

    model = _drill_model(seed, device, model)
    cap = paged_max_len(model.max_len, 8, False, 0)

    def engine(**kw):
        return PagedEngine(model, device=device, max_slots=4, max_len=cap,
                           kv_block_size=8, prefill_chunk=16, **kw)

    engines = [engine() for _ in range(3)]
    trace = _fleet_trace(model, seed)
    want_captures = 1 if engines[0].device.type == "cuda" else 0

    def fleet(chaos=None, **kw):
        return FleetRouter(engines, chaos=chaos, **kw)

    ref = fleet().run(list(trace))
    if ref["errors"] or ref["stats"]["requests_lost"]:
        raise RuntimeError(
            f"rebalance reference run incomplete: errors "
            f"{ref['errors']}, lost {ref['stats']['lost_uids']}")

    def identical(out, vs=None):
        return _same_results(out, ref if vs is None else vs)

    record: dict = {
        "metric": ("live rebalancing: evacuation bit-identity / "
                   "rollback on corrupted payload / drain-protocol "
                   "scale-down / thrash-damped autoscaling"),
        "model": {k: getattr(model, k) for k in DRILL_MODEL},
        "replicas": 3, "requests": len(trace), "scenarios": {},
    }
    all_ok = True
    lost_total = 0
    evac_seconds = []

    def strag_plan(extra=(), target=2):
        return ChaosPlan(
            [ChaosEvent(step=2, kind="replica_straggler", target=target,
                        magnitude=5.0), *extra], seed=seed)

    evac_kw = dict(slow_tick_s=1.0, degrade_after=1,
                   evacuate_on="degraded")

    plan = strag_plan()
    out = fleet(chaos=plan, **evac_kw).run(list(trace))
    st = out["stats"]
    rb = st["rebalance"]
    surviving = [v["decode_captures"]
                 for r, v in st["per_replica"].items() if r != 2]
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and bool(plan.fired)
          and st["health"][2] == DEGRADED
          and rb["evacuations"] >= 1 and rb["evacuated_tokens"] > 0
          and rb["rolled_back"] == 0
          and all(c == want_captures for c in surviving))
    record["scenarios"]["evacuation_fp32"] = {
        "fired": list(plan.fired),
        "health": dict(st["health"]),
        "evacuations": rb["evacuations"],
        "evacuated_slots": rb["evacuated_slots"],
        "evacuated_blocks": rb["evacuated_blocks"],
        "evacuated_tokens": rb["evacuated_tokens"],
        "evac_seconds": round(rb["evac_seconds"], 4),
        "requests_lost": st["requests_lost"],
        "decode_captures_surviving": surviving,
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]
    if rb["evacuations"]:
        evac_seconds.append(rb["evac_seconds"] / rb["evacuations"])

    # int8 KV changes the numerics, so this scenario carries its OWN
    # quantized reference: drained == uncontended over the same pools
    engines8 = [engine(kv_dtype="int8") for _ in range(3)]
    ref8 = FleetRouter(engines8).run(list(trace))
    if ref8["errors"] or ref8["stats"]["requests_lost"]:
        raise RuntimeError("int8 reference run incomplete")
    plan = strag_plan()
    out = FleetRouter(engines8, chaos=plan, **evac_kw).run(list(trace))
    st = out["stats"]
    rb = st["rebalance"]
    ok = (identical(out, ref8) and st["requests_lost"] == 0
          and not out["errors"] and bool(plan.fired)
          and rb["evacuations"] >= 1 and rb["evacuated_tokens"] > 0
          and rb["rolled_back"] == 0)
    record["scenarios"]["evacuation_int8"] = {
        "fired": list(plan.fired),
        "evacuations": rb["evacuations"],
        "evacuated_tokens": rb["evacuated_tokens"],
        "evac_seconds": round(rb["evac_seconds"], 4),
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out, ref8),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]
    if rb["evacuations"]:
        evac_seconds.append(rb["evac_seconds"] / rb["evacuations"])
    del engines8

    plan = strag_plan([ChaosEvent(step=1, kind="evac_drop")], target=None)
    out = fleet(chaos=plan, **evac_kw).run(list(trace))
    st = out["stats"]
    rb = st["rebalance"]
    drop_fired = any(k == "evac_drop" for _, k in plan.fired)
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and drop_fired and rb["rolled_back"] >= 1)
    record["scenarios"]["evac_drop"] = {
        "fired": list(plan.fired),
        "evacuations": rb["evacuations"],
        "rolled_back": rb["rolled_back"],
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    plan = strag_plan([ChaosEvent(step=1, kind="target_crash_mid_evac")],
                      target=None)
    out = fleet(chaos=plan, **evac_kw).run(list(trace))
    st = out["stats"]
    rb = st["rebalance"]
    crash_fired = any(k == "target_crash_mid_evac" for _, k in plan.fired)
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and crash_fired and rb["aborted"] >= 1)
    record["scenarios"]["target_crash_mid_evac"] = {
        "fired": list(plan.fired),
        "evacuations": rb["evacuations"],
        "aborted": rb["aborted"],
        "health": dict(st["health"]),
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    # min_replicas=3 clamps any further shrink the run's own idle
    # round-ends would otherwise trigger — exactly 2 scale events
    auto = FleetAutoscaler(min_replicas=3, max_replicas=4, patience=2,
                           cool=2)
    rt = fleet(autoscaler=auto, engine_factory=engine)
    for _ in range(2):
        rt._autoscale_round(override="hot")     # patience -> grow
    grew_to = sum(1 for r in rt.replicas if r.health != RETIRED)
    t0 = time.perf_counter()
    for _ in range(2):
        rt._autoscale_round(override="cold")    # cool -> drain shrink
    drain_s = time.perf_counter() - t0
    shrunk_to = sum(1 for r in rt.replicas if r.health != RETIRED)
    out = rt.run(list(trace))
    st = out["stats"]
    live_captures = [v["decode_captures"]
                     for r, v in st["per_replica"].items()
                     if st["health"][r] != RETIRED]
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and grew_to == 4 and shrunk_to == 3
          and st["autoscaler"]["scale_events"] == 2
          and st["autoscaler"]["replicas_retired"] == 1
          and all(c == want_captures for c in live_captures))
    record["scenarios"]["autoscaler_drain"] = {
        "grew_to": grew_to,
        "shrunk_to": shrunk_to,
        "scale_events": st["autoscaler"]["scale_events"],
        "replicas_retired": st["autoscaler"]["replicas_retired"],
        "drain_seconds": round(drain_s, 4),
        "requests_lost": st["requests_lost"],
        "decode_captures_live": live_captures,
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    # a window wide enough (16 rounds) to cover the run's round-ends AND
    # the control rounds driven after it: every round sees the
    # alternating hot/cold signal, which never accumulates patience
    plan = ChaosPlan([ChaosEvent(step=1, kind="scale_thrash",
                                 magnitude=16.0)], seed=seed)
    auto = FleetAutoscaler(min_replicas=2, max_replicas=4, patience=2,
                           cool=2)
    rt = fleet(chaos=plan, autoscaler=auto, engine_factory=engine)
    out = rt.run(list(trace))
    for _ in range(8):
        rt._autoscale_round()
    st = out["stats"]
    thrash_fired = any(k == "scale_thrash" for _, k in plan.fired)
    scale_events = len(auto.events)
    ok = (identical(out) and st["requests_lost"] == 0
          and not out["errors"] and thrash_fired and scale_events <= 1)
    record["scenarios"]["scale_thrash"] = {
        "fired": list(plan.fired),
        "control_ticks": rt._scale_ticks,
        "scale_events": scale_events,
        "requests_lost": st["requests_lost"],
        "bit_identical": identical(out),
        "passed": ok,
    }
    all_ok = all_ok and ok
    lost_total += st["requests_lost"]

    if disagg_devices is not None and len(disagg_devices) >= 3:
        ok, record["scenarios"]["pool_elasticity"] = _pool_elasticity(
            model, trace, cap, engine, disagg_devices, want_captures)
        all_ok = all_ok and ok
    else:
        record["scenarios"]["pool_elasticity"] = {
            "skipped": "needs >= 3 local devices for a reassignable "
                       "worker (pass disagg_devices)",
            "passed": True,
        }
    record["requests_lost_total"] = lost_total
    record["evac_ms_mean"] = (round(1e3 * sum(evac_seconds)
                                    / len(evac_seconds), 3)
                              if evac_seconds else None)
    record["scale_events_total"] = sum(
        s.get("scale_events", 0) for s in record["scenarios"].values()
        if isinstance(s, dict))
    record["drill_passed"] = bool(all_ok and lost_total == 0)
    return record


def _pool_elasticity(model, trace, cap, engine, devices, want_captures):
    """The rebalance drill's pool-elasticity section (JAX's section 7):
    ``(passed, record)``."""
    from distributed_deep_learning_tpu_torch.serve.autoscaler import \
        PoolRebalancer
    from distributed_deep_learning_tpu_torch.serve.disagg import \
        DisaggEngine

    uref = engine().run(list(trace))
    deng = DisaggEngine(model, prefill_workers=1, decode_workers=2,
                        prefill_streams=4, max_slots=4, max_len=cap,
                        kv_block_size=8, prefill_chunk=16,
                        devices=list(devices)[:3])
    d1 = deng.run(list(trace))
    bal = PoolRebalancer(hi=0.9, lo=0.25, patience=2)
    direction = None
    for _ in range(2):          # sustained skew, not a single sample
        direction = bal.observe(d1["stats"]["prefill_util"])
    moved = deng.reassign(direction) if direction else False
    deng.reset()
    d2 = deng.run(list(trace))
    agree = _same_results(d2, uref)
    ok = (agree and not d2["errors"]
          and d2["stats"]["decode_captures"] == want_captures)
    return ok, {
        "prefill_util": round(d1["stats"]["prefill_util"], 4),
        "direction": direction,
        "reassigned": bool(moved),
        "pool_reassignments": d2["stats"]["pool_reassignments"],
        "prefill_workers": d2["stats"]["prefill_workers"],
        "decode_workers": d2["stats"]["decode_workers"],
        "bit_identical": agree,
        "decode_captures": d2["stats"]["decode_captures"],
        "passed": ok,
    }
