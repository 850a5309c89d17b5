"""Deterministic fault injection, the training half: the port of
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

:func:`run_resilience_drill` chains the whole detect, contain and recover
path on a small MLP and returns its record.  The serving, fleet and
topology faults of the JAX module are ``ROADMAP.md`` items 13-14.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

KINDS = ("nan_batch", "grad_spike", "worker_failure", "stale_heartbeat")
INJECTOR_KINDS = ("ckpt_truncate", "ckpt_bitflip", "fs_error")


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
        if self.kind not in KINDS:
            raise ValueError(f"chaos event kind {self.kind!r}: in-band "
                             f"kinds are {KINDS} (train; use the static "
                             f"injectors for {INJECTOR_KINDS})")
        if self.step < 1:
            raise ValueError(f"chaos event step must be >= 1, got "
                             f"{self.step}")


class ChaosPlan:
    """A seeded, replayable schedule of in-band faults.

    ``fired`` records every event that actually triggered as
    ``(global_step, kind)``: the evidence that the fault happened."""

    def __init__(self, events, seed: int = 0):
        self.events = sorted(events, key=lambda e: e.step)
        self.seed = int(seed)
        self.fired: list[tuple[int, str]] = []
        self._done: set[int] = set()  # indices of one-shot events consumed

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
