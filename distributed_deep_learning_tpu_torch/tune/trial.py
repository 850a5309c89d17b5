"""OOM-safe measured trials: one plan → (build, first step, time N steps).
The port of ``distributed_deep_learning_tpu/tune/trial.py``.

A trial builds the REAL training step for its plan with the builders the
runner uses (:func:`..workloads.base.train_setup`: the same model, the
same sharding decision, the same step functions), so the measured
steps/sec is the number training will see.  The step's first call is its
``compile_seconds``: the kernels' first builds and the caching
allocator's first blocks, the counterpart of JAX's ahead-of-time compile.
That call is measured by the allocator (``utils.profiling.
memory_analysis``: the bytes the step held at its peak), a second is
counted by the FLOP counter (``utils.profiling.cost_analysis``), then the
steps are timed with the sync-honest :class:`..utils.profiling.StepTimer`.

Failure containment is the point: a candidate that exhausts the card's
memory raises ``torch.cuda.OutOfMemoryError``; the trial records the plan
as infeasible instead of killing the search, drops the exception (its
traceback holds the trial's frames, and they its tensors), frees the
trial's model, optimizer and DDP and empties the allocator's cache, so
the next trial starts where this one did.

Under ``-m data`` every rank runs the same trials in lockstep (a trial is
a collective step): after the hook, the build, the first step and the
timed steps the ranks exchange their verdicts, so a plan that failed on
one rank is infeasible on all, with the lowest failing rank's error; the
rates are rank 0's, broadcast, so every rank takes the same decisions.  A
rank must not fail while the others wait for it in a collective, so the
verdicts are exchanged before the state's first collective (once each
rank's model and optimizer are on its device, before the DDP wrap
broadcasts the parameters), and over several ranks the first step is a
rank-local one (:func:`rank_local`: no gradient all-reduce, no global
statistics, ZeRO-1's update without its broadcast) before any synced
step.  A plan whose forward gathers its parameters (``--zero fsdp``,
``--comm``) has no rank-local step: its first step is its own.  A
trial's process groups (its ``DeviceMesh``) are destroyed with it.
Tests inject fakes through ``oom_hook``; ``measure`` swaps the timing
loop for a deterministic stand-in so search-logic tests build nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

# is_oom_error's home is obs.memory (the postmortem path needs it without
# importing tune/); re-exported here as in the JAX package
from distributed_deep_learning_tpu_torch.obs.memory import is_oom_error  # noqa: F401
from distributed_deep_learning_tpu_torch.tune.space import Plan, apply_plan
from distributed_deep_learning_tpu_torch.utils import profiling

#: memory_analysis's fields, all missing on the CPU (no allocator ledger)
MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes")


@dataclasses.dataclass
class TrialResult:
    """Outcome of measuring one plan (or failing to).  ``step_calls``
    counts the train-step calls the trial made (not in the record)."""

    plan: Plan
    steps_per_sec: float = 0.0
    examples_per_sec: float = 0.0
    measured_steps: int = 0
    compile_seconds: float = 0.0
    infeasible: bool = False
    oom: bool = False
    error: str | None = None
    cost: dict = dataclasses.field(default_factory=dict)     # cost_analysis
    memory: dict = dataclasses.field(default_factory=dict)   # memory_analysis
    step_calls: int = 0

    def to_dict(self, *, deterministic_only: bool = False) -> dict[str, Any]:
        """JSON-able record; ``deterministic_only`` drops wall-clock
        fields so seeded searches with an injected measure compare
        bit-identical across runs."""
        d = {
            "plan": self.plan.to_dict(),
            "steps_per_sec": self.steps_per_sec,
            "examples_per_sec": self.examples_per_sec,
            "measured_steps": self.measured_steps,
            "infeasible": self.infeasible,
            "oom": self.oom,
            "error": self.error,
        }
        if not deterministic_only:
            d["compile_seconds"] = self.compile_seconds
            d["cost"] = self.cost
            d["memory"] = self.memory
        return d


def launched_devices(config) -> list[torch.device]:
    """The devices a search runs over: one entry a launched rank (world 1
    outside a process group), each this rank's own device."""
    from distributed_deep_learning_tpu_torch import resolve_device

    device = resolve_device(config.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    return [device] * world


def device_identity(devices) -> tuple[str, str]:
    """``(platform, device_kind)`` of ``devices[0]`` as the artifacts key
    them: ``("gpu", torch.cuda.get_device_name())`` on a card, the JAX
    package's ``("cpu", "cpu")`` on the CPU, ``("", "")`` for none."""
    if not devices:
        return "", ""
    device = torch.device(devices[0])
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return "cpu", "cpu"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def agree(error: str | None, oom: bool = False) -> tuple[str | None, bool]:
    """Every rank's verdict on one stage: the lowest failing rank's
    ``(error, oom)``, or ``(None, False)``; the same on every rank."""
    if _world() == 1:
        return error, oom
    verdicts: list = [None] * _world()
    dist.all_gather_object(verdicts, (error, oom))
    return next((v for v in verdicts if v[0] is not None), (None, False))


class _PeerFailed(Exception):
    """Another rank failed a stage, and the ranks have agreed on it."""

    def __init__(self, verdict):
        super().__init__(verdict[0])
        self.verdict = verdict


def _agreed() -> None:
    """Raise :class:`_PeerFailed` unless every rank got here."""
    verdict = agree(None)
    if verdict[0] is not None:
        raise _PeerFailed(verdict)


@contextlib.contextmanager
def rank_local(state):
    """``state`` with no collective of its own: BatchNorm statistics and
    MoE routing over this rank's rows, and ZeRO-1's optimizer swapped
    for its local one (its update of this rank's parameters, without
    their broadcast)."""
    from distributed_deep_learning_tpu_torch.models.densenet import BatchNorm
    from distributed_deep_learning_tpu_torch.models.moe import MoEMLP

    saved = [(state, "optimizer", getattr(state.optimizer, "optim",
                                          state.optimizer))]
    for mod in state.model.modules():
        if isinstance(mod, BatchNorm):
            saved.append((mod, "global_stats", False))
        elif isinstance(mod, MoEMLP):
            saved.append((mod, "group", None))
    before = [getattr(obj, name) for obj, name, _ in saved]
    try:
        for obj, name, value in saved:
            setattr(obj, name, value)
        yield state
    finally:
        for (obj, name, _), value in zip(saved, before):
            setattr(obj, name, value)


def from_rank0(value):
    """Rank 0's ``value`` on every rank."""
    if _world() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _groups() -> set:
    from torch.distributed.distributed_c10d import _world as c10d_world

    return set(c10d_world.pg_map) if dist.is_initialized() else set()


def _destroy_new_groups(before: set) -> None:
    """Destroy the process groups made since ``before`` (a trial's
    ``DeviceMesh`` and batch groups), the default group aside."""
    if not dist.is_initialized():
        return
    default = dist.group.WORLD
    for pg in _groups() - before:
        if pg is not default:
            dist.destroy_process_group(pg)


class TrialHarness:
    """Builds and times the real train step for each plan it is handed.

    The probe batch is deterministic (dataset rows ``[0, batch)``, each
    rank its part of them) and the whole harness is seeded through the
    config, so identical (plan, steps) requests run identical steps.
    ``oom_hook(plan)`` runs before any build — a test can raise a fake
    OOM there; ``measure(plan, steps) -> steps_per_sec`` replaces the
    build+timing path entirely for deterministic search-logic tests.
    ``recorder`` (a :class:`~..obs.recorder.FlightRecorder`) turns an
    OOM'd candidate into a postmortem naming the plan and the largest
    state tensors (from the model built on the ``meta`` device).
    """

    def __init__(self, spec, config, dataset, devices, *, warmup: int = 2,
                 oom_hook: Callable[[Plan], None] | None = None,
                 measure: Callable[[Plan, int], float] | None = None,
                 recorder=None):
        self.spec = spec
        self.config = config
        self.dataset = dataset
        self.devices = list(devices)
        self.warmup = warmup
        self.oom_hook = oom_hook
        self.measure = measure
        self.recorder = recorder

    def run(self, plan: Plan, steps: int) -> TrialResult:
        cfg = apply_plan(self.config, plan)
        result, failure = None, (None, False)
        try:
            if self.oom_hook is not None:
                self.oom_hook(plan)
            if self.measure is not None:
                sps = float(self.measure(plan, steps))
                result = TrialResult(plan, steps_per_sec=sps,
                                     examples_per_sec=sps * cfg.batch_size,
                                     measured_steps=steps)
        except Exception as err:  # a dead candidate must not kill the search
            failure = self._failure(cfg, plan, err)
        failure = agree(*failure)
        if failure[0] is None and result is None:
            result, failure = self._run_real(cfg, plan, steps)
        if failure[0] is not None:
            return TrialResult(plan, infeasible=True, oom=failure[1],
                               error=failure[0])
        rates = from_rank0((result.steps_per_sec, result.examples_per_sec))
        result.steps_per_sec, result.examples_per_sec = rates
        return result

    def _failure(self, cfg, plan: Plan, err: BaseException
                 ) -> tuple[str, bool]:
        oom = is_oom_error(err)
        if oom and self.recorder is not None:
            self._record_postmortem(cfg, plan, err)
        return f"{type(err).__name__}: {err}"[:500], oom

    def _record_postmortem(self, cfg, plan: Plan, err: BaseException) -> None:
        """Dump the OOM story into the flight recorder; the buffer names
        come from the model built on the ``meta`` device (exact, free and
        identical across runs)."""
        from distributed_deep_learning_tpu_torch.obs import memory as obs_memory

        top = []
        try:
            with torch.device("meta"):
                model = self.spec.build_model(cfg, self.dataset)
            top = obs_memory.top_leaves(model.state_dict(), n=10)
        except Exception:
            pass  # the postmortem must never out-crash the trial
        obs_memory.record_oom_postmortem(
            self.recorder, error=err, plan=plan.to_dict(),
            top_buffers=top, context="trial")

    def _stage(self, cfg, plan: Plan, fn) -> tuple[str | None, bool]:
        """``fn()`` on every rank, then their verdicts exchanged (unless
        ``fn`` exchanged them already, another rank having failed)."""
        try:
            fn()
            mine = (None, False)
        except _PeerFailed as err:
            return err.verdict
        except Exception as err:
            mine = self._failure(cfg, plan, err)
        return agree(*mine)

    def _run_real(self, cfg, plan: Plan, steps: int):
        """``(result, (None, False))`` or ``(None, (error, oom))``."""
        from distributed_deep_learning_tpu_torch.runtime import bootstrap
        from distributed_deep_learning_tpu_torch.train.step import \
            make_step_fns
        from distributed_deep_learning_tpu_torch.utils.logging import \
            PhaseLogger
        from distributed_deep_learning_tpu_torch.workloads import base

        if plan.n_devices != len(self.devices):
            return None, (f"ValueError: plan wants {plan.n_devices} "
                          f"devices, have {len(self.devices)}", False)
        # a trial trains nothing that outlives it
        cfg = cfg.replace(checkpoint_dir=None, resume=False, elastic=False,
                          heartbeat_dir=None, sentinel="off", obs=False,
                          profile_dir=None, metrics_file=None,
                          publish_weights=None, generate_tokens=0,
                          serve=False)
        env, created = bootstrap.initialize(cfg.device)
        before = _groups()
        kit: dict[str, Any] = {}
        out = TrialResult(plan)

        def build():
            state, train_step, _, loaders, _, _, _ = base.train_setup(
                self.spec, cfg, env, None, PhaseLogger(verbose=False),
                dataset=self.dataset, built=lambda state: _agreed())
            kit.update(state=state, step=train_step,
                       batch=loaders[0].local_batch(
                           np.arange(cfg.batch_size)))
            if _world() > 1 and cfg.zero != "fsdp" and cfg.comm == "none":
                kit["local"] = make_step_fns(
                    self.spec.build_loss(cfg), remat=cfg.remat,
                    remat_policy=cfg.remat_policy,
                    accum_steps=max(1, cfg.grad_accum))[0]

        def call(step="step"):
            out.step_calls += 1
            state, metrics = kit[step](kit["state"], *kit["batch"])
            return metrics

        def probe():
            # the first step: over several ranks a rank-local one, so
            # that a rank that runs out of memory strands no other
            if "local" not in kit:
                return call()
            with rank_local(kit["state"]):
                return call("local")

        def first():
            t0 = time.perf_counter()
            if env.device.type == "cuda":
                out.memory = profiling.memory_analysis(probe,
                                                       device=env.device)
            else:                    # no allocator ledger on the CPU
                probe()
                out.memory = {"memory_fields_missing": list(MEMORY_FIELDS)}
            out.compile_seconds = time.perf_counter() - t0

        def timed():
            out.cost = profiling.cost_analysis(call)
            timer = profiling.StepTimer(warmup=self.warmup)
            metrics = None
            for _ in range(self.warmup + steps):
                metrics = call()
                timer.tick(cfg.batch_size)
            summary = timer.summary(sync=metrics["loss"])
            out.steps_per_sec = summary["steps_per_sec"]
            out.examples_per_sec = summary["examples_per_sec"]
            out.measured_steps = timer.measured_steps

        try:
            failure = (None, False)
            for fn in (build, first, timed):
                failure = self._stage(cfg, plan, fn)
                if failure[0] is not None:
                    break
        finally:
            kit.clear()
            _destroy_new_groups(before)
            if created:
                bootstrap.shutdown()
            gc.collect()
            if env.device.type == "cuda":
                torch.cuda.empty_cache()
        return (None, failure) if failure[0] is not None else (out, failure)
