"""Shared workload runner: config → data → model → train.  The port of
``distributed_deep_learning_tpu/workloads/base.py``:

=============  ==========================================================
mode           execution
=============  ==========================================================
sequential     one device, the whole model
data           one process per rank, ``DistributedDataParallel``; with
               ``--mesh``/``--zero`` the state sharded over a
               ``DeviceMesh`` (:func:`derive_state_spec`)
model          the workload's layer list split into stages
               (:class:`StagedTrainer`), stage ``i`` on device ``i mod
               n``, activations moved at stage boundaries
pipeline       the same, in ``-p``-sized chunks; for ``transformer``,
               ``bert`` and ``gpt`` the pipelined LM instead
               (:func:`_run_spmd_pipelined`: a stacked trunk under the
               GPipe, 1F1B or interleaved schedule; one process walks
               every stage, or a launch of ``dp·S`` ranks runs a data x
               stage grid, one rank a stage, activations and their
               gradients sent at the stage boundaries)
=============  ==========================================================

``--elastic`` restarts a ``-m sequential|data|pipeline`` run from its last
verified checkpoint on a failure (:func:`_fit_elastic`), with heartbeats
under ``--heartbeat-dir``; ``--sentinel`` puts the anomaly sentinel into
the ``-m sequential|data`` step (:mod:`..train.sentinel`).

``-m data`` runs one process per rank (``--spawn``, or a launcher's
environment; :mod:`..runtime.bootstrap`), the model wrapped in
``DistributedDataParallel``; at world 1 it is one process on NCCL (gloo
with ``-d cpu``).  ``--no-sync`` is the reference's quirk Q1: each rank
trains its own 1/N shard with no gradient sync and rank 0's is logged.

``--mesh`` lays the ranks out over the axes ``data``, ``fsdp``,
``model`` and ``expert`` (:mod:`..runtime.mesh`).  A rank trains on the
rows of its coordinate on the batch axes ``(data, fsdp)`` and draws its
dropout masks from that coordinate's stream, so the ranks of one model or
expert group see the same rows and masks.  The state is sharded as the
JAX runner's ``derive_state_spec`` decides: tensor/expert parallelism
(:mod:`..parallel.tensor_parallel`), ZeRO-1 or FSDP
(:mod:`..parallel.zero`), or replicated.  Gradients are averaged over
the batch axes only: by ``DistributedDataParallel`` on their group
(tensor parallelism keeps every parameter a plain local tensor, which
DDP takes; the model group's collectives run inside the forward and
backward), or by FSDP itself.  ``--grad-compress`` hangs a
communication hook on that DDP (:mod:`..train.compress`); ``--zero fsdp
--comm`` replaces FSDP2 by the explicit collectives of
:class:`..parallel.collectives.ExplicitFSDP`.  Both take each rank's own
means, as JAX's ``shard_map`` steps do (:mod:`..train.step`).

The optimizers follow optax, not torch's defaults: see
:class:`..train.state.Optimizer`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import (
    shard_indices, train_val_test_split)
from distributed_deep_learning_tpu_torch.models.densenet import \
    global_batch_statistics
from distributed_deep_learning_tpu_torch.models.moe import global_routing
from distributed_deep_learning_tpu_torch.parallel.mpmd import MPMDPipeline
from distributed_deep_learning_tpu_torch.parallel.partition import \
    validate_assignment
from distributed_deep_learning_tpu_torch.parallel.staging import StagedModel
from distributed_deep_learning_tpu_torch.runtime import bootstrap
from distributed_deep_learning_tpu_torch.runtime.mesh import (
    MeshLayout, PipelineGrid, build_mesh, mesh_for_mode)
from distributed_deep_learning_tpu_torch.train import schedules
from distributed_deep_learning_tpu_torch.train.elastic import resume_point
from distributed_deep_learning_tpu_torch.train.loop import EpochResult, fit
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, TrainState, create_train_state)
from distributed_deep_learning_tpu_torch.train.objectives import \
    prediction_metrics
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.parallel.shards import (
    is_split, local, resharded)
from distributed_deep_learning_tpu_torch.utils.checkpoint import (
    Checkpointer, load_payload, state_payload, whole_state_dict)
from distributed_deep_learning_tpu_torch.utils.config import (
    Config, Mode)
from distributed_deep_learning_tpu_torch.utils import profiling
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What differs between workloads (the JAX spec's fields that the
    ported paths read).  ``pre_train_check(config, dataset)`` rejects a
    run before training; ``post_train(config, state, logger, dataset)``
    runs ``--generate``/``--serve`` after it.  ``double_softmax``: whether
    its head takes ``--double-softmax``.  The staged modes read
    ``build_layers(config, dataset)`` (the partitionable layer list),
    ``partitioner(n_layers, n_stages)`` and ``stage_input(config)`` (the
    input conversion stage 0 applies, or None); ``build_pipelined(config,
    dataset, n_stages)`` makes ``-m pipeline`` run the pipelined LM.
    ``decoder_options``: whether the model takes gpt's ``--pos rope``,
    ``--window`` and ``--kv-heads``; ``token_ce``: whether its loss takes
    ``--label-smoothing`` (the JAX runner refuses each elsewhere).
    ``tp_rules(config)``: the tensor/expert-parallel rules
    (``parallel.tensor_parallel``) that ``--mesh model|expert=K`` applies;
    None refuses those axes."""

    name: str
    build_dataset: Callable[[Config], Any]
    build_model: Callable[[Config, Any], nn.Module]
    build_loss: Callable[[Config], Callable]
    build_optimizer: Callable[[Config, int], Optimizer]
    build_layers: Optional[Callable[[Config, Any], list]] = None
    partitioner: Optional[Callable[[int, int], np.ndarray]] = None
    stage_input: Optional[Callable[[Config], Callable]] = None
    build_pipelined: Optional[Callable[[Config, Any, int], nn.Module]] = None
    pre_train_check: Optional[Callable[[Config, Any], None]] = None
    post_train: Optional[Callable[..., None]] = None
    double_softmax: bool = False
    decoder_options: bool = False
    token_ce: bool = False
    tp_rules: Optional[Callable[[Config], Any]] = None


def config_dtype(config: Config) -> torch.dtype:
    """The compute dtype ``--dtype`` selects."""
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def cast_input(config: Config):
    """Stage 0's input conversion for flat features: the compute dtype."""
    dtype = config_dtype(config)
    return lambda x: x.to(dtype)


def nchw_input(config: Config):
    """Stage 0's input conversion for NHWC images: the compute dtype and
    the channels-last NCHW view the conv layers take."""
    dtype = config_dtype(config)
    return lambda x: x.to(dtype).permute(0, 3, 1, 2)


def example_shape(dataset) -> tuple[int, ...]:
    """One example's feature shape (the input widths are data-driven,
    quirk Q6)."""
    x, _ = dataset.batch(np.arange(1))
    return tuple(x.shape[1:])


#: flax's DenseGeneral keeps the q/k/v biases as (heads, head_dim), so
#: optax's ``ndim >= 2`` mask decays them; torch's Linear biases are 1-D
#: (``self_attn`` and a decoder's ``cross_attn``)
_MATRIX_BIASES = ("_attn.q.bias", "_attn.k.bias", "_attn.v.bias")


def decay_mask(name: str, param) -> bool:
    """The AdamW and LAMB recipes' decay mask on the JAX parameter layout:
    matrices decay, biases and LayerNorm scales (vectors there) do not."""
    return param.ndim >= 2 or name.endswith(_MATRIX_BIASES)


def adamw(learning_rate, weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw`` with the bias/norm decay exemption applied."""
    return Optimizer("adamw", learning_rate, weight_decay=weight_decay,
                     decay_mask=decay_mask)


def build_optimizer(spec: WorkloadSpec, config: Config,
                    epoch_steps: int) -> Optimizer:
    """The workload's optimizer recipe, overridable by ``--optimizer``."""
    if config.optimizer == "auto":
        return spec.build_optimizer(config, epoch_steps)
    lr = resolve_lr(config, epoch_steps, config.learning_rate)
    if config.optimizer == "adamw":
        return adamw(lr)
    if config.optimizer == "lamb":
        # optax.lamb's decay defaults to 0.0; the JAX recipe passes the
        # canonical 1e-2 with the decay mask
        return Optimizer("lamb", lr, weight_decay=1e-2,
                         decay_mask=decay_mask)
    if config.optimizer in ("sgd", "momentum", "adam", "adafactor"):
        return Optimizer(config.optimizer, lr)
    raise ValueError(f"unknown --optimizer {config.optimizer!r}")


def resolve_lr(config: Config, epoch_steps: int, base_lr: float):
    """``--schedule``/``--warmup`` → a scalar LR or a schedule of the
    update count; default warmup when unset: 5% of the total steps."""
    if config.lr_schedule == "none":
        return base_lr
    total = max(2, config.epochs * max(1, epoch_steps))
    warm = config.warmup_steps if config.warmup_steps is not None \
        else max(1, total // 20)
    warm = min(warm, total - 1)
    if config.lr_schedule == "cosine":
        return schedules.warmup_cosine(base_lr, warm, total)
    if config.lr_schedule == "rsqrt":
        return schedules.warmup_rsqrt(config.size, warm)
    if config.lr_schedule == "step":
        return schedules.step_decay(base_lr,
                                    steps_per_drop=7 * max(1, epoch_steps))
    raise ValueError(f"unknown --schedule {config.lr_schedule!r}")


def _maybe_checkpointer(config: Config, rank: int, shared: bool,
                        mesh: dict | None = None,
                        replicated_generator: bool = False):
    """``(checkpointer, ckpt_step, start_epoch, resume_batch,
    resume_totals)`` from ``--checkpoint-dir``/``--resume``; a directory
    that holds checkpoints without ``--resume`` is refused (this run's
    saves would be skipped in favour of the old run's steps).  ``shared``:
    the ranks train one model and save it together; otherwise (quirk Q1)
    each rank keeps its own replica, rank r > 0 under ``rank-<r>/``.
    ``mesh``: the sizes of the mesh the state lies on; each checkpoint's
    manifest records the state's topology over it, and a restore checks
    it (:mod:`..reshard.manifest`).  ``--elastic`` is exempt from the
    dirty-directory refusal: resuming on a restart is its contract (it
    logs what it restored)."""
    if not config.checkpoint_dir:
        return None, None, 1, 0, None
    directory = config.checkpoint_dir if shared or rank == 0 \
        else os.path.join(config.checkpoint_dir, f"rank-{rank}")
    ckpt = Checkpointer(directory, shared=shared, mesh=mesh,
                        replicated_generator=replicated_generator,
                        publish_dir=config.publish_weights)
    if not config.resume:
        last = ckpt.latest_step()
        if not config.elastic and last is not None:
            raise ValueError(
                f"--checkpoint-dir {config.checkpoint_dir} already holds "
                f"checkpoints (latest step {last}): pass --resume to "
                "continue it, or point at a fresh directory")
        return ckpt, None, 1, 0, None
    return (ckpt, *resume_point(ckpt))


def _restore_resume(ckpt, state, ckpt_step, start_epoch, resume_batch,
                    resume_totals, logger, restore_fn=None, telemetry=None):
    """Verified restore for ``--resume``: a torn or corrupt step is
    quarantined and the newest good one restored, and the resume point is
    decoded again from the step actually restored.  ``restore_fn`` (same
    contract as ``restore_verified``) swaps in the resharding restore
    under ``--reshard``; with ``telemetry`` that case lands in the
    ``reshard`` span, a plain verified restore in ``recovery``."""
    restore = restore_fn or ckpt.restore_verified
    if telemetry is None:
        restored, used = restore(state, step=ckpt_step)
    else:
        kind = "reshard" if restore_fn is not None else "recovery"
        with telemetry.timeline.span(kind):
            restored, used = restore(state, step=ckpt_step)
    if used is None:
        logger.info("checkpoint integrity: no verifiable checkpoint "
                    "survives; starting fresh")
        return state, 1, 0, None
    if used != ckpt_step:
        logger.info(f"checkpoint integrity: step {ckpt_step} failed "
                    f"verification (quarantined); resuming from verified "
                    f"step {used}")
        _, start_epoch, resume_batch, resume_totals = \
            resume_point(ckpt, step=used)
    logger.info(f"resumed mid-epoch {start_epoch} at step {resume_batch}"
                if resume_batch else
                f"resumed from epoch {start_epoch - 1}")
    return restored, start_epoch, resume_batch, resume_totals


def _data_parallel_env(config: Config):
    """``-m data``'s process group: ``(env, created)``; a ``-r N > 1``
    run without its ranks raises, naming ``--spawn``."""
    env, created = bootstrap.initialize(config.device)
    if env.world == 1 and config.world_size > 1:
        if created:
            bootstrap.shutdown()
        raise ValueError(
            f"-r {config.world_size} needs {config.world_size} processes: "
            "add --spawn to start them here, or launch them with torchrun "
            "or mpirun (torch has no one-process multi-device DDP)")
    if env.world > 1 and config.world_size not in (1, env.world):
        if created:
            bootstrap.shutdown()
        raise ValueError(f"-r {config.world_size} but the launcher started "
                         f"{env.world} ranks")
    return env, created


def derive_state_spec(spec: WorkloadSpec, config: Config,
                      sizes: dict) -> str | None:
    """How ``-m data`` shards the state on a mesh of ``sizes`` (axis ->
    size), in the JAX runner's order and words: ``"tp"`` (the workload's
    ``tp_rules``) when there is a model or expert axis, else ``"zero1"``
    or ``"fsdp"`` for ``--zero``, else None (replicated)."""
    if sizes.get("model", 1) > 1 or sizes.get("expert", 1) > 1:
        if spec.tp_rules is None:
            raise ValueError(f"workload {spec.name!r} has no "
                             "tensor-parallel sharding rules")
        if config.zero != "none":
            raise ValueError("--zero with a model axis is not supported "
                             "yet; use fsdp_axis in the TP rules instead")
        return "tp"
    if config.zero != "none":
        return "zero1" if config.zero == "1" else "fsdp"
    return None


def check_step_flags(config: Config, sizes: dict) -> None:
    """The JAX runner's ``make_train_eval_steps`` refusals of ``--comm`` and
    ``--grad-compress``, in its order and words (``sizes``: the mesh)."""
    tp = sizes.get("model", 1) > 1 or sizes.get("expert", 1) > 1
    if config.comm != "none":
        if config.zero != "fsdp" or config.grad_accum > 1 \
                or config.grad_compress != "none" or tp:
            raise ValueError(
                "--comm quantizes the explicit FSDP collectives "
                "(parallel/collectives.py); it requires --zero fsdp and "
                "does not compose with --grad-accum/--grad-compress/"
                "--mesh model/expert axes")
    elif config.grad_compress != "none":
        if config.zero != "none" or config.grad_accum > 1 or tp:
            raise ValueError(
                "--grad-compress applies to the pure data-parallel "
                "gradient all-reduce; it does not compose with "
                "--zero/--grad-accum/--mesh model/expert axes (for "
                "compressed ZeRO/FSDP collectives use --comm bf16|int8, "
                "parallel/collectives.py)")


def attach_comm_residual(config: Config, state: TrainState,
                         named_params, batch_world: int) -> dict | None:
    """Zero-init the error-feedback residual on ``state`` when an int8
    path is active (``--comm int8``, ``--grad-compress int8``) and more
    than one batch rank exchanges gradients (JAX: one shard sends
    nothing)."""
    if config.comm != "int8" and config.grad_compress != "int8":
        return None
    if batch_world <= 1:
        return None
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        attach_residual

    return attach_residual(state, named_params)


def mesh_devices(shape: dict[str, int], devices):
    """The device prefix an explicit mesh shape occupies (a copy of the
    JAX runner's): the whole list under a -1 fill."""
    n = 1
    for s in shape.values():
        if s == -1:
            return devices
        n *= s
    return devices[:n] if n <= len(devices) else devices


def _mesh_refusals(config: Config, spmd_pipeline: bool = False) -> None:
    """What the JAX runner drops silently about ``--mesh``/``--zero``,
    refused: they take ``-m data`` with gradient sync, and no stage axis
    there.  ``spmd_pipeline``: the run is ``-m pipeline`` of a pipelined
    LM; under the staged MPMD path ``--zero`` alone is left to
    :func:`_mpmd_refusals`, which raises JAX's own message."""
    if not (config.mesh_shape or config.zero != "none"):
        return
    flags = " ".join(f for f, on in (("--mesh", config.mesh_shape),
                                     ("--zero", config.zero != "none"))
                     if on)
    if config.mode in (Mode.MODEL, Mode.PIPELINE):
        if spmd_pipeline:
            raise ValueError(
                f"{flags} under -m pipeline: the SPMD pipeline lays its "
                "ranks out as its own data x stage grid (--nstages and the "
                "rank count) and shards only the trunk's stage slices; the "
                f"JAX runner ignores {flags} there (use -m data to shard "
                "the state)")
        if config.mesh_shape:
            raise ValueError(
                f"--mesh under -m {config.mode.value}: the staged MPMD path "
                "places stage i on device i mod n and shards nothing; the "
                "JAX runner ignores --mesh there")
        return
    if config.mode is Mode.SEQUENTIAL:
        raise ValueError(f"{flags} shards a -m data run; -m sequential "
                         "runs one device (the JAX runner ignores it)")
    if not config.sync_in_local_data_mode:
        raise ValueError(f"{flags} with --no-sync: quirk Q1 trains "
                         "independent replicas, which share no state")
    if (config.mesh_shape or {}).get("stage", 1) != 1:
        raise ValueError("--mesh stage= under -m data: the data-parallel "
                         "step has no stages (the JAX runner leaves the "
                         "axis idle); use -m pipeline --nstages")


def _sentinel_config(config: Config):
    """``--sentinel`` -> a :class:`..train.sentinel.SentinelConfig` (or
    None), refused with the flags whose steps have no sentinel (JAX's
    message)."""
    if config.sentinel == "off":
        return None
    from distributed_deep_learning_tpu_torch.train.sentinel import \
        SentinelConfig

    unsupported = [(config.grad_accum > 1, "--grad-accum"),
                   (config.grad_compress != "none", "--grad-compress"),
                   (config.comm != "none", "--comm")]
    bad = [flag for cond, flag in unsupported if cond]
    if bad:
        raise ValueError(f"--sentinel does not compose with "
                         f"{', '.join(bad)} (those flags build their own "
                         "train step without the sentinel's in-step "
                         "containment)")
    return SentinelConfig(policy=config.sentinel,
                          window=config.sentinel_window,
                          spike_factor=config.sentinel_factor,
                          loss_spike_factor=config.sentinel_factor)


def _reset_fn(state: TrainState) -> Callable[[], TrainState]:
    """``--elastic``'s ``make_state``: a function that puts ``state``'s
    present (initial) values back into it, since the port's state is
    updated in place (JAX builds a fresh one): this rank's parameters and
    buffers, ``--comm``'s master shards, the generator, a fresh sentinel,
    a zero residual and an empty optimizer state (torch's optimizers make
    theirs at the first update).  The values wait in host memory (a
    restore is rare and off the step's path); a restore then overwrites
    them."""
    live = [*state.model.state_dict().values(),
            *getattr(state.comm, "masters", {}).values()]
    kept = [(t, local(t).detach().to("cpu", copy=True)) for t in live]
    gen = None if state.generator is None else state.generator.get_state()
    fresh_sentinel = state.sentinel is not None

    def make_state() -> TrainState:
        with torch.no_grad():
            for t, host in kept:
                local(t).copy_(host)
            for r in (state.comm_residual or {}).values():
                r.zero_()
        getattr(state.optimizer, "optim", state.optimizer).state.clear()
        state.step, state.fence = 0, None
        if gen is not None:
            state.generator.set_state(gen)
        if fresh_sentinel:
            from distributed_deep_learning_tpu_torch.train.sentinel import \
                attach_sentinel

            attach_sentinel(state)
        return state

    return make_state


def _fit_elastic(config: Config, logger, make_state, train_step, eval_step,
                 loaders, ckpt, sentinel=None, telemetry=None,
                 restore_fn=None):
    """``--elastic``: checkpointed restart on a failure
    (:func:`..train.elastic.fit_with_recovery`), with heartbeats and a
    failure monitor under ``--heartbeat-dir``, stopped in ``finally``."""
    from distributed_deep_learning_tpu_torch.train.elastic import \
        fit_with_recovery

    if ckpt is None:
        raise ValueError("--elastic requires --checkpoint-dir (recovery "
                         "restores from the epoch checkpoints)")
    hb = monitor = None
    if config.heartbeat_dir:
        import torch.distributed as dist

        from distributed_deep_learning_tpu_torch.utils.failures import (
            FailureMonitor, Heartbeat)

        rank = dist.get_rank() if dist.is_initialized() else 0
        world = dist.get_world_size() if dist.is_initialized() else 1
        hb = Heartbeat(config.heartbeat_dir, rank).start()
        monitor = FailureMonitor(
            config.heartbeat_dir, world,
            timeout=config.heartbeat_timeout, self_rank=rank).start()
    try:
        return fit_with_recovery(make_state, train_step, eval_step,
                                 loaders, epochs=config.epochs,
                                 checkpointer=ckpt, logger=logger,
                                 monitor=monitor,
                                 checkpoint_every=config.checkpoint_every,
                                 sentinel=sentinel, telemetry=telemetry,
                                 restore_fn=restore_fn)
    finally:
        if monitor is not None:
            monitor.stop()
        if hb is not None:
            hb.stop()
        ckpt.close()


def run_workload(spec: WorkloadSpec, config: Config, *,
                 init_state_dict: dict | None = None
                 ) -> tuple[TrainState, list[EpochResult]]:
    """Train ``spec`` under ``config``; returns (final state, phase
    history; on ``-m data`` each rank's own, rank 0 logging).
    ``init_state_dict`` replaces the seeded initialisation (the tests pass
    the JAX package's init through it)."""
    if (config.generate_tokens or config.serve) and spec.post_train is None:
        flag = "--generate" if config.generate_tokens else "--serve"
        raise ValueError(f"{flag} is not supported by workload "
                         f"{spec.name!r} (gpt only)")
    # the JAX runner's refusals, in its order and with its messages
    if config.pos_embedding != "learned" and not spec.decoder_options:
        raise ValueError(f"--pos {config.pos_embedding} is a gpt option; "
                         f"workload {spec.name!r} uses its own position "
                         "scheme")
    if config.attention_window is not None:
        if config.attention_window < 1:
            raise ValueError(f"--window must be >= 1, got "
                             f"{config.attention_window}")
        if not spec.decoder_options:
            raise ValueError(f"--window needs a causal decoder-only model; "
                             f"workload {spec.name!r} has bidirectional or "
                             "cross attention sites")
    if config.label_smoothing:
        if not 0.0 < config.label_smoothing < 1.0:
            raise ValueError(f"--label-smoothing must be in (0, 1), got "
                             f"{config.label_smoothing}")
        if not spec.token_ce:
            raise ValueError("--label-smoothing applies to the token-CE "
                             f"workloads (transformer/bert/moe/gpt), not "
                             f"{spec.name!r}")
    if config.num_kv_heads is not None:
        if config.num_kv_heads < 1:
            raise ValueError(f"--kv-heads must be >= 1, got "
                             f"{config.num_kv_heads}")
        if not spec.decoder_options:
            raise ValueError("--kv-heads (grouped-query attention) is a "
                             f"gpt option; workload {spec.name!r} models "
                             "define their own head layout")
    if config.grad_accum > 1 and config.remat:
        raise ValueError("--remat with --grad-accum is not implemented; "
                         "drop one of the two")
    if config.double_softmax and not spec.double_softmax:
        raise ValueError(f"--double-softmax is not supported by workload "
                         f"{spec.name!r} (mlp and cnn only)")
    if config.dtype == "float32":
        # f32 means f32: cuDNN's convolutions and LSTM take TF32 unless told
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    spmd = config.mode is Mode.PIPELINE and spec.build_pipelined is not None
    _mesh_refusals(config, spmd_pipeline=spmd)
    # a plan runs -m data (Plan.to_overrides pins the mode), so --autotune
    # and --plan runs take the data-parallel path whatever their -m
    planned = bool(config.autotune or config.plan_file)
    if config.mode in (Mode.MODEL, Mode.PIPELINE) and not planned:
        if spmd:
            return _run_spmd_pipelined(spec, config, init_state_dict)
        if config.world_size > 1 or bootstrap.env_topology()[1] > 1:
            raise ValueError(
                f"-m {config.mode.value} of {spec.name!r} is the staged MPMD "
                "path: one process places stage i on device i mod n, with "
                "no data axis (the JAX runner leaves the other processes' "
                "devices out of it); launch one process, or use -m "
                "pipeline with transformer/bert/gpt for a data x stage "
                "grid of ranks")
        return _run_staged(spec, config, init_state_dict)
    if config.mode is Mode.SEQUENTIAL and not planned:
        return _train(spec, config, bootstrap.DistEnv(
            device=resolve_device(config.device)), init_state_dict)
    env, created = _data_parallel_env(config)
    try:
        return _train(spec, config, env, init_state_dict)
    finally:
        if created:
            bootstrap.shutdown()


def build_dataset(spec: WorkloadSpec, config: Config):
    """The workload's dataset; ``--packed-cache`` replaces it with the
    memory-mapped :class:`..data.packed.PackedDataset`, whose header
    carries the geometry the model is sized from (classes, vocabulary,
    shapes).  The cache must have been packed from the same workload's
    dataset."""
    if config.packed_cache:
        from distributed_deep_learning_tpu_torch.data.packed import \
            PackedDataset

        return PackedDataset(config.packed_cache)
    return spec.build_dataset(config)


def _dataset_splits(spec, config, dataset=None):
    """The dataset (checked by ``pre_train_check``; built unless given)
    and its split."""
    if dataset is None:
        dataset = build_dataset(spec, config)
    if spec.pre_train_check is not None:
        spec.pre_train_check(config, dataset)
    # DDL_DATA_LIMIT caps the examples considered (CI / smoke runs)
    limit = int(os.environ.get("DDL_DATA_LIMIT", "0"))
    n = min(len(dataset), limit) if limit else len(dataset)
    return dataset, train_val_test_split(n, seed=config.seed)


def _optimizer(spec, config, splits) -> Optimizer:
    epoch_steps = max(1, len(splits.train) // config.batch_size)
    tx = build_optimizer(spec, config, epoch_steps)
    if config.clip_norm:
        tx = dataclasses.replace(tx, clip_norm=config.clip_norm)
    return tx


def _mesh_layout(config: Config, env) -> MeshLayout:
    """This rank's :class:`..runtime.mesh.MeshLayout` of a synced ``-m
    data`` run: the ``--mesh`` shape (default ``{"data": world}``) over
    the launched ranks as a ``DeviceMesh`` when ``--mesh`` or ``--zero``
    asks for one, else the plain data axis on the default group."""
    if not (config.mesh_shape or config.zero != "none"):
        return MeshLayout.plain(env.rank, env.world)
    shape = config.mesh_shape or {"data": -1}
    ranks = mesh_devices(shape, list(range(env.world)))
    if len(ranks) < env.world:
        raise ValueError(f"--mesh {shape} takes {len(ranks)} of the "
                         f"{env.world} ranks: launch -r {len(ranks)}")
    spec = mesh_for_mode("data", world=len(ranks),
                         explicit=config.mesh_shape)
    return MeshLayout.of(build_mesh(spec, env.device.type, env.world))


def _shard_fn(spec, config, sharding, layout):
    """``create_train_state``'s ``shard`` for a sharding decision."""
    if sharding == "tp":
        from distributed_deep_learning_tpu_torch.parallel.tensor_parallel \
            import apply_tensor_parallel

        rules = spec.tp_rules(config)
        return lambda model: apply_tensor_parallel(model, rules, layout)
    if sharding == "fsdp":
        from distributed_deep_learning_tpu_torch.parallel.zero import \
            apply_fsdp

        return lambda model: apply_fsdp(model, layout)
    return None


def train_setup(spec, config, env, init_state_dict, logger, registry=None,
                dataset=None, built=None):
    """``(state, train_step, eval_step, loaders, dataset, checkpointer
    parts, sentinel config)`` of a sequential or ``-m data`` run (see
    :func:`_train`); ``registry`` counts ``--comm``'s wire bytes a step;
    ``dataset`` is built unless given (the tuner's trials share one);
    ``built(state)`` runs once the model and its optimizer are on the
    device, before the state's first collective (the tuner's ranks agree
    there that every rank could build it)."""
    device = env.device
    dataset, splits = _dataset_splits(spec, config, dataset)
    sentinel = _sentinel_config(config)
    data_parallel = config.mode is Mode.DATA
    if data_parallel and not config.sync_in_local_data_mode:
        # reference quirk Q1: the ranks train independent replicas, each
        # on its 1/N shard, and rank 0's metrics are printed
        shards = config.world_size if config.world_size > 1 else env.world
        logger.info(f"quirk Q1 mode: no gradient sync; training rank 0's "
                    f"1/{shards} shard only")
        splits = dataclasses.replace(splits, **{
            name: shard_indices(getattr(splits, name), shards, env.rank)
            for name in ("train", "val", "test")})
        data_parallel = False
    layout = _mesh_layout(config, env) if data_parallel \
        else MeshLayout.plain()
    sharding = derive_state_spec(spec, config, layout.sizes) \
        if data_parallel else None
    check_step_flags(config, layout.sizes)
    # JAX's shard_map steps: each rank's own means (train.step)
    local_mean = data_parallel and layout.batch_world > 1 and (
        config.grad_compress != "none" or config.comm != "none")
    explicit = data_parallel and config.comm != "none"
    tx = _optimizer(spec, config, splits)
    # the rows and the dropout stream of this rank's coordinate on the
    # batch axes: the ranks of a model or expert group share both
    loaders = make_loaders(dataset, splits, config.batch_size, device,
                           seed=config.seed, rank=layout.batch_rank,
                           world=layout.batch_world,
                           accum=max(1, config.grad_accum))
    stream = layout.batch_rank if data_parallel else env.rank
    state = create_train_state(
        spec.build_model(config, dataset), config.seed, tx, init_state_dict,
        device=device,
        dropout_seed=config.seed + 1 + stream if config.dropout > 0
        else None, shard=None if explicit
        else _shard_fn(spec, config, sharding, layout))
    if sentinel is not None:
        from distributed_deep_learning_tpu_torch.train.sentinel import \
            attach_sentinel

        attach_sentinel(state)
    if sharding == "zero1":
        from distributed_deep_learning_tpu_torch.parallel.zero import (
            zero1_optimizer, zero_axis)

        state.optimizer = zero1_optimizer(
            tx, state.model, layout.mesh.get_group(zero_axis(layout.sizes)))
    if built is not None:
        built(state)
    if layout.mesh is not None:
        logger.info(f"mesh {layout.sizes}: state "
                    f"{sharding or 'replicated'}, batch split "
                    f"{layout.batch_world} ways")
    ckpt_parts = _maybe_checkpointer(
        config, env.rank, shared=data_parallel,
        mesh=layout.sizes if data_parallel else None)
    ddp, synced = None, data_parallel and layout.batch_world > 1
    loss_fn = spec.build_loss(config)
    if data_parallel and not local_mean:
        # BatchNorm statistics and MoE routing over the global batch, as
        # JAX's jit takes them over the sharded batch (BatchNorm models
        # have no model axis: their batch group is the world)
        global_batch_statistics(state.model)
        global_routing(state.model, layout.batch_rows)
    if explicit:
        return (*_explicit_fsdp(config, state, layout, tx, loss_fn,
                                registry), loaders,
                dataset, ckpt_parts, sentinel)
    if data_parallel and (layout.mesh is None
                          or (synced and sharding != "fsdp")):
        ddp = DistributedDataParallel(
            state.model, process_group=layout.batch_group,
            device_ids=[device.index] if device.type == "cuda" else None)
        if config.grad_compress != "none" and synced:
            from distributed_deep_learning_tpu_torch.train.compress import (
                GradCompression, compress_hook)

            residual = attach_comm_residual(
                config, state, state.model.named_parameters(),
                layout.batch_world)
            state.comm = GradCompression(
                config.grad_compress, state.model, layout.batch_group,
                layout.batch_rank, layout.batch_world, residual)
            ddp.register_comm_hook(state.comm, compress_hook)
    train_step, eval_step = make_step_fns(
        loss_fn, ddp=ddp, remat=config.remat,
        remat_policy=config.remat_policy, accum_steps=config.grad_accum,
        global_batch=synced, group=layout.batch_group, local_mean=local_mean,
        sentinel=sentinel)
    return (state, train_step, eval_step, loaders, dataset, ckpt_parts,
            sentinel)


def _explicit_fsdp(config: Config, state: TrainState, layout, tx, loss_fn,
                   registry=None):
    """``(state, train_step, eval_step)`` of ``--zero fsdp --comm``: the
    state's optimizer rebuilt over the :class:`..parallel.collectives.
    ExplicitFSDP` masters (each split leaf's shard), the residual
    attached for int8."""
    from distributed_deep_learning_tpu_torch.parallel.collectives import (
        ExplicitFSDP, make_fsdp_step_fns)

    comm = ExplicitFSDP(state.model, layout, config.comm,
                        config.comm_overlap)
    state.comm = comm
    state.optimizer = tx.build(comm.masters.items(), layout=comm.layout(
        getattr(state.model, "flax_layout", None)))
    attach_comm_residual(config, state, state.model.named_parameters(),
                         layout.batch_world)
    train_step, eval_step = make_fsdp_step_fns(
        loss_fn, comm, remat=config.remat, remat_policy=config.remat_policy,
        registry=registry)
    return state, train_step, eval_step


def _train(spec, config, env, init_state_dict):
    with _run_context(config, bootstrap.is_coordinator()) as (logger,
                                                              telemetry):
        dataset = down = None
        if config.autotune or config.plan_file:
            # plan fields never affect the dataset: the search's trials
            # and the run share one
            dataset = build_dataset(spec, config)
            config = _resolve_plan(spec, config, logger, dataset)
        if config.reshard and config.mode is Mode.DATA:
            # before any mesh exists: peek at the saved topology and, when
            # it no longer matches the launched ranks, let tune/ re-plan
            # this restart's mesh (--target-mesh overrides the search)
            from distributed_deep_learning_tpu_torch.reshard.replan import \
                resolve_restart_topology
            from distributed_deep_learning_tpu_torch.tune.trial import \
                launched_devices

            if dataset is None:
                dataset = build_dataset(spec, config)
            config = resolve_restart_topology(
                spec, config, launched_devices(config), logger,
                dataset=dataset)
            down = _StepDown.of(config, env, logger)
            if down is not None:
                if down.sits_out:
                    down.wait()
                    return None, []
                config, env = down.config, down.env
        try:
            return _fit_run(spec, config, env, init_state_dict, logger,
                            telemetry, dataset)
        finally:
            if down is not None:
                down.finish()


def _resolve_plan(spec: WorkloadSpec, config: Config, logger,
                  dataset) -> Config:
    """``--autotune`` / ``--plan FILE`` → the config the run actually uses
    (JAX's).  Autotune searches the plan lattice with measured trials
    (reusing the already-built dataset; every rank in lockstep), rank 0
    writes the artifact, and the winner applies; ``--plan`` alone loads an
    artifact, verifies its key against this run's (workload, geometry,
    topology), and applies it.  Either way the result is plain ``Config``
    field overrides — every downstream code path is unchanged."""
    from distributed_deep_learning_tpu_torch.tune import \
        artifact as plan_artifact
    from distributed_deep_learning_tpu_torch.tune.space import apply_plan
    from distributed_deep_learning_tpu_torch.tune.trial import (
        device_identity, launched_devices)

    devices = launched_devices(config)
    platform, device_kind = device_identity(devices)
    key = plan_artifact.plan_key(spec.name, config, len(devices),
                                 platform, device_kind)
    if config.autotune:
        from distributed_deep_learning_tpu_torch.tune.search import \
            run_search

        result = run_search(spec, config, devices=devices, dataset=dataset,
                            logger=logger)
        path = config.plan_file or f"autotune_{spec.name}.plan.json"
        if bootstrap.is_coordinator():
            plan_artifact.save_plan(
                path, result.best, key=key, workload=spec.name,
                topology={"n_devices": len(devices), "platform": platform,
                          "device_kind": device_kind},
                search=result.record())
        logger.info(
            f"autotune: best plan {plan_artifact.plan_hash(result.best)} "
            f"[{result.best.describe()}] "
            f"{result.best_sps:.2f} steps/s vs baseline "
            f"{result.baseline_sps:.2f}; artifact -> {path}")
        return apply_plan(config, result.best)
    plan, record = plan_artifact.load_plan(config.plan_file,
                                           expected_key=key)
    logger.info(f"plan {record['plan_hash']} [{plan.describe()}] applied "
                f"from {config.plan_file}")
    return apply_plan(config, plan)


class _StepDown:
    """A re-plan onto fewer ranks than were launched (6 survivors at a
    batch of 64 re-plan onto 4).  JAX leaves the spare devices idle; the
    port runs one process a rank, so the plan's ranks (the lowest) form a
    new default group among themselves, and each rank beyond them logs
    that it sits the run out, waits for the run's end on a key-value
    store that rank 0 keeps, and returns."""

    WAIT = 7200.0   # seconds a sitting-out rank waits for the run's end

    def __init__(self, store, rank: int, need: int, world: int,
                 config: Config, env):
        self.store, self.rank, self.need, self.world = store, rank, need, \
            world
        self.sits_out = rank >= need
        self.config, self.env = config, env

    @classmethod
    def of(cls, config: Config, env, logger) -> "_StepDown | None":
        import datetime

        import torch.distributed as dist

        from distributed_deep_learning_tpu_torch.runtime.mesh import MeshSpec

        sizes = MeshSpec.from_dict(config.mesh_shape or {"data": -1}).sizes()
        need = env.world if -1 in sizes else int(np.prod(sizes))
        if need >= env.world:
            return None
        box = [[bootstrap.free_port(), bootstrap.free_port()]]
        dist.broadcast_object_list(box, src=0)
        ports = box[0]
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        store = dist.TCPStore(addr, ports[1], is_master=env.rank == 0,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=cls.WAIT))
        backend = dist.get_backend()
        dist.barrier()
        bootstrap.shutdown()
        if env.rank >= need:
            print(f"reshard: rank {env.rank} sits out: the re-planned mesh "
                  f"{config.mesh_shape} takes ranks 0-{need - 1} of the "
                  f"{env.world} launched; waiting for the run's end",
                  file=sys.stderr, flush=True)
            return cls(store, env.rank, need, env.world, config, None)
        # the launch's backend again (gloo ranks may share a card)
        dist.init_process_group(backend, init_method=f"tcp://{addr}:"
                                f"{ports[0]}", world_size=need,
                                rank=env.rank, device_id=env.device
                                if backend == "nccl" else None)
        os.environ.update(WORLD_SIZE=str(need), MASTER_PORT=str(ports[0]))
        new_env = bootstrap.DistEnv(env.rank, need, env.device)
        logger.info(f"reshard: the re-planned mesh {config.mesh_shape} "
                    f"takes {need} of the {env.world} launched ranks; "
                    f"ranks {need}-{env.world - 1} sit out")
        return cls(store, env.rank, need, env.world,
                   config.replace(world_size=need), new_env)

    def wait(self) -> None:
        """A sitting-out rank: wait for rank 0's word, then acknowledge."""
        self.store.wait(["done"])
        self.store.set(f"ack-{self.rank}", "1")

    def finish(self) -> None:
        """The run's end: rank 0 releases the ranks that sat out and
        waits until each has read it (its store must outlive their
        reads)."""
        if self.rank == 0:
            self.store.set("done", "1")
            self.store.wait([f"ack-{r}" for r in range(self.need,
                                                       self.world)])


def _fit_run(spec, config, env, init_state_dict, logger, telemetry,
             dataset):
    """:func:`_train`'s setup and fit, once the run's layout is known."""
    state, train_step, eval_step, loaders, dataset, ckpt_parts, \
        sentinel = train_setup(
            spec, config, env, init_state_dict, logger,
            telemetry.registry if telemetry is not None else None,
            dataset=dataset)
    ckpt, ckpt_step, start_epoch, resume_batch, resume_totals = \
        ckpt_parts
    restore_fn = None
    if config.reshard and ckpt is not None:
        # restores go through the resharding path: same-topology and
        # legacy checkpoints restore plainly, anything else is
        # redistributed onto this run's layout
        from distributed_deep_learning_tpu_torch.reshard.restore import \
            make_restore_fn

        restore_fn = make_restore_fn(ckpt, ckpt.mesh, logger=logger)
    if telemetry is not None:
        telemetry.count_train_flops(n_devices=env.world)
    with profiling.trace(config.profile_dir):
        if config.elastic:
            state, history = _fit_elastic(
                config, logger, _reset_fn(state), train_step,
                eval_step, loaders, ckpt, sentinel=sentinel,
                telemetry=telemetry, restore_fn=restore_fn)
        else:
            if ckpt is not None and ckpt_step is not None:
                state, start_epoch, resume_batch, resume_totals = \
                    _restore_resume(ckpt, state, ckpt_step, start_epoch,
                                    resume_batch, resume_totals, logger,
                                    restore_fn=restore_fn,
                                    telemetry=telemetry)
            state, history = fit(
                state, train_step, eval_step, *loaders,
                epochs=config.epochs, logger=logger, checkpointer=ckpt,
                start_epoch=start_epoch,
                checkpoint_every=config.checkpoint_every,
                resume_batch=resume_batch, resume_totals=resume_totals,
                sentinel=sentinel, telemetry=telemetry)
    # every rank runs the hook, as in the JAX package; rank 0 logs
    if (config.generate_tokens or config.serve) and \
            spec.post_train is not None:
        spec.post_train(config,
                        whole_state(spec, config, dataset, state),
                        logger, dataset)
    return state, history


# ---------------------------------------------------------------------------
# Telemetry (obs/) wiring
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _run_context(config: Config, verbose: bool):
    """A training path's logger (its JSONL sidecar under
    ``--metrics-file``) and telemetry (under ``--obs``); on the way out
    the telemetry's run summary is written and logged, and both close."""
    logger = PhaseLogger(verbose=verbose, jsonl_path=config.metrics_file)
    telemetry = _maybe_telemetry(config)
    try:
        yield logger, telemetry
    finally:
        if telemetry is not None:
            _log_obs_summary(logger, telemetry.close())
        logger.close()


def _maybe_telemetry(config: Config):
    """``--obs``: a :class:`..obs.RunTelemetry` for this process (JAX's).
    Every process records; a rank other than 0 writes its sidecars with a
    ``.rankN`` suffix."""
    if not config.obs:
        return None
    from distributed_deep_learning_tpu_torch.obs import (FlightRecorder,
                                                         RunTelemetry)

    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0

    def _rank(p: str | None) -> str | None:
        return p if p is None or rank == 0 else f"{p}.rank{rank}"

    recorder = None
    if config.obs_blackbox:
        import time as _time

        recorder = FlightRecorder(clock=_time.perf_counter)
        recorder.install(path=_rank(config.obs_blackbox))
    return RunTelemetry(_rank(config.obs_file or "obs_events.jsonl"),
                        trace_path=_rank(config.obs_trace),
                        recorder=recorder, rotate_mb=config.obs_rotate_mb,
                        fsync_on_rollover=config.obs_rotate_mb is not None,
                        device=resolve_device(config.device))


def _log_obs_summary(logger, summary: dict) -> None:
    """One goodput/MFU line at the run's end (JAX's)."""
    gp = summary.get("goodput")
    if not gp:
        return
    fr = gp["fractions"]
    parts = " ".join(f"{c}={fr[c]:.3f}" for c in
                     ("productive", "input_stall", "checkpoint",
                      "recovery", "compile"))
    mfu = (summary.get("mfu") or {}).get("mfu")
    mfu_txt = f" mfu={mfu:.4f}" if mfu is not None else ""
    logger.info(f"obs: goodput {parts} over {gp['wall_seconds']:.1f}s "
                f"({gp['steps']} steps){mfu_txt}")


def whole_state(spec, config, dataset, state: TrainState) -> TrainState:
    """``state`` with a whole model when its parameters are split across
    ranks (every rank gathers; serving runs on the whole copy), else
    ``state`` itself."""
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        ExplicitFSDP

    if isinstance(state.comm, ExplicitFSDP):   # its model is whole
        state.comm.gather(exact=True)
        return state
    if not any(is_split(p) for p in resharded(state.model).parameters()):
        return state
    sd = whole_state_dict(state.model)
    device = next(iter(sd.values())).device
    model = spec.build_model(config, dataset)
    model.load_state_dict(sd)
    return dataclasses.replace(state, model=model.to(device))


# ---------------------------------------------------------------------------
# MP / PP: staged training (MPMD)
# ---------------------------------------------------------------------------

def _devices(config: Config) -> list[torch.device]:
    """``-d cpu``: the CPU; else every visible card (raises without
    one)."""
    device = resolve_device(config.device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class StagedState:
    """Staged training's state: the staged model and one
    :class:`..train.state.TrainState` a stage (its module, its optimizer
    and its own update count), as the JAX package keeps one optimizer
    state a stage; ``step`` counts train steps."""

    model: StagedModel
    stages: list[TrainState]
    step: int = 0


class StagedTrainer:
    """Trains a :class:`StagedModel` with stage ``i`` on ``devices[i]``:
    the forward walks the stages through its :class:`MPMDPipeline` (in
    ``microbatch_size`` chunks, the ragged last one kept, the outputs
    concatenated; BatchNorm statistics advance once a chunk, in chunk
    order), the loss is taken on the last stage's device, autograd runs
    the backward across the ``.to(device)`` boundaries, and each stage's
    optimizer updates its own parameters.  So ``--clip-norm`` clips each
    stage's gradients by that stage's norm, as in the JAX package."""

    def __init__(self, staged: StagedModel, devices, loss_fn, tx: Optimizer,
                 microbatch_size: int | None = None):
        self.pipeline = MPMDPipeline(staged, devices, microbatch_size)
        self.staged, self.devices = staged, self.pipeline.devices
        self.loss_fn, self.tx = loss_fn, tx

    def init(self, seed: int, init_state_dict: dict | None = None
             ) -> StagedState:
        """Initialise from ``seed`` (the sequential model's draws) or load
        ``init_state_dict``, place the stages and build their optimizers."""
        self.staged.reset_parameters(torch.Generator().manual_seed(seed))
        if init_state_dict is not None:
            self.staged.load_state_dict(init_state_dict)
        stages = []
        for stage in self.pipeline.place().stages:
            stages.append(TrainState(
                model=stage, tx=self.tx,
                optimizer=self.tx.build(stage.named_parameters(),
                                        layout=_stage_layout(stage))))
        return StagedState(model=self.staged, stages=stages)

    def forward(self, x, train: bool = False):
        """Microbatched (pipeline) or whole-batch (model) staged forward."""
        return self.pipeline.pipelined_forward(x, train)

    def train_step(self, state: StagedState, x, y):
        for st in state.stages:
            st.optimizer.zero_grad(set_to_none=True)
        y = y.to(self.devices[-1])
        pred = self.forward(x, train=True)
        loss = self.loss_fn(pred, y)
        loss.backward()
        for st in state.stages:
            st.apply_gradients()
        state.step += 1
        return state, prediction_metrics(pred.detach(), y, loss.detach())

    @torch.no_grad()
    def eval_step(self, state: StagedState, x, y):
        y = y.to(self.devices[-1])
        pred = self.forward(x, train=False)
        return prediction_metrics(pred, y, self.loss_fn(pred, y))


def _stage_layout(stage):
    """Adafactor's flax layouts for a stage holding transformer blocks
    (``models.transformer.flax_layout``), else None."""
    from distributed_deep_learning_tpu_torch.models.transformer import (
        TransformerLayer, flax_layout)

    blocks = [m for m in stage.modules() if isinstance(m, TransformerLayer)]
    if not blocks:
        return None
    head_dim = blocks[0].self_attn.head_dim
    return lambda name: flax_layout(name, head_dim)


def _mpmd_refusals(config: Config) -> list[str]:
    """The JAX package's staged-MPMD refusals that the port's CLI parses
    (the others name their own ROADMAP items at parse time)."""
    return [flag for cond, flag in (
        (config.checkpoint_dir, "--checkpoint-dir"),
        (config.resume, "--resume"),
        (config.grad_accum > 1, "--grad-accum"),
        (config.remat, "--remat"),
        (config.zero != "none", "--zero"),
        (config.dropout > 0, "--dropout"),
        (config.elastic, "--elastic"),
        (config.heartbeat_dir, "--heartbeat-dir"),
        (config.grad_compress != "none", "--grad-compress"),
        (config.sentinel != "off", "--sentinel")) if cond]


def staged_setup(spec: WorkloadSpec, config: Config, logger,
                 init_state_dict=None):
    """``(trainer, state, dataset, loaders)`` of a staged run: the
    workload's layer list partitioned into ``--nstages`` stages (default:
    one a device, at most one a layer), stage ``i`` on device ``i mod
    n``, initialised from ``--seed`` or ``init_state_dict``."""
    bad = _mpmd_refusals(config)
    if bad:
        raise ValueError(
            f"staged MPMD mode {config.mode.value!r} does not support "
            f"{', '.join(bad)}; use -m data (or -m pipeline for workloads "
            "with an SPMD pipeline, which supports checkpointing and remat)")
    devices = _devices(config)
    dataset, splits = _dataset_splits(spec, config)
    tx = _optimizer(spec, config, splits)
    layers = list(spec.build_layers(config, dataset))
    n_stages = config.num_stages or min(len(devices), len(layers))
    assignment = validate_assignment(
        spec.partitioner(len(layers), n_stages), n_stages)
    staged = StagedModel.from_layers(
        layers, assignment, n_stages,
        spec.stage_input(config) if spec.stage_input else None)
    stage_devices = [devices[i % len(devices)] for i in range(n_stages)]
    microbatch = config.microbatch if config.mode is Mode.PIPELINE else None
    trainer = StagedTrainer(staged, stage_devices, spec.build_loss(config),
                            tx, microbatch_size=microbatch)
    logger.info(f"staged {config.mode.value}: {n_stages} stages of "
                f"{[len(s.layers) for s in staged.stages]} layers on "
                f"{', '.join(map(str, stage_devices))}")
    state = trainer.init(config.seed, init_state_dict)
    loaders = make_loaders(dataset, splits, config.batch_size,
                           stage_devices[0], seed=config.seed)
    return trainer, state, dataset, loaders


def _run_staged(spec: WorkloadSpec, config: Config, init_state_dict):
    """``-m model`` and, for the workloads without a pipelined LM, ``-m
    pipeline``: the layer list staged over the devices."""
    with _run_context(config, True) as (logger, telemetry):
        trainer, state, dataset, loaders = staged_setup(
            spec, config, logger, init_state_dict)
        if telemetry is not None:
            telemetry.count_train_flops(n_devices=1)
        with profiling.trace(config.profile_dir):
            state, history = fit(state, trainer.train_step,
                                 trainer.eval_step, *loaders,
                                 epochs=config.epochs, logger=logger,
                                 telemetry=telemetry)
        if (config.generate_tokens or config.serve) and \
                spec.post_train is not None:
            spec.post_train(config, state, logger, dataset)
        return state, history


# ---------------------------------------------------------------------------
# -m pipeline for the LMs: the stacked trunk under a schedule
# ---------------------------------------------------------------------------

def _make_1f1b_train_step(model, loss_fn, microbatch: int | None,
                          interleaved: bool = False):
    """Train step of a ``models.pipelined_lm.PipelinedLM`` under the 1F1B
    schedule (``parallel.spmd_pipeline.spmd_pipeline_1f1b``) or its
    interleaved variant: the embedding runs outside the pipeline, its
    backward fed by the pipeline's ``dx``; the head and the loss run on
    the last stage inside it.  The loss is the sum of the microbatch means
    over their count; correct and count are summed."""
    from torch.func import functional_call

    from distributed_deep_learning_tpu_torch.parallel.spmd_pipeline import (
        spmd_pipeline_1f1b, spmd_pipeline_interleaved)

    pipeline = spmd_pipeline_interleaved if interleaved \
        else spmd_pipeline_1f1b

    def head_loss(hp, h_mb, y_mb):
        logits = functional_call(model.head, hp, (h_mb,))
        loss = loss_fn(logits, y_mb)
        return loss, prediction_metrics(logits.detach(), y_mb,
                                        loss.detach())

    def train_step(state: TrainState, x, y):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        h = model.embed(x)
        loss, tg, hg, dh, aux = pipeline(
            model.trunk.stage_fn, head_loss, model.trunk.stacked(),
            dict(model.head.named_parameters()), h.detach(), y,
            microbatch_size=microbatch, has_aux=True,
            seed=model.dropout_seed(state.generator))
        h.backward(dh.to(h.dtype))
        for k, p in model.trunk.stacked().items():
            p.grad = tg[k].to(p.dtype)
        for k, p in model.head.named_parameters():
            p.grad = hg[k].to(p.dtype)
        state.apply_gradients()
        return state, {"loss": loss, "correct": aux["correct"],
                       "count": aux["count"]}

    return train_step


def _make_grid_steps(model, loss_fn, microbatch: int, grid, schedule: str,
                     remat: str | None = None):
    """``(train_step, eval_step)`` of a ``PipelinedLM`` as rank ``(d, s)``
    of ``grid`` (its trunk holding stage ``s``'s slice), on this data
    coordinate's rows, ``microbatch`` of them a microbatch.  The
    embedding runs on every rank (stage 0 backpropagates it with the
    pipeline's ``dx``), the head on the last stage; the embedding's and
    the head's gradients are summed over every rank (over the stages,
    then the data axis, as JAX's ``psum``s take them), so every replica
    takes the same update.  1F1B and interleaved log JAX's loss, the mean
    of the microbatch means over the data shards; GPipe's is the global
    batch's mean over its counted sites, as JAX's step over the GPipe
    forward takes it.  Evaluation runs GPipe's forward without gradients
    and the global batch's loss and counts."""
    from torch.func import functional_call

    from distributed_deep_learning_tpu_torch.parallel import spmd_pipeline

    gpipe = schedule == "gpipe"
    pipeline = {"1f1b": spmd_pipeline.spmd_pipeline_1f1b,
                "interleaved": spmd_pipeline.spmd_pipeline_interleaved,
                "gpipe": spmd_pipeline.spmd_pipeline_gpipe}[schedule]

    def head_loss(hp, h_mb, y_mb):
        logits = functional_call(model.head, hp, (h_mb,))
        loss = loss_fn(logits, y_mb)
        metrics = prediction_metrics(logits.detach(), y_mb, loss.detach())
        if gpipe:
            # this coordinate's share of the global batch's mean
            sites = loss_fn.sites(y_mb).double()
            total = sites.clone()
            if grid.data_group is not None:
                torch.distributed.all_reduce(total, group=grid.data_group)
            loss = loss * (sites / total.clamp_min(1.0)).float()
        return loss, metrics

    def train_step(state: TrainState, x, y):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        seed = model.dropout_seed(state.generator)
        with torch.set_grad_enabled(grid.first):
            h = model.embed(x)
        kw = {"remat": remat} if gpipe else {}
        loss, tg, hg, dh, aux = pipeline(
            model.trunk.stage_fn, head_loss, model.trunk.stacked(),
            dict(model.head.named_parameters()), h.detach(), y,
            microbatch_size=microbatch, has_aux=True, seed=seed, grid=grid,
            **kw)
        if grid.first:
            h.backward(dh.to(h.dtype))
        embed = dict(model.embed.named_parameters())
        eg = spmd_pipeline._all_reduced(
            {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in embed.items()})
        for k, p in embed.items():
            p.grad = eg[k].to(p.dtype)
        for k, p in model.trunk.stacked().items():
            p.grad = tg[k].to(p.dtype)
        for k, p in model.head.named_parameters():
            p.grad = hg[k].to(p.dtype)
        state.apply_gradients()
        return state, {"loss": loss, "correct": aux["correct"],
                       "count": aux["count"]}

    @torch.no_grad()
    def eval_step(state: TrainState, x, y):
        model.eval()
        out = spmd_pipeline.spmd_pipeline_forward(
            model.trunk.stage_fn, model.trunk.stacked(), model.embed(x),
            grid=grid, microbatch_size=microbatch,
            n_chunks=model.trunk.n_chunks)
        stats = torch.zeros(4, dtype=torch.float64, device=x.device)
        if grid.last:
            pred = model.head(out)
            loss = loss_fn(pred, y)
            m = prediction_metrics(pred, y, loss)
            sites = loss_fn.sites(y)
            stats = torch.stack([loss.double() * sites, sites.double(),
                                 m["correct"].double(),
                                 m["count"].double()])
        torch.distributed.all_reduce(stats)
        total = stats[1].clamp_min(1.0)
        return {"loss": (stats[0] / total).float(),
                "correct": stats[2].to(torch.int32),
                "count": stats[3].to(torch.int32)}

    return train_step, eval_step


def pipeline_stages(config: Config, n_devices: int) -> int:
    """``--nstages``, or JAX's default: the largest stage count dividing
    both the trunk's depth and the device count (on a grid, the rank
    count)."""
    if config.num_stages:
        return config.num_stages
    return max((s for s in range(1, n_devices + 1)
                if config.num_layers % s == 0 and n_devices % s == 0),
               default=1)


def snap_microbatch(batch: int, microbatch: int | None, dp: int = 1) -> int:
    """JAX's snapping: ``-p`` (default ``dp``) when ``dp`` divides it and
    it divides the batch, else the nearest such size (the smaller on a
    tie)."""
    mb = microbatch or dp
    if mb % dp == 0 and batch % mb == 0:
        return mb
    valid = [d for d in range(dp, batch + 1, dp) if batch % d == 0]
    return min(valid, key=lambda d: (abs(d - mb), d))


def _pipeline_grid(config: Config, n_stages: int):
    """``(grid, created)``: the data x stage grid of a launch of more than
    one rank (None at world 1), with JAX's stage-count refusals over the
    rank count (its device count)."""
    env, created = _data_parallel_env(config)
    if env.world == 1:
        return None, created
    try:
        if n_stages > env.world:
            raise ValueError(f"--nstages {n_stages} exceeds {env.world} "
                             "devices")
        if env.world % n_stages:
            raise ValueError(f"--nstages {n_stages} must divide the device "
                             f"count {env.world} (the rest becomes the "
                             "data axis)")
        return PipelineGrid.build(env.world // n_stages, n_stages), created
    except Exception:
        if created:
            bootstrap.shutdown()
        raise


def pipelined_setup(spec: WorkloadSpec, config: Config, logger,
                     init_state_dict=None, grid=None):
    """``(config, state, train_step, eval_step, dataset, loaders)`` of a
    ``-m pipeline`` run of a pipelined LM, the trunk's parameters stacked
    in JAX's layout (one optimizer over the model, so ``--clip-norm`` is
    global).  Without a ``grid`` one process walks the schedule's ticks,
    every stage on the one device (``dp = 1``); on a grid
    (:class:`..runtime.mesh.PipelineGrid`) a rank keeps its stage's slice
    of the trunk and trains on its data coordinate's rows.  ``config``
    carries the snapped ``-p`` (the global microbatch)."""
    if config.pipeline_schedule == "interleaved" and \
            config.virtual_stages < 2:
        raise ValueError(f"--pipeline-schedule interleaved needs "
                         f"--virtual-stages >= 2 (got "
                         f"{config.virtual_stages}); with one chunk per "
                         "device use --pipeline-schedule 1f1b")
    if config.grad_compress != "none":
        raise ValueError("--grad-compress targets the pure data-parallel "
                         "gradient all-reduce; the SPMD pipeline's gradient "
                         "dataflow is stage-sharded (use -m data)")
    hand_scheduled = config.pipeline_schedule in ("1f1b", "interleaved")
    if config.remat_policy != "nothing" and hand_scheduled:
        raise ValueError("--remat-policy has no effect under "
                         "--pipeline-schedule 1f1b/interleaved")
    if config.sentinel != "off":
        raise ValueError("--sentinel supports -m sequential/data (the "
                         "fused train step); the SPMD pipeline's staged "
                         "step has no sentinel wiring yet")
    if config.grad_accum > 1:
        raise ValueError("--grad-accum: -m pipeline takes no gradient "
                         "accumulation (its microbatches are the "
                         "accumulation; the JAX package's pipeline ignores "
                         "the flag); use -p to size them")
    device = resolve_device(config.device)
    dp = 1 if grid is None else grid.dp
    n_stages = grid.stages if grid is not None else \
        pipeline_stages(config, len(_devices(config)))
    where = f"every stage on {device}" if grid is None else \
        "one rank a stage"
    logger.info(f"SPMD pipeline: {n_stages} stages x {dp}-way data parallel "
                f"({config.pipeline_schedule}, {where})")
    if hand_scheduled and config.remat:
        logger.info("--remat: the 1f1b/interleaved backward recomputes "
                    "each stage already")
    mb = config.microbatch or dp
    snapped = snap_microbatch(config.batch_size, config.microbatch, dp)
    if snapped != mb:
        logger.info(f"microbatch {mb} incompatible with batch "
                    f"{config.batch_size} / dp {dp}; using {snapped}")
    config = config.replace(microbatch=snapped)
    dataset, splits = _dataset_splits(spec, config)
    tx = _optimizer(spec, config, splits)
    model = spec.build_pipelined(config, dataset, n_stages)
    model.reset_parameters(torch.Generator().manual_seed(config.seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    model.to(device)
    if grid is not None:
        model.trunk.keep_stage(grid)
    # a CPU generator: each step draws its dropout seed without a sync
    # (on a grid every rank draws the same)
    gen = torch.Generator().manual_seed(config.seed + 1) \
        if config.dropout > 0 else None
    state = TrainState(model=model, tx=tx, generator=gen,
                       optimizer=tx.build(model.named_parameters(),
                                          layout=model.flax_layout))
    loss_fn = spec.build_loss(config)
    if grid is not None:
        train_step, eval_step = _make_grid_steps(
            model, loss_fn, snapped // dp, grid, config.pipeline_schedule,
            remat=config.remat_policy if config.remat and not hand_scheduled
            else None)
        loaders = make_loaders(dataset, splits, config.batch_size, device,
                               seed=config.seed, rank=grid.data, world=dp,
                               accum=config.batch_size // snapped)
        return config, state, train_step, eval_step, dataset, loaders
    train_step, eval_step = make_step_fns(
        loss_fn, remat=config.remat and not hand_scheduled,
        remat_policy=config.remat_policy)
    if hand_scheduled:
        train_step = _make_1f1b_train_step(
            model, loss_fn, config.microbatch,
            interleaved=config.pipeline_schedule == "interleaved")
    loaders = make_loaders(dataset, splits, config.batch_size, device,
                           seed=config.seed)
    return config, state, train_step, eval_step, dataset, loaders


def _run_spmd_pipelined(spec: WorkloadSpec, config: Config,
                        init_state_dict):
    """``-m pipeline`` for the workloads with a pipelined LM
    (:func:`pipelined_setup`): one process, or a data x stage grid when
    more than one rank is launched; with ``--checkpoint-dir``/
    ``--resume`` (a grid's checkpoints hold whole tensors, so either
    restores the other's) and ``--elastic``."""
    launched = max(config.world_size, bootstrap.env_topology()[1])
    grid, created = (None, False) if launched == 1 else \
        _pipeline_grid(config, pipeline_stages(config, launched))
    try:
        return _pipelined_fit(spec, config, init_state_dict, grid)
    finally:
        if created:
            bootstrap.shutdown()


def _pipelined_fit(spec, config, init_state_dict, grid):
    with _run_context(config, bootstrap.is_coordinator()) as (logger,
                                                              telemetry):
        config, state, train_step, eval_step, dataset, loaders = \
            pipelined_setup(spec, config, logger, init_state_dict, grid)
        ckpt, ckpt_step, start_epoch, resume_batch, resume_totals = \
            _maybe_checkpointer(config, 0, shared=grid is not None,
                                replicated_generator=True)
        if telemetry is not None and grid is None:
            telemetry.count_train_flops(n_devices=1)
        with profiling.trace(config.profile_dir):
            if config.elastic:
                state, history = _fit_elastic(
                    config, logger, _reset_fn(state), train_step,
                    eval_step, loaders, ckpt, telemetry=telemetry)
            else:
                if ckpt is not None and ckpt_step is not None:
                    state, start_epoch, resume_batch, resume_totals = \
                        _restore_resume(ckpt, state, ckpt_step, start_epoch,
                                        resume_batch, resume_totals, logger)
                state, history = fit(
                    state, train_step, eval_step, *loaders,
                    epochs=config.epochs, logger=logger, checkpointer=ckpt,
                    start_epoch=start_epoch,
                    checkpoint_every=config.checkpoint_every,
                    resume_batch=resume_batch, resume_totals=resume_totals,
                    telemetry=telemetry)
        if (config.generate_tokens or config.serve) and \
                spec.post_train is not None:
            spec.post_train(config, state, logger, dataset)
        return state, history
