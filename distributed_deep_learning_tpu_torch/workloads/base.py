"""Shared workload runner: config → data → model → train.  The port of
``distributed_deep_learning_tpu/workloads/base.py`` for ``-m sequential``
and ``-m data``; the other modes are refused by the CLI
(:mod:`..utils.config`) and by :func:`run_workload`.

``-m data`` runs one process per rank (``--spawn``, or a launcher's
environment; :mod:`..runtime.bootstrap`), the model wrapped in
``DistributedDataParallel``; at world 1 it is one process on NCCL (gloo
with ``-d cpu``).  ``--no-sync`` is the reference's quirk Q1: each rank
trains its own 1/N shard with no gradient sync and rank 0's is logged.

The optimizers follow optax, not torch's defaults: see
:class:`..train.state.Optimizer`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

from torch import nn
from torch.nn.parallel import DistributedDataParallel

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import (
    shard_indices, train_val_test_split)
from distributed_deep_learning_tpu_torch.runtime import bootstrap
from distributed_deep_learning_tpu_torch.train import schedules
from distributed_deep_learning_tpu_torch.train.elastic import resume_point
from distributed_deep_learning_tpu_torch.train.loop import EpochResult, fit
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, TrainState, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer
from distributed_deep_learning_tpu_torch.utils.config import (
    ROADMAP_ITEMS, Config, Mode)
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What differs between workloads (the JAX spec's fields that the
    ported paths read).  ``pre_train_check(config, dataset)`` rejects a
    run before training; ``post_train(config, state, logger, dataset)``
    runs ``--generate``/``--serve`` after it."""

    name: str
    build_dataset: Callable[[Config], Any]
    build_model: Callable[[Config, Any], nn.Module]
    build_loss: Callable[[Config], Callable]
    build_optimizer: Callable[[Config, int], Optimizer]
    pre_train_check: Optional[Callable[[Config, Any], None]] = None
    post_train: Optional[Callable[..., None]] = None


#: flax's DenseGeneral keeps the q/k/v biases as (heads, head_dim), so
#: optax's ``ndim >= 2`` mask decays them; torch's Linear biases are 1-D
_MATRIX_BIASES = ("self_attn.q.bias", "self_attn.k.bias", "self_attn.v.bias")


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


def _maybe_checkpointer(config: Config, rank: int, shared: bool):
    """``(checkpointer, ckpt_step, start_epoch, resume_batch,
    resume_totals)`` from ``--checkpoint-dir``/``--resume``; a directory
    that holds checkpoints without ``--resume`` is refused (this run's
    saves would be skipped in favour of the old run's steps).  ``shared``:
    the ranks train one model and save it together; otherwise (quirk Q1)
    each rank keeps its own replica, rank r > 0 under ``rank-<r>/``."""
    if not config.checkpoint_dir:
        return None, None, 1, 0, None
    directory = config.checkpoint_dir if shared or rank == 0 \
        else os.path.join(config.checkpoint_dir, f"rank-{rank}")
    ckpt = Checkpointer(directory, shared=shared)
    if not config.resume:
        last = ckpt.latest_step()
        if last is not None:
            raise ValueError(
                f"--checkpoint-dir {config.checkpoint_dir} already holds "
                f"checkpoints (latest step {last}): pass --resume to "
                "continue it, or point at a fresh directory")
        return ckpt, None, 1, 0, None
    return (ckpt, *resume_point(ckpt))


def _restore_resume(ckpt, state, ckpt_step, start_epoch, resume_batch,
                    resume_totals, logger):
    """Verified restore for ``--resume``: a torn or corrupt step is
    quarantined and the newest good one restored, and the resume point is
    decoded again from the step actually restored."""
    restored, used = ckpt.restore_verified(state, step=ckpt_step)
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


def run_workload(spec: WorkloadSpec, config: Config, *,
                 init_state_dict: dict | None = None
                 ) -> tuple[TrainState, list[EpochResult]]:
    """Train ``spec`` under ``config``; returns (final state, phase
    history; on ``-m data`` each rank's own, rank 0 logging).
    ``init_state_dict`` replaces the seeded initialisation (the tests pass
    the JAX package's init through it)."""
    if config.mode not in (Mode.SEQUENTIAL, Mode.DATA):
        raise NotImplementedError(f"-m {config.mode.value} is not ported "
                                  f"yet: {ROADMAP_ITEMS[10]}")
    if (config.generate_tokens or config.serve) and spec.post_train is None:
        flag = "--generate" if config.generate_tokens else "--serve"
        raise ValueError(f"{flag} is not supported by workload "
                         f"{spec.name!r} (gpt only)")
    if config.attention_window is not None and config.attention_window < 1:
        raise ValueError(f"--window must be >= 1, got "
                         f"{config.attention_window}")
    if config.label_smoothing and not 0.0 < config.label_smoothing < 1.0:
        raise ValueError(f"--label-smoothing must be in (0, 1), got "
                         f"{config.label_smoothing}")
    if config.num_kv_heads is not None and config.num_kv_heads < 1:
        raise ValueError(f"--kv-heads must be >= 1, got "
                         f"{config.num_kv_heads}")
    if config.grad_accum > 1 and config.remat:
        raise ValueError("--remat with --grad-accum is not implemented; "
                         "drop one of the two")
    if config.mode is Mode.SEQUENTIAL:
        return _train(spec, config, bootstrap.DistEnv(
            device=resolve_device(config.device)), init_state_dict)
    env, created = _data_parallel_env(config)
    try:
        return _train(spec, config, env, init_state_dict)
    finally:
        if created:
            bootstrap.shutdown()


def _train(spec, config, env, init_state_dict):
    device = env.device
    logger = PhaseLogger(verbose=bootstrap.is_coordinator())
    dataset = spec.build_dataset(config)
    if spec.pre_train_check is not None:
        spec.pre_train_check(config, dataset)
    # DDL_DATA_LIMIT caps the examples considered (CI / smoke runs)
    limit = int(os.environ.get("DDL_DATA_LIMIT", "0"))
    n = min(len(dataset), limit) if limit else len(dataset)
    splits = train_val_test_split(n, seed=config.seed)
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
    epoch_steps = max(1, len(splits.train) // config.batch_size)
    tx = build_optimizer(spec, config, epoch_steps)
    if config.clip_norm:
        tx = dataclasses.replace(tx, clip_norm=config.clip_norm)
    world = env.world if data_parallel else 1
    loaders = make_loaders(dataset, splits, config.batch_size, device,
                           seed=config.seed,
                           rank=env.rank if data_parallel else 0,
                           world=world, accum=max(1, config.grad_accum))
    # each rank draws its own dropout masks (seed + 1 at rank 0)
    state = create_train_state(
        spec.build_model(config, dataset), config.seed, tx, init_state_dict,
        device=device,
        dropout_seed=config.seed + 1 + env.rank if config.dropout > 0
        else None)
    ckpt, ckpt_step, start_epoch, resume_batch, resume_totals = \
        _maybe_checkpointer(config, env.rank, shared=data_parallel)
    if ckpt is not None and ckpt_step is not None:
        state, start_epoch, resume_batch, resume_totals = _restore_resume(
            ckpt, state, ckpt_step, start_epoch, resume_batch, resume_totals,
            logger)
    ddp = None
    if data_parallel:
        ddp = DistributedDataParallel(
            state.model,
            device_ids=[device.index] if device.type == "cuda" else None)
    loss_fn = spec.build_loss(config)
    train_step, eval_step = make_step_fns(
        loss_fn, ddp=ddp, remat=config.remat,
        remat_policy=config.remat_policy, accum_steps=config.grad_accum)
    state, history = fit(state, train_step, eval_step, *loaders,
                         epochs=config.epochs, logger=logger,
                         checkpointer=ckpt, start_epoch=start_epoch,
                         checkpoint_every=config.checkpoint_every,
                         resume_batch=resume_batch,
                         resume_totals=resume_totals)
    # every rank runs the hook, as in the JAX package; rank 0 logs
    if (config.generate_tokens or config.serve) and \
            spec.post_train is not None:
        spec.post_train(config, state, logger, dataset)
    return state, history
