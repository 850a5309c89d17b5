"""Shared workload runner: config → data → model → train.  The port of
``distributed_deep_learning_tpu/workloads/base.py`` for ``-m sequential``
(one device); the other modes are refused by the CLI
(:mod:`..utils.config`) and by :func:`run_workload`.

The optimizers follow optax, not torch's defaults: see
:class:`..train.state.Optimizer`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

from torch import nn

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from distributed_deep_learning_tpu_torch.train import schedules
from distributed_deep_learning_tpu_torch.train.loop import EpochResult, fit
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, TrainState, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils.config import (
    ROADMAP_ITEMS, Config, Mode)
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What differs between workloads (the JAX spec's fields that the
    sequential path reads)."""

    name: str
    build_dataset: Callable[[Config], Any]
    build_model: Callable[[Config, Any], nn.Module]
    build_loss: Callable[[Config], Callable]
    build_optimizer: Callable[[Config, int], Optimizer]


#: flax's DenseGeneral keeps the q/k/v biases as (heads, head_dim), so
#: optax's ``ndim >= 2`` mask decays them; torch's Linear biases are 1-D
_MATRIX_BIASES = ("self_attn.q.bias", "self_attn.k.bias", "self_attn.v.bias")


def decay_mask(name: str, param) -> bool:
    """The AdamW recipe's decay mask on the JAX parameter layout: matrices
    decay, biases and LayerNorm scales (vectors there) do not."""
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
    if config.optimizer in ("sgd", "momentum", "adam"):
        return Optimizer(config.optimizer, lr)
    raise NotImplementedError(f"--optimizer {config.optimizer} is not "
                              f"ported yet: {ROADMAP_ITEMS[3]}")


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


def run_workload(spec: WorkloadSpec, config: Config, *,
                 init_state_dict: dict | None = None
                 ) -> tuple[TrainState, list[EpochResult]]:
    """Train ``spec`` under ``config``; returns (final state, phase
    history).  ``init_state_dict`` replaces the seeded initialisation (the
    tests pass the JAX package's init through it)."""
    if config.mode is not Mode.SEQUENTIAL:
        item = 5 if config.mode is Mode.DATA else 10
        raise NotImplementedError(f"-m {config.mode.value} is not ported "
                                  f"yet: {ROADMAP_ITEMS[item]}")
    if config.attention_window is not None and config.attention_window < 1:
        raise ValueError(f"--window must be >= 1, got "
                         f"{config.attention_window}")
    if config.label_smoothing and not 0.0 < config.label_smoothing < 1.0:
        raise ValueError(f"--label-smoothing must be in (0, 1), got "
                         f"{config.label_smoothing}")
    if config.num_kv_heads is not None and config.num_kv_heads < 1:
        raise ValueError(f"--kv-heads must be >= 1, got "
                         f"{config.num_kv_heads}")
    device = resolve_device(config.device)
    dataset = spec.build_dataset(config)
    # DDL_DATA_LIMIT caps the examples considered (CI / smoke runs)
    limit = int(os.environ.get("DDL_DATA_LIMIT", "0"))
    n = min(len(dataset), limit) if limit else len(dataset)
    splits = train_val_test_split(n, seed=config.seed)
    epoch_steps = max(1, len(splits.train) // config.batch_size)
    tx = build_optimizer(spec, config, epoch_steps)
    if config.clip_norm:
        tx = dataclasses.replace(tx, clip_norm=config.clip_norm)
    loaders = make_loaders(dataset, splits, config.batch_size, device,
                           seed=config.seed)
    state = create_train_state(
        spec.build_model(config, dataset), config.seed, tx, init_state_dict,
        device=device,
        dropout_seed=config.seed + 1 if config.dropout > 0 else None)
    train_step, eval_step = make_step_fns(spec.build_loss(config))
    return fit(state, train_step, eval_step, *loaders, epochs=config.epochs,
               logger=PhaseLogger(verbose=True))
