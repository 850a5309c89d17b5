"""Learning-rate schedules as plain functions of the optimizer step: the
port of ``distributed_deep_learning_tpu/train/schedules.py``.

Each returns ``schedule(count) -> lr``, where ``count`` is the number of
updates already applied (0 for the first step), as optax counts it, and
matches the optax schedule the JAX package builds:

* :func:`warmup_cosine` — ``optax.warmup_cosine_decay_schedule``;
* :func:`warmup_rsqrt` — the transformer-base (Noam) schedule;
* :func:`step_decay` — ``optax.exponential_decay(staircase=True)``.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_factor: float = 0.0) -> Schedule:
    """Linear 0→peak over ``warmup_steps``, cosine peak→end over the rest."""
    if total_steps <= warmup_steps:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    end = peak_lr * end_factor
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    decay_steps = total_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            # optax.linear_schedule(0, peak, warmup_steps)
            return peak_lr * count / warmup_steps
        c = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def warmup_rsqrt(d_model: int, warmup_steps: int = 4000,
                 scale: float = 1.0) -> Schedule:
    """Transformer-base (Noam) schedule."""

    def schedule(count: int) -> float:
        step = float(max(count, 1))
        return scale * d_model ** -0.5 * min(step ** -0.5,
                                             step * warmup_steps ** -1.5)

    return schedule


def step_decay(base_lr: float, steps_per_drop: int,
               factor: float = 0.1) -> Schedule:
    """The reference's StepLR: ×``factor`` every ``steps_per_drop`` steps."""

    def schedule(count: int) -> float:
        return base_lr * factor ** (count // steps_per_drop)

    return schedule
