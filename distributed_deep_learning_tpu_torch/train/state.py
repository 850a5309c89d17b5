"""Training state: the port of ``distributed_deep_learning_tpu/train/state.py``.

The JAX package threads an immutable pytree through a jitted step; here
the state is the module itself, its ``torch.optim`` optimizer (updated in
place), the update count and the dropout generator.  :class:`Optimizer`
is the optax-style recipe the optimizer is built from: the learning rate
is set from the schedule at each update's count, and a global-norm clip
follows ``optax.clip_by_global_norm``.

The parameters are f32 whatever the model computes in: a bf16 model
(``CausalLM(dtype=torch.bfloat16)``) casts them on the way in, so its
gradients arrive f32 on these master weights, and the clip's norm and the
optimizer's moments stay f32, as under flax's ``param_dtype=f32``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch
from torch import nn

from distributed_deep_learning_tpu_torch import resolve_device

#: optax's defaults for adam/adamw
BETAS, EPS = (0.9, 0.999), 1e-8


def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm``, and
    stays as it is below it (``clip_grad_norm_`` would add 1e-6 to the
    norm and scale below it too).  No host sync."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style recipe: ``kind`` is sgd, momentum (0.9), adam or
    adamw; ``learning_rate`` a float or a schedule of the update count;
    ``weight_decay`` applies (decoupled, scaled by the learning rate) to
    the parameters ``decay_mask(name, param)`` selects (all of them
    without a mask, as in optax); ``clip_norm``
    clips the gradients' global norm first."""

    kind: str
    learning_rate: float | Callable[[int], float]
    weight_decay: float = 0.0
    decay_mask: Callable[[str, torch.Tensor], bool] | None = None
    clip_norm: float | None = None

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, named_params: Iterable) -> torch.optim.Optimizer:
        named = [(n, p) for n, p in named_params if p.requires_grad]
        params = [p for _, p in named]
        lr = self.lr_at(0)
        if self.kind == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if self.kind == "momentum":
            # optax trace: t = g + 0.9 t, update -lr t; torch's buffer
            # starts at g and follows the same recurrence
            return torch.optim.SGD(params, lr=lr, momentum=0.9)
        if self.kind == "adam":
            return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)
        if self.kind == "adamw":
            # torch's AdamW and optax.adamw coincide: eps is added to
            # sqrt of the bias-corrected second moment, and the decay is
            # decoupled and scaled by the (scheduled) learning rate:
            # p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
            mask = self.decay_mask or (lambda n, p: True)
            decay = [p for n, p in named if mask(n, p)]
            rest = [p for n, p in named if not mask(n, p)]
            return torch.optim.AdamW(
                [{"params": decay, "weight_decay": self.weight_decay},
                 {"params": rest, "weight_decay": 0.0}],
                lr=lr, betas=BETAS, eps=EPS)
        raise ValueError(f"unknown optimizer kind {self.kind!r}")


@dataclasses.dataclass
class TrainState:
    """The module, its optimizer, the recipe it was built from, the number
    of updates applied and the dropout generator (None without dropout)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Optimizer
    step: int = 0
    generator: torch.Generator | None = None

    def apply_gradients(self) -> None:
        """Clip, set the learning rate for this update's count, step."""
        if self.tx.clip_norm is not None:
            clip_by_global_norm([p.grad for g in self.optimizer.param_groups
                                 for p in g["params"] if p.grad is not None],
                                self.tx.clip_norm)
        lr = self.tx.lr_at(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, seed: int, tx: Optimizer,
                       init_state_dict: dict | None = None, *,
                       device="cuda",
                       dropout_seed: int | None = None) -> TrainState:
    """Initialise ``model`` from ``seed`` (its ``reset_parameters``), or
    load ``init_state_dict`` over it (the tests carry JAX weights across
    with ``load_flax_params``), move it to ``device`` (``cuda`` unless the
    caller asks for the CPU; raises without a card) and build the
    optimizer.  ``dropout_seed`` seeds the dropout generator on ``device``
    (None: no generator, for models without dropout)."""
    device = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    model.to(device)
    gen = None
    if dropout_seed is not None:
        gen = torch.Generator(device=device).manual_seed(dropout_seed)
    return TrainState(model=model, optimizer=tx.build(model.named_parameters()),
                      tx=tx, generator=gen)
