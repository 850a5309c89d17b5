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

SGD, momentum, Adam and AdamW are torch's, which compute what optax's do.
LAMB and Adafactor have no torch counterpart with optax's semantics, so
:class:`Lamb` and :class:`Adafactor` are written here from optax 0.2.6's
``lamb`` and ``adafactor`` with their defaults.  Adafactor factors a
parameter's second moment over the two largest axes of its FLAX shape
(the model's ``flax_layout``), which is not the shape of the torch tensor
for the attention projections.

Sharded parameters (``--zero fsdp``'s DTensors, tensor parallelism's
slices: :mod:`..parallel.shards`) keep every statistic a statistic of the
whole parameter, as XLA computes it over the logical array: the clip's
global norm and LAMB's norms sum each rank's part over its group, and
Adafactor takes its factored moments of the gathered whole parameter and
applies this rank's part of the update (its state is kept whole).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.parallel.shards import (
    local, local_part, shard_groups, whole, whole_sum)
from distributed_deep_learning_tpu_torch.train.schedules import step_decay

#: optax's defaults for adam/adamw
BETAS, EPS = (0.9, 0.999), 1e-8
#: optax.lamb's eps (its betas are BETAS)
LAMB_EPS = 1e-6
#: optax.adafactor's defaults: factor when the second-largest axis has at
#: least this many entries, the decay exponent, the epsilon added to g**2,
#: the update's RMS clip and the least parameter scale
ADAFACTOR_MIN_DIM, ADAFACTOR_DECAY_RATE, ADAFACTOR_EPS = 128, 0.8, 1e-30
ADAFACTOR_CLIP, ADAFACTOR_MIN_SCALE = 1.0, 1e-3


def global_norm(grads: list, params: list | None = None) -> torch.Tensor:
    """``optax.global_norm`` of ``grads`` (an f32 device scalar, no host
    sync).  ``params`` (the gradients' parameters) makes it the norm of
    the whole parameters when some are split across ranks: each group's
    squared sums are summed over it once."""
    if params is None or not any(shard_groups(p) for p in params):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(local(g).float()) for g in grads]))
    by_groups: dict = {}
    for p, g in zip(params, grads):
        key = tuple(shard_groups(p))
        sq = local(g).float().pow(2).sum()
        by_groups[key] = by_groups.get(key, 0) + sq
    total = 0
    for key, sq in by_groups.items():
        for group in key:
            torch.distributed.all_reduce(sq, group=group)
        total = total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float,
                        params: list | None = None) -> None:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm (:func:`global_norm`)
    reaches ``max_norm``, and stays as it is below it
    (``clip_grad_norm_`` would add 1e-6 to the norm and scale below it
    too).  No host sync."""
    if not grads:
        return
    norm = global_norm(grads, params)
    keep = norm < max_norm
    for g in grads:
        g = local(g)
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: Adam's bias-corrected direction ``m / (sqrt(v) +
    eps)``, plus ``weight_decay * p`` on the decayed parameters, scaled by
    each parameter's trust ratio ``|p| / |u|`` (1 where either norm is 0),
    times the learning rate.  The decay is per parameter group.  A split
    parameter's moments are its local part (``local_state``)."""

    local_state = True

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        (b1, b2), eps = BETAS, LAMB_EPS
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(local(p))
                    st["nu"] = torch.zeros_like(local(p))
                g, w = local(p.grad), local(p)
                st["count"] += 1
                t = st["count"]
                mu = st["mu"].copy_((1 - b1) * g + b1 * st["mu"])
                nu = st["nu"].copy_((1 - b2) * g * g + b2 * st["nu"])
                u = (mu / (1 - b1 ** t)) / (
                    torch.sqrt(nu / (1 - b2 ** t)) + eps)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * w
                if shard_groups(p):
                    # the whole parameter's norms: sum the parts' squares
                    sq = whole_sum(p, torch.stack([w.pow(2).sum(),
                                                   u.pow(2).sum()]))
                    pn, un = torch.sqrt(sq[0]), torch.sqrt(sq[1])
                else:
                    pn, un = torch.linalg.vector_norm(w), \
                        torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                w.sub_(group["lr"] * (u * ratio))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` at its defaults: a second moment factored into
    row and column means when the flax shape's second-largest axis has at
    least ``ADAFACTOR_MIN_DIM`` entries (elementwise otherwise), with the
    decay ``1 - (t + 1) ** -0.8``; the update clipped to a block RMS of 1,
    times the learning rate and the parameter's RMS (at least 1e-3).
    ``layouts`` maps a parameter to its ``(to_flax, from_flax)`` pair.
    A split parameter's gradient and value are gathered whole first, and
    its part of the update applied (the state is the whole
    parameter's: ``whole_state``)."""

    whole_state = True

    def __init__(self, params, lr, layouts=None):
        super().__init__(params, dict(lr=lr))
        self.layouts = layouts or {}

    @staticmethod
    def factored_dims(shape):
        """``(d1, d0)``: the second-largest and largest axes of a flax
        shape, or None when it is not factored (optax's rule)."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < ADAFACTOR_MIN_DIM:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                to_flax, from_flax = self.layouts.get(p, (_same, _same))
                split = bool(shard_groups(p))
                p_whole = whole(p, p.detach()) if split else p
                g = to_flax(whole(p, p.grad) if split else p.grad)
                dims = self.factored_dims(tuple(g.shape))
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    if dims is None:
                        st["v"] = torch.zeros_like(g)
                    else:
                        d1, d0 = dims
                        st["v_row"] = g.new_zeros(
                            [n for i, n in enumerate(g.shape) if i != d0])
                        st["v_col"] = g.new_zeros(
                            [n for i, n in enumerate(g.shape) if i != d1])
                decay = 1.0 - float(np.float32(st["count"] + 1)
                                    ** np.float32(-ADAFACTOR_DECAY_RATE))
                st["count"] += 1
                grad_sqr = g * g + ADAFACTOR_EPS
                if dims is None:
                    v = st["v"].copy_(decay * st["v"]
                                      + (1.0 - decay) * grad_sqr)
                    u = g * v ** -0.5
                else:
                    d1, d0 = dims
                    row = st["v_row"].copy_(
                        decay * st["v_row"]
                        + (1.0 - decay) * grad_sqr.mean(d0))
                    col = st["v_col"].copy_(
                        decay * st["v_col"]
                        + (1.0 - decay) * grad_sqr.mean(d1))
                    rd1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (row / row.mean(rd1, keepdim=True)) ** -0.5
                    u = g * row_factor.unsqueeze(d0) \
                        * (col ** -0.5).unsqueeze(d1)
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
                p_rms = torch.sqrt(torch.mean(p_whole * p_whole))
                u = u * group["lr"] * torch.where(
                    p_rms <= ADAFACTOR_MIN_SCALE,
                    torch.full_like(p_rms, ADAFACTOR_MIN_SCALE), p_rms)
                if split:
                    local(p).sub_(local_part(p, from_flax(u)))
                else:
                    p.sub_(from_flax(u))


def _same(t):
    return t


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style recipe: ``kind`` is sgd, momentum (0.9), adam,
    adamw, lamb or adafactor; ``learning_rate`` a float or a schedule of
    the update count; ``weight_decay`` applies (decoupled, scaled by the
    learning rate) to the parameters ``decay_mask(name, param)`` selects
    (all of them without a mask, as in optax); ``clip_norm``
    clips the gradients' global norm first."""

    kind: str
    learning_rate: float | Callable[[int], float]
    weight_decay: float = 0.0
    decay_mask: Callable[[str, torch.Tensor], bool] | None = None
    clip_norm: float | None = None

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, named_params: Iterable,
              layout: Callable | None = None) -> torch.optim.Optimizer:
        """The torch optimizer over ``named_params``; ``layout(name)``
        gives a parameter's ``(to_flax, from_flax)`` pair (Adafactor's
        factoring reads the flax shape)."""
        cls, params, kwargs = self.parts(named_params, layout)
        return cls(params, **kwargs)

    def parts(self, named_params: Iterable, layout: Callable | None = None
              ) -> tuple[type, list, dict]:
        """``(class, params or param groups, keyword arguments)`` of the
        torch optimizer :meth:`build` makes (what a wrapper such as
        ZeRO's builds it from)."""
        named = [(n, p) for n, p in named_params if p.requires_grad]
        params = [p for _, p in named]
        lr = self.lr_at(0)
        mask = self.decay_mask or (lambda n, p: True)
        groups = [{"params": [p for n, p in named if mask(n, p)],
                   "weight_decay": self.weight_decay},
                  {"params": [p for n, p in named if not mask(n, p)],
                   "weight_decay": 0.0}]
        if self.kind == "sgd":
            return torch.optim.SGD, params, dict(lr=lr)
        if self.kind == "momentum":
            # optax trace: t = g + 0.9 t, update -lr t; torch's buffer
            # starts at g and follows the same recurrence
            return torch.optim.SGD, params, dict(lr=lr, momentum=0.9)
        if self.kind == "adam":
            return torch.optim.Adam, params, dict(lr=lr, betas=BETAS,
                                                  eps=EPS)
        if self.kind == "adamw":
            # torch's AdamW and optax.adamw coincide: eps is added to
            # sqrt of the bias-corrected second moment, and the decay is
            # decoupled and scaled by the (scheduled) learning rate:
            # p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
            return torch.optim.AdamW, groups, dict(lr=lr, betas=BETAS,
                                                   eps=EPS)
        if self.kind == "lamb":
            return Lamb, groups, dict(lr=lr)
        if self.kind == "adafactor":
            layouts = {p: layout(n) for n, p in named} if layout else None
            return Adafactor, params, dict(lr=lr, layouts=layouts)
        raise ValueError(f"unknown optimizer kind {self.kind!r}")


def reference_optimizer(workload: str, learning_rate: float | None = None,
                        epoch_steps: int | None = None) -> Optimizer:
    """The reference's optimizer per workload, as the JAX package builds it:

    * ``cnn``: SGD with momentum 0.9 at 0.01, ×0.1 every 7 epochs
      (``optax.exponential_decay(staircase=True)`` over ``epoch_steps``);
    * ``mlp``, ``lstm``: Adam at 1e-3 (optax's defaults)."""
    if workload.lower() == "cnn":
        lr = 0.01 if learning_rate is None else learning_rate
        sched = step_decay(lr, steps_per_drop=7 * epoch_steps) \
            if epoch_steps else lr
        return Optimizer("momentum", sched)
    return Optimizer("adam", 1e-3 if learning_rate is None
                     else learning_rate)


@dataclasses.dataclass
class TrainState:
    """The module, its optimizer, the recipe it was built from, the number
    of updates applied and the dropout generator (None without dropout).
    ``comm_residual`` is this rank's int8 error-feedback buffer (a tensor
    a parameter, by name; JAX's ``TrainState.comm_residual``), and
    ``comm`` the party that synchronises the gradients when it is not
    DDP's default all-reduce (``train.compress.GradCompression`` or
    ``parallel.collectives.ExplicitFSDP``), else None.  ``sentinel`` is
    the anomaly sentinel's :class:`..train.sentinel.SentinelState` (None
    without ``--sentinel``); ``fence`` is the CUDA event of an
    asynchronous checkpoint's copy that the next update waits for
    (:class:`..utils.checkpoint.Checkpointer`)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Optimizer
    step: int = 0
    generator: torch.Generator | None = None
    comm_residual: dict | None = None
    comm: object = None
    sentinel: object = None
    fence: object = None

    def grad_params(self) -> list:
        """The optimizer's parameters that hold a gradient."""
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def wait_fence(self) -> None:
        """Make the card wait for a pending ``fence`` (a CUDA event an
        asynchronous checkpoint's copy of this state recorded; its
        ``wait()`` holds the current stream) before anything writes the
        saved tensors in place."""
        if self.fence is not None:
            self.fence.wait()
            self.fence = None

    def apply_gradients(self) -> None:
        """Clip, set the learning rate for this update's count, step,
        after :meth:`wait_fence`: the in-place update cannot reach the
        bytes an asynchronous save is copying."""
        self.wait_fence()
        if self.tx.clip_norm is not None:
            params = self.grad_params()
            clip_by_global_norm([p.grad for p in params], self.tx.clip_norm,
                                params)
        lr = self.tx.lr_at(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, seed: int, tx: Optimizer,
                       init_state_dict: dict | None = None, *,
                       device="cuda",
                       dropout_seed: int | None = None,
                       shard: Callable | None = None) -> TrainState:
    """Initialise ``model`` from ``seed`` (its ``reset_parameters``), or
    load ``init_state_dict`` over it (the tests carry JAX weights across
    with ``load_flax_params``), move it to ``device`` (``cuda`` unless the
    caller asks for the CPU; raises without a card), split it across
    ranks with ``shard(model)`` when given (tensor parallelism, FSDP),
    and build the optimizer.  ``dropout_seed`` seeds the dropout
    generator on ``device`` (None: no generator, for models without
    dropout)."""
    device = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    model.to(device)
    if shard is not None:
        model = shard(model)
    gen = None
    if dropout_seed is not None:
        gen = torch.Generator(device=device).manual_seed(dropout_seed)
    optimizer = tx.build(model.named_parameters(),
                         layout=getattr(model, "flax_layout", None))
    return TrainState(model=model, optimizer=optimizer, tx=tx, generator=gen)
