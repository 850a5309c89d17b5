"""Building blocks of the conv and BatchNorm models (``mlp``, ``cnn``,
``lstm``, ``mnist``, ``resnet``): flax's initialisers, ``Dense`` and
``Conv`` layers that compute in their input's dtype over f32 parameters
(flax's ``dtype=...`` with ``param_dtype=f32``), and the ``--remat``
driver of a layer sequence.

Initialisers draw from a ``torch.Generator`` (the port cannot reproduce
JAX's random streams, only their distributions): flax's
``variance_scaling(scale, "fan_in", "truncated_normal")`` is a normal
truncated to two standard deviations, rescaled so that the truncated
distribution keeps the variance ``scale / fan_in``; ``lecun_normal`` is
scale 1 and ``he_normal`` scale 2.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_deep_learning_tpu_torch.utils.config import ROADMAP_ITEMS

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                      generator: Optional[torch.Generator] = None):
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = (scale / max(1, fan_in)) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal_(w, fan_in, generator=None):
    return variance_scaling_(w, 1.0, fan_in, generator)


def he_normal_(w, fan_in, generator=None):
    return variance_scaling_(w, 2.0, fan_in, generator)


class Dense(nn.Linear):
    """flax ``Dense``: ``lecun_normal`` kernel, zero bias, computed in the
    input's dtype."""

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """flax ``Conv`` on an NCHW view: ``init(weight, fan_in, generator)``
    draws the kernel (``lecun_normal`` unless given), zero bias; computed
    in the input's dtype."""

    def __init__(self, *args, init=lecun_normal_, **kw):
        self._init = init
        super().__init__(*args, **kw)

    def reset_parameters(self, generator=None):
        kh, kw = self.kernel_size
        self._init(self.weight, kh * kw * self.in_channels, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, self.padding)


def reset_all(model: nn.Module, generator: Optional[torch.Generator]):
    """Every submodule's ``reset_parameters(generator)`` in registration
    order (a module without one is skipped)."""
    for mod in model.modules():
        if mod is not model and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


# --- flax weights -----------------------------------------------------------

def as_tensor(x):
    """A float32 tensor copy of a numpy array."""
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def conv2d_weight(kernel) -> torch.Tensor:
    """flax ``Conv`` kernel ``(kh, kw, in, out)`` → ``(out, in, kh, kw)``."""
    return as_tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def dense_state(node, prefix: str) -> dict:
    """flax ``Dense`` ``(in, out)`` kernel and bias → ``nn.Linear``'s."""
    sd = {f"{prefix}.weight": as_tensor(np.asarray(node["kernel"]).T)}
    if "bias" in node:
        sd[f"{prefix}.bias"] = as_tensor(node["bias"])
    return sd


# --- --remat ----------------------------------------------------------------

#: per thread: the recompute runs in whichever thread runs the backward
_state = threading.local()


def recomputing() -> bool:
    """True while ``--remat``'s backward recomputes a layer in this
    thread: a layer with running statistics must not update them a second
    time."""
    return getattr(_state, "recomputing", False)


@contextlib.contextmanager
def _recompute():
    before, _state.recomputing = recomputing(), True
    try:
        yield
    finally:
        _state.recomputing = before


def sow_loss(value: torch.Tensor) -> None:
    """flax's ``self.sow("losses", ...)``: add ``value`` to the losses
    that :func:`collect_losses` gathers in this thread; a no-op outside
    one (evaluation, and a ``--remat`` recompute, which runs in the
    backward after the train step's forward has closed its collection)."""
    sink = getattr(_state, "losses", None)
    if sink is not None:
        sink.append(value)


@contextlib.contextmanager
def collect_losses():
    """Gather the losses a forward sows (:func:`sow_loss`) into the
    yielded list, as the JAX package's train state makes the ``losses``
    collection mutable for a train step's apply."""
    before, _state.losses = getattr(_state, "losses", None), []
    try:
        yield _state.losses
    finally:
        _state.losses = before


def run_layers(layers: Sequence[Callable], x, remat: Optional[str] = None):
    """``x`` through ``layers`` in order.  ``remat="nothing"`` keeps only
    each layer's input and recomputes the layer in the backward
    (``torch.utils.checkpoint``), with :func:`recomputing` true during the
    recompute; the other policies keep matmul outputs, which these models'
    convolutions and BatchNorms are not, so they are refused."""
    if remat is not None and remat != "nothing":
        raise NotImplementedError(
            f"--remat-policy {remat} is not ported for this workload (only "
            f"'nothing'): {ROADMAP_ITEMS[16]}")
    for layer in layers:
        if remat is None or not torch.is_grad_enabled():
            x = layer(x)
            continue
        ran = []

        def replay(x, layer=layer, ran=ran):
            if not ran:                  # the forward
                ran.append(True)
                return layer(x)
            with _recompute():
                return layer(x)

        x = checkpoint(replay, x, use_reentrant=False)
    return x
