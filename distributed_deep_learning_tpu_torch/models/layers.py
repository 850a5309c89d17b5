"""Building blocks of the conv and BatchNorm models (``mlp``, ``cnn``,
``lstm``, ``mnist``, ``resnet``): flax's initialisers, ``Dense`` and
``Conv`` layers that compute in their input's dtype over f32 parameters
(flax's ``dtype=...`` with ``param_dtype=f32``), and ``--remat``: the
policies of every model family (:data:`REMAT_SAVED_OPS`,
:func:`remat_call`) and :func:`run_layers` over a layer sequence.

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
        return F.linear(x, recomputable(self.weight.to, x.dtype),
                        None if self.bias is None else
                        recomputable(self.bias.to, x.dtype))


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
        return recomputable(
            F.conv2d, x, recomputable(self.weight.to, x.dtype),
            None if self.bias is None else
            recomputable(self.bias.to, x.dtype), self.stride, self.padding,
            kind="conv")


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


#: ``--remat-policy`` -> the kinds of product whose outputs the backward
#: keeps, as JAX's policies of that name keep them: ``dots_saveable``
#: every ``dot_general`` and ``conv_general_dilated``,
#: ``dots_with_no_batch_dims_saveable`` only the products without a batch
#: dimension (a ``Dense`` over rows).  An output a layer marks
#: (:func:`recomputable`) of another kind, or of none, is computed again
#: in the backward.  The dense attention's batched products are marked
#: recomputed under either (the flash kernels have none to keep); an
#: LSTM's gate products lie inside its one op, whose output is kept under
#: either.  ``nothing`` recomputes every op of the layer.
REMAT_SAVED_OPS = {
    "nothing": (),
    "dots": ("Dense", "conv"),
    "dots_no_batch": ("Dense",),
}


class _Recompute:
    """The ``dots`` policies for one layer's forward: every tensor
    autograd saves passes through :meth:`pack`, and the outputs the layer
    marks recomputable (:func:`recomputable`: its norms, casts, attention,
    activations and pools, and under ``dots_no_batch`` its convolutions)
    are dropped when the layer's forward ends and computed again when the
    backward unpacks one of them.  A saved tensor is matched to a marked
    output by its storage (device and address, both alive until
    :meth:`finish`), so views of it (a reshape a matmul saves) are rebuilt
    from the recomputed tensor with the same strides; a marked output that
    another one's recipe reads is itself computed again for it."""

    active: Optional["_Recompute"] = None

    def __init__(self, kept=()):
        self.kept = kept       # the kinds of output kept (REMAT_SAVED_OPS)
        self.marked = []       # (tensor, fn, args)
        self.saved = []        # every pack's handle, resolved in finish()

    def mark(self, out, fn, args):
        # only a non-empty dense tensor that owns its whole storage, and
        # not an argument's (a view of it): anything else sharing that
        # storage is a view of it
        key = out.numel() and _storage_key(out)
        if key and all(_storage_key(a) != key for a in args
                       if isinstance(a, torch.Tensor) and a.numel()) and (
                out.is_contiguous() or out.is_contiguous(
                memory_format=torch.channels_last)) and \
                out.storage_offset() == 0 and \
                out.untyped_storage().nbytes() == \
                out.numel() * out.element_size():
            self.marked.append((out, fn, args))

    def pack(self, t):
        handle = [t, None]     # the tensor, or a recipe once finished
        self.saved.append(handle)
        return handle

    @staticmethod
    def unpack(handle):
        t, recipe = handle
        if recipe is None:
            return t
        return recipe.view(id(handle))

    def finish(self):
        recipes = {}
        for out, fn, args in self.marked:
            recipes[_storage_key(out)] = _Recipe(fn, args)

        def dropped(t):
            recipe = recipes.get(_storage_key(t)) \
                if isinstance(t, torch.Tensor) and t.numel() else None
            return t if recipe is None else _Dropped(recipe, t)

        for recipe in recipes.values():
            recipe.args = tuple(dropped(a) for a in recipe.args)
        for handle in self.saved:
            t = handle[0]
            recipe = recipes.get(_storage_key(t))
            if recipe is None:
                continue
            recipe.views[id(handle)] = (t.size(), t.stride(),
                                        t.storage_offset())
            recipe.waiting.add(id(handle))
            handle[:] = [None, recipe]
        self.marked = self.saved = None


def _storage_key(t):
    return t.device, t.untyped_storage().data_ptr()


class _Recipe:
    """How to compute one dropped output again, cached until each saved
    view of it has been unpacked once (a second backward through a
    retained graph computes it again at each unpack).  It is computed
    with :func:`recomputing` true, so no BatchNorm updates its running
    statistics a second time."""

    def __init__(self, fn, args):
        self.fn, self.args, self.out = fn, args, None
        self.views = {}        # handle id -> (size, stride, offset)
        self.waiting = set()   # handle ids not unpacked yet

    def value(self):
        out = self.out
        if out is None:
            with torch.no_grad(), _recompute():
                out = self.fn(*(a.value() if isinstance(a, _Dropped)
                                else a for a in self.args))
            self.out = out if self.waiting else None
        return out

    def view(self, key):
        out = self.value()
        self.waiting.discard(key)
        if not self.waiting:
            self.out = None
        return out.as_strided(*self.views[key])


class _Dropped:
    """A recipe's argument that is another dropped output (or a view of
    one): computed again from that output's recipe."""

    def __init__(self, recipe, t):
        self.recipe = recipe
        self.layout = (t.size(), t.stride(), t.storage_offset())

    def value(self):
        return self.recipe.value().as_strided(*self.layout)


def recomputable(fn, *args, kind: Optional[str] = None):
    """``fn(*args)``; under a ``dots`` policy the backward computes it
    again instead of keeping it (see :class:`_Recompute`), unless the
    policy keeps outputs of ``kind`` (``"conv"``: a convolution)."""
    out = fn(*args)
    rc = _Recompute.active
    if rc is not None and kind not in rc.kept and \
            out.grad_fn is not None and all(out is not a for a in args):
        rc.mark(out, fn, args)
    return out


def remat_call(fn, x, policy: str,
               generator: Optional[torch.Generator] = None):
    """``fn(x)`` with its activations recomputed in the backward, with
    :func:`recomputing` true while they are (no BatchNorm updates its
    running statistics twice); a recompute computes the same values, so
    the gradients are those of the run without remat.

    ``nothing``: ``torch.utils.checkpoint`` (non-reentrant) keeps only
    ``x`` and recomputes all of ``fn``.  ``checkpoint`` restores the
    default generators' state, not ``generator``'s, so the recompute
    rewinds ``generator`` to where the forward found it (the same dropout
    masks) and puts it back after.

    ``dots`` and ``dots_no_batch``: the outputs of the products the policy
    keeps (:data:`REMAT_SAVED_OPS`) stay, and what the layer marks
    recomputable is computed again when the backward needs it
    (:class:`_Recompute`, through saved-tensor hooks; no op-level
    dispatch).  Dropout masks are kept, so nothing random is replayed."""
    if policy not in REMAT_SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy!r}; choose from "
                         f"{'/'.join(REMAT_SAVED_OPS)}")
    if REMAT_SAVED_OPS[policy]:
        rc, outer = _Recompute(REMAT_SAVED_OPS[policy]), _Recompute.active
        _Recompute.active = rc
        try:
            with torch.autograd.graph.saved_tensors_hooks(rc.pack,
                                                          rc.unpack):
                y = fn(x)
        finally:
            _Recompute.active = outer
        rc.finish()
        return y
    before, ran = None if generator is None else generator.get_state(), []

    def replay(x):
        if not ran:                 # the forward: draw as usual
            ran.append(True)
            return fn(x)
        after = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(before)
        try:
            with _recompute():
                return fn(x)
        finally:
            if generator is not None:
                generator.set_state(after)

    return checkpoint(replay, x, use_reentrant=False)


def run_layers(layers: Sequence[Callable], x, remat: Optional[str] = None):
    """``x`` through ``layers`` in order; ``remat`` (a policy of
    :data:`REMAT_SAVED_OPS`) recomputes each layer in the backward
    (:func:`remat_call`)."""
    if remat is not None and remat not in REMAT_SAVED_OPS:
        raise ValueError(f"unknown remat policy {remat!r}; choose from "
                         f"{'/'.join(REMAT_SAVED_OPS)}")
    for layer in layers:
        if remat is None or not torch.is_grad_enabled():
            x = layer(x)
        else:
            x = remat_call(layer, x, remat)
    return x
