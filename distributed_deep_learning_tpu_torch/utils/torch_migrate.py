"""Load the reference's torch checkpoints (``src/pytorch/{MLP,CNN,LSTM}``)
into the port's models: the counterpart of
``distributed_deep_learning_tpu/utils/torch_migrate.py``.

Both sides are torch, so nothing is transposed: a ``Linear``, ``Conv1d``
or ``Conv2d`` weight keeps its layout, a BatchNorm's
``weight/bias/running_mean/running_var`` map one to one
(``num_batches_tracked`` is dropped), and torch's LSTM ``(i, f, g, o)``
row blocks are the port's; only its two biases a gate are summed into the
port's one (:class:`..models.cnn_lstm.LSTMLayer` keeps flax's parameter
set).

Matching is positional by type, as in the JAX importers: ``state_dict()``
keeps registration order, which for the reference models is forward
order, and so does every port model; so the checkpoint's typed groups
are consumed in order against the port model's, whatever the
reference's attribute names.  A module registered twice (the reference's
``WrapperTriton``, ``CNN/model.py:72``) appears twice in its
``state_dict``; the duplicate is dropped by storage pointer, or by value
after a numpy round trip.  Every group is checked for kind and shape.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn

from distributed_deep_learning_tpu_torch.models.cnn_lstm import (
    LSTMLayer, PdMConvStem)
from distributed_deep_learning_tpu_torch.models.densenet import BatchNorm

_BN = ("weight", "bias", "running_mean", "running_var")
_LSTM = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _ptr(val):
    return val.data_ptr() if isinstance(val, torch.Tensor) else None


def _fingerprint(leaves: dict) -> tuple:
    return tuple((name, leaves[name].shape, str(leaves[name].dtype),
                  hashlib.sha256(np.ascontiguousarray(
                      leaves[name]).tobytes()).hexdigest())
                 for name in sorted(leaves))


def reference_groups(state_dict) -> list[tuple[str, dict]]:
    """Insertion-ordered ``(kind, arrays)`` groups of a reference
    checkpoint: ``linear``, ``conv1d``, ``conv2d``, ``bn`` and ``lstm``
    (one group a stacked layer), aliased registrations dropped."""
    raw: dict[str, dict] = {}
    ptrs: dict[str, set] = {}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        raw.setdefault(prefix, {})[leaf] = val
        ptrs.setdefault(prefix, set()).add(_ptr(val))
    have_ptrs = all(None not in s for s in ptrs.values())
    groups: list[tuple[str, dict]] = []
    seen_ptrs: set = set()
    seen_values: set = set()
    for prefix, leaves in raw.items():
        if have_ptrs and ptrs[prefix] <= seen_ptrs:
            continue                # every tensor aliases an earlier group
        seen_ptrs |= ptrs[prefix]
        g = {k: _to_np(v) for k, v in leaves.items()}
        if not have_ptrs:
            fp = _fingerprint(g)
            if fp in seen_values:
                continue            # an exact whole-group duplicate
            seen_values.add(fp)
        if "running_mean" in g:
            groups.append(("bn", {k: g[k] for k in _BN}))
        elif "weight_ih_l0" in g:
            layer, used = 0, set()
            while f"weight_ih_l{layer}" in g:
                names = [f"{n}_l{layer}" for n in _LSTM]
                groups.append(("lstm", {n: g[k] for n, k in
                                        zip(_LSTM, names)}))
                used.update(names)
                layer += 1
            if set(g) - used:
                raise ValueError(
                    f"LSTM group has unsupported leaves "
                    f"{sorted(set(g) - used)} (bidirectional or proj_size "
                    "checkpoints have no counterpart in the port's LSTM)")
        elif "weight" in g and g["weight"].ndim in (2, 3, 4):
            kind = {2: "linear", 3: "conv1d", 4: "conv2d"}[g["weight"].ndim]
            groups.append((kind, g))
    return groups


def _port_groups(model: nn.Module) -> list[tuple[str, str, nn.Module]]:
    """``(kind, prefix, module)`` of the port model's weight-holding
    modules, in registration order."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            out.append(("bn", name, mod))
        elif isinstance(mod, LSTMLayer):
            out.append(("lstm", name, mod))
        elif isinstance(mod, PdMConvStem):
            out.append(("conv1d", name, mod))
        elif isinstance(mod, nn.Conv2d):
            out.append(("conv2d", name, mod))
        elif isinstance(mod, nn.Linear):
            out.append(("linear", name, mod))
    return out


def state_dict_from_reference(model: nn.Module, state_dict) -> dict:
    """The port ``model``'s ``state_dict`` from a reference checkpoint of
    the same family (MLP, DenseNet-BC or CNN-LSTM) and size.  Raises
    ``ValueError`` on a group of another kind, a shape that differs, or
    groups left over on either side."""
    groups = reference_groups(state_dict)
    port = _port_groups(model)
    if len(groups) != len(port):
        raise ValueError(
            f"the checkpoint has {len(groups)} parameter groups and the "
            f"model {len(port)}: a model configuration (layers, blocks) "
            "of another size than the checkpoint's")
    own = model.state_dict()
    sd = {}
    for i, ((kind, g), (want, prefix, _)) in enumerate(zip(groups, port)):
        if kind != want:
            raise ValueError(f"checkpoint group {i} is {kind!r}, the "
                             f"model's {prefix!r} expects {want!r}: is "
                             "this checkpoint of the model's family?")
        if kind == "lstm":
            g = {"weight_ih": g["weight_ih"], "weight_hh": g["weight_hh"],
                 "bias": g["bias_ih"] + g["bias_hh"]}
        for leaf, arr in g.items():
            key = f"{prefix}.{leaf}"
            if key not in own:
                raise ValueError(f"checkpoint leaf {leaf!r} has no "
                                 f"counterpart in the model's {prefix!r}")
            if tuple(own[key].shape) != arr.shape:
                raise ValueError(f"shape mismatch at {key}: checkpoint "
                                 f"{arr.shape}, model "
                                 f"{tuple(own[key].shape)}")
            sd[key] = torch.from_numpy(np.array(arr, np.float32))
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"the checkpoint leaves {missing[:5]} of the "
                         "model unset")
    return sd
