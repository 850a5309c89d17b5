"""The ``mlp`` workload's model: the port of
``distributed_deep_learning_tpu/models/mlp.py`` (reference
``src/pytorch/MLP/model.py:23-76``).

``Dense(hidden) → ReLU → [Dense(hidden) → ReLU] × num_hidden_layers →
Dense(classes)``, emitting logits; ``double_softmax`` adds the reference's
head activation (softmax, sigmoid when ``classes < 2``), quirk Q4.  The
input width comes from the data (quirk Q6), so torch takes it at
construction (``in_features``) where flax infers it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import (Dense,
                                                               dense_state,
                                                               reset_all,
                                                               run_layers)


class DenseReLU(nn.Module):
    """Dense + ReLU as one layer (the reference pairs them)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = Dense(in_features, features)

    def forward(self, x):
        return torch.relu(self.dense(x))

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        """The staged flax layer's ``Dense_0`` → ``dense``."""
        return dense_state(params["Dense_0"], "dense")


class DenseHead(nn.Module):
    def __init__(self, in_features: int, features: int,
                 double_softmax: bool = False):
        super().__init__()
        self.dense = Dense(in_features, features)
        self.double_softmax = double_softmax

    def forward(self, x):
        x = self.dense(x)
        if self.double_softmax:
            x = torch.sigmoid(x) if x.shape[-1] < 2 else \
                torch.softmax(x, dim=-1)
        return x.float()

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        """The staged flax layer's ``Dense_0`` → ``dense``."""
        return dense_state(params["Dense_0"], "dense")


def mlp_layer_sequence(in_features: int, hidden_size: int = 38,
                       num_hidden_layers: int = 1, num_classes: int = 5,
                       double_softmax: bool = False) -> list[nn.Module]:
    """in + hidden + out layers, the reference's count."""
    layers: list[nn.Module] = [DenseReLU(in_features, hidden_size)]
    layers += [DenseReLU(hidden_size, hidden_size)
               for _ in range(num_hidden_layers)]
    layers.append(DenseHead(hidden_size, num_classes, double_softmax))
    return layers


class MLP(nn.Module):
    """The MLP with the flax model's fields; ``dtype`` is the compute
    dtype (f32 parameters)."""

    def __init__(self, in_features: int, hidden_size: int = 38,
                 num_hidden_layers: int = 1, num_classes: int = 5,
                 double_softmax: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_hidden_layers, self.dtype = num_hidden_layers, dtype
        self.layers = nn.ModuleList(mlp_layer_sequence(
            in_features, hidden_size, num_hidden_layers, num_classes,
            double_softmax))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``Dense`` initialisers: ``lecun_normal``, zero bias."""
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        return run_layers(self.layers, x.to(self.dtype), remat)


def load_flax_variables(variables) -> dict:
    """``state_dict`` for :class:`MLP` from flax's ``{"params": ...}``
    (numpy arrays): each ``Dense`` kernel ``(in, out)`` → ``(out, in)``."""
    params = variables["params"]
    sd, i = {}, 0
    while f"DenseReLU_{i}" in params:
        sd.update(dense_state(params[f"DenseReLU_{i}"]["Dense_0"],
                              f"layers.{i}.dense"))
        i += 1
    sd.update(dense_state(params["DenseHead_0"]["Dense_0"],
                          f"layers.{i}.dense"))
    return sd
