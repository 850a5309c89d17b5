"""The ``lstm`` workload's CNN-LSTM: the port of
``distributed_deep_learning_tpu/models/cnn_lstm.py`` (reference
``src/pytorch/LSTM/model.py``).

The input window is ``(batch, history=10, features=32)``; ``Conv1d(10 →
64, k=1)`` with a bias treats the time axis as channels, so the 64 conv
channels become the LSTM's sequence axis and the 32 feature columns its
input width (the reference's layout quirk).  Then ``ReLU`` (the
reference's ``MaxPool1d(1) + ReLU``, kept as a layer), ``LSTM(32 → H)``,
``[LSTM(H → H)] × (n - 1)``, the last layer's final hidden state ``h``
(flax's carry is ``(c, h)``) and ``Dense(H → 5)``.  No softmax: the
workload regresses 5 targets with L1 (quirk Q5).

:class:`LSTMLayer` holds flax ``OptimizedLSTMCell``'s parameter set: per
gate an input kernel with no bias and a hidden kernel with one, gate order
i, f, g, o, stacked row-wise as torch's LSTM stacks them
(``weight_ih (4H, in)``, ``weight_hh (4H, H)``, ``bias (4H)``).  torch's
LSTM has two biases a gate; a second trainable bias would change Adam's
trajectory (it would get the same gradient and move twice as far).  So
the layer runs ``torch.lstm``, cuDNN's fused LSTM on the card, with a zero
tensor as its input bias: one library call a layer for all 64 steps, where
an explicit loop would launch a dozen kernels a step.  The JAX layer is a
``lax.scan``, not a Pallas kernel, so a library LSTM is its counterpart as
``torch.matmul`` is a ``Dense``'s.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import (
    Dense, as_tensor, dense_state, lecun_normal_, recomputable, reset_all,
    run_layers)

GATES = ("i", "f", "g", "o")


class PdMConvStem(nn.Module):
    """Conv1d(history → conv_features, k=1) + ReLU over the time-as-channels
    layout: ``(B, history, F)`` → ``(B, conv_features, F)``."""

    def __init__(self, history: int = 10, conv_features: int = 64):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(conv_features, history, 1))
        self.bias = nn.Parameter(torch.zeros(conv_features))

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.relu(recomputable(
            F.conv1d, x, recomputable(self.weight.to, x.dtype),
            recomputable(self.bias.to, x.dtype), kind="conv"))

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        """flax ``Conv`` kernel ``(1, history, C)`` → ``(C, history, 1)``."""
        conv = params["Conv_0"]
        return {"weight": as_tensor(
                    np.asarray(conv["kernel"]).transpose(2, 1, 0)),
                "bias": as_tensor(conv["bias"])}


class PoolReLU(nn.Module):
    """MaxPool1d(kernel=1) + ReLU: a no-op on non-negative inputs, a layer
    of its own as in the reference."""

    def forward(self, x):
        return F.relu(x)


class LSTMLayer(nn.Module):
    """One LSTM layer over ``(B, T, in)`` with zero initial state; returns
    the sequence ``(B, T, H)``, or the final hidden state ``(B, H)`` with
    ``return_state``."""

    def __init__(self, input_size: int, hidden_size: int = 128,
                 return_state: bool = False):
        super().__init__()
        self.hidden_size, self.return_state = hidden_size, return_state
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))

    def reset_parameters(self, generator=None):
        """flax's: ``lecun_normal`` input kernels, an orthogonal hidden
        kernel per gate, zero biases."""
        H = self.hidden_size
        with torch.no_grad():
            for j in range(4):
                lecun_normal_(self.weight_ih[j * H:(j + 1) * H],
                              self.weight_ih.shape[1], generator)
                nn.init.orthogonal_(self.weight_hh[j * H:(j + 1) * H],
                                    generator=generator)
            self.bias.zero_()

    def forward(self, x):
        B, H = x.shape[0], self.hidden_size
        state = x.new_zeros(1, B, H)
        # the LSTM's gate products lie inside its one op, whose output
        # every remat policy keeps
        params = [recomputable(self.weight_ih.to, x.dtype),
                  recomputable(self.weight_hh.to, x.dtype),
                  torch.zeros_like(self.bias, dtype=x.dtype),
                  recomputable(self.bias.to, x.dtype)]
        with warnings.catch_warnings():
            # cuDNN copies weights that are not one flat buffer
            warnings.filterwarnings("ignore", message="RNN module weights")
            out, h, _ = torch.lstm(x, (state, state), params, True, 1, 0.0,
                                   self.training, False, True)
        return h[0] if self.return_state else out

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        """flax ``OptimizedLSTMCell``'s per-gate kernels, stacked
        transposed in gate order, and its hidden biases."""
        cell = params["OptimizedLSTMCell_0"]
        return {
            "weight_ih": as_tensor(np.concatenate(
                [np.asarray(cell[f"i{g}"]["kernel"]).T for g in GATES])),
            "weight_hh": as_tensor(np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in GATES])),
            "bias": as_tensor(np.concatenate(
                [np.asarray(cell[f"h{g}"]["bias"]) for g in GATES]))}


class RegressionHead(nn.Module):
    def __init__(self, in_features: int, num_targets: int = 5):
        super().__init__()
        self.dense = Dense(in_features, num_targets)

    def forward(self, x):
        return self.dense(x).float()

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return dense_state(params["Dense_0"], "dense")


def cnn_lstm_layer_sequence(hidden_layers: int = 1, hidden_size: int = 128,
                            num_targets: int = 5, conv_features: int = 64,
                            history: int = 10, num_features: int = 32
                            ) -> list[nn.Module]:
    """``hidden_layers + 3`` layers, the reference's count."""
    if hidden_layers < 1:
        raise ValueError("model requires at least one hidden layer")
    layers: list[nn.Module] = [PdMConvStem(history, conv_features),
                               PoolReLU()]
    for i in range(hidden_layers):
        layers.append(LSTMLayer(num_features if i == 0 else hidden_size,
                                hidden_size,
                                return_state=i == hidden_layers - 1))
    layers.append(RegressionHead(hidden_size, num_targets))
    return layers


class CNNLSTM(nn.Module):
    """The CNN-LSTM with the flax model's fields; ``history`` and
    ``num_features`` are the input window's shape (flax infers them);
    ``dtype`` is the compute dtype (f32 parameters)."""

    def __init__(self, hidden_layers: int = 1, hidden_size: int = 128,
                 num_targets: int = 5, conv_features: int = 64,
                 history: int = 10, num_features: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_layers, self.dtype = hidden_layers, dtype
        self.layers = nn.ModuleList(cnn_lstm_layer_sequence(
            hidden_layers, hidden_size, num_targets, conv_features, history,
            num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        return run_layers(self.layers, x.to(self.dtype), remat)


def load_flax_variables(variables) -> dict:
    """``state_dict`` for :class:`CNNLSTM` from flax's ``{"params": ...}``
    (numpy arrays): the ``Conv`` kernel ``(1, history, C)`` →
    ``(C, history, 1)``; each LSTM's 8 per-gate kernels ``(in, H)``,
    ``(H, H)`` stacked transposed in gate order i, f, g, o, and its 4
    hidden biases into one ``(4H,)``."""
    params = variables["params"]
    sd = {f"layers.0.{k}": v for k, v in
          PdMConvStem.flax_state(params["PdMConvStem_0"]).items()}
    i = 0
    while f"LSTMLayer_{i}" in params:
        sd.update({f"layers.{i + 2}.{k}": v for k, v in
                   LSTMLayer.flax_state(params[f"LSTMLayer_{i}"]).items()})
        i += 1
    sd.update(dense_state(params["RegressionHead_0"]["Dense_0"],
                          f"layers.{i + 2}.dense"))
    return sd
