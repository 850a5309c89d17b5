"""Vision models of the north-star zoo: the port of
``distributed_deep_learning_tpu/models/resnet.py``, so far its
``MnistCNN`` (the ``mnist`` workload's model); the ResNets come with the
``resnet`` workload (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import (
    Conv2d, Dense, as_tensor, conv2d_weight, dense_state, reset_all,
    run_layers)


class MnistCNN(nn.Module):
    """The classic MNIST conv net over NHWC images: Conv3×3(32) → ReLU →
    MaxPool2 → Conv3×3(64) → ReLU → MaxPool2 → Flatten (NHWC order) →
    Dense(128) → ReLU → Dense(classes).  The convolutions are flax's
    default SAME padding (28 → 14 → 7, so 3136 features at 28×28)."""

    def __init__(self, num_classes: int = 10, image_shape=(28, 28, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, W, C = image_shape
        self.dtype = dtype
        self.conv0 = Conv2d(C, 32, 3, padding=1)
        self.conv1 = Conv2d(32, 64, 3, padding=1)
        self.dense0 = Dense((H // 2 // 2) * (W // 2 // 2) * 64, 128)
        self.dense1 = Dense(128, num_classes)
        self.to(memory_format=torch.channels_last)   # as in DenseNet

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisers: ``lecun_normal`` kernels, zero biases."""
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return run_layers((self._conv_pool0, self._conv_pool1,
                           self._hidden, self._head), x, remat)

    def _conv_pool0(self, x):
        return F.max_pool2d(F.relu(self.conv0(x)), 2, 2)

    def _conv_pool1(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 2, 2)

    def _hidden(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.dense0(x))

    def _head(self, x):
        return self.dense1(x).float()


def load_flax_variables(variables) -> dict:
    """``state_dict`` for :class:`MnistCNN` from flax's ``{"params": ...}``
    (numpy arrays): conv kernels ``(kh, kw, in, out)`` → ``(out, in, kh,
    kw)``, ``Dense`` kernels transposed."""
    p = variables["params"]
    sd = {}
    for i in (0, 1):
        sd[f"conv{i}.weight"] = conv2d_weight(p[f"Conv_{i}"]["kernel"])
        sd[f"conv{i}.bias"] = as_tensor(p[f"Conv_{i}"]["bias"])
        sd.update(dense_state(p[f"Dense_{i}"], f"dense{i}"))
    return sd
