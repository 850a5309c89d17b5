"""MNIST CNN workload, the port of
``distributed_deep_learning_tpu/workloads/mnist.py``::

    python -m distributed_deep_learning_tpu_torch mnist -e 2 -b 32

Real idx-ubyte or ``.npy`` files under ``--data-dir``
(:mod:`..data.mnist`), the synthetic twin otherwise.  Adam at ``--lr``,
schedulable with ``--schedule``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.data.datasets import \
    synthetic_mnist
from distributed_deep_learning_tpu_torch.models.layers import (
    Conv2d, Dense, as_tensor, conv2d_weight, dense_state)
from distributed_deep_learning_tpu_torch.models.resnet import MnistCNN
from distributed_deep_learning_tpu_torch.parallel.partition import \
    balanced_partition
from distributed_deep_learning_tpu_torch.train.objectives import (
    RowMean, cross_entropy_loss)
from distributed_deep_learning_tpu_torch.train.state import Optimizer
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, config_dtype, example_shape, nchw_input, resolve_lr,
    run_workload)


def _dataset(config: Config):
    if config.data_dir:
        from distributed_deep_learning_tpu_torch.data.mnist import load_mnist

        return load_mnist(config.data_dir)
    return synthetic_mnist(seed=config.seed)


class _ConvPool(nn.Module):
    """Conv3×3 (SAME, with bias) → ReLU → MaxPool2 over the channels-last
    NCHW view: a layer of the staged layer list."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv(x)), 2, 2)

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return {"conv.weight": conv2d_weight(params["Conv_0"]["kernel"]),
                "conv.bias": as_tensor(params["Conv_0"]["bias"])}


class _DenseHead(nn.Module):
    """Flatten (NHWC order) → Dense(128) → ReLU → Dense(classes), f32
    logits: the staged layer list's head."""

    def __init__(self, in_features: int, num_classes: int = 10):
        super().__init__()
        self.dense0 = Dense(in_features, 128)
        self.dense1 = Dense(128, num_classes)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x))).float()

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return {**dense_state(params["Dense_0"], "dense0"),
                **dense_state(params["Dense_1"], "dense1")}


def _layers(config: Config, dataset):
    h, w, c = example_shape(dataset)
    layers = [_ConvPool(c, 32), _ConvPool(32, 64),
              _DenseHead((h // 4) * (w // 4) * 64, 10)]
    return [layer.to(memory_format=torch.channels_last) for layer in layers]


SPEC = WorkloadSpec(
    name="mnist",
    build_dataset=_dataset,
    build_model=lambda c, ds: MnistCNN(image_shape=example_shape(ds),
                                       dtype=config_dtype(c)),
    build_loss=lambda c: RowMean(cross_entropy_loss),
    build_layers=_layers,
    partitioner=balanced_partition,
    stage_input=nchw_input,
    build_optimizer=lambda c, steps: Optimizer(
        "adam", resolve_lr(c, steps, c.learning_rate)),
)


def main(argv=None):
    return run_workload(SPEC, parse_args(argv, workload="mnist"))


if __name__ == "__main__":
    main()
