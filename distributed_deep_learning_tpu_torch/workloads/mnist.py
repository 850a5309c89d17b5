"""MNIST CNN workload, the port of
``distributed_deep_learning_tpu/workloads/mnist.py``::

    python -m distributed_deep_learning_tpu_torch mnist -e 2 -b 32

Real idx-ubyte or ``.npy`` files under ``--data-dir``
(:mod:`..data.mnist`), the synthetic twin otherwise.  Adam at ``--lr``,
schedulable with ``--schedule``.
"""

from __future__ import annotations

from distributed_deep_learning_tpu_torch.data.datasets import \
    synthetic_mnist
from distributed_deep_learning_tpu_torch.models.resnet import MnistCNN
from distributed_deep_learning_tpu_torch.train.objectives import (
    RowMean, cross_entropy_loss)
from distributed_deep_learning_tpu_torch.train.state import Optimizer
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, config_dtype, example_shape, resolve_lr, run_workload)


def _dataset(config: Config):
    if config.data_dir:
        from distributed_deep_learning_tpu_torch.data.mnist import load_mnist

        return load_mnist(config.data_dir)
    return synthetic_mnist(seed=config.seed)


SPEC = WorkloadSpec(
    name="mnist",
    build_dataset=_dataset,
    build_model=lambda c, ds: MnistCNN(image_shape=example_shape(ds),
                                       dtype=config_dtype(c)),
    build_loss=lambda c: RowMean(cross_entropy_loss),
    remat_policies=("nothing",),
    build_optimizer=lambda c, steps: Optimizer(
        "adam", resolve_lr(c, steps, c.learning_rate)),
)


def main(argv=None):
    return run_workload(SPEC, parse_args(argv, workload="mnist"))


if __name__ == "__main__":
    main()
