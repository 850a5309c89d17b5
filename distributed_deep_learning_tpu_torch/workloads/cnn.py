"""CNN workload: DenseNet-BC on PCB defects (reference ``src/pytorch/CNN``),
the port of ``distributed_deep_learning_tpu/workloads/cnn.py``::

    python -m distributed_deep_learning_tpu_torch cnn -e 2 -b 32

``-l`` is the dense block count, ``-s`` the bottleneck size.  SGD(0.01,
momentum 0.9), ×0.1 every 7 epochs; ``--lr`` other than 1e-3 replaces the
0.01.  The class count comes from the dataset.  The PCB tree
(``/data/PCB_DATASET/`` or ``--data-dir``) when it exists, the synthetic
twin otherwise; an explicit ``--data-dir`` never falls back.  Under a
synced ``-m data`` the BatchNorm statistics span the global batch
(:mod:`..models.densenet`).
"""

from __future__ import annotations

from distributed_deep_learning_tpu_torch.data.datasets import synthetic_pcb
from distributed_deep_learning_tpu_torch.data.pcb import PCBDataset
import torch

from distributed_deep_learning_tpu_torch.models.densenet import (
    DenseNet, densenet_layer_sequence)
from distributed_deep_learning_tpu_torch.parallel.partition import \
    block_partition
from distributed_deep_learning_tpu_torch.train.state import \
    reference_optimizer
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, config_dtype, example_shape, nchw_input, run_workload)
from distributed_deep_learning_tpu_torch.workloads.mlp import \
    classifier_loss

NUM_CLASSES = 6  # PCB defect classes (the reference's class directories)


def _num_classes(dataset) -> int:
    """Class count from the dataset (a real tree may not have 6)."""
    classes = getattr(dataset, "classes", None)
    if classes is not None:
        return len(classes)
    return int(dataset.targets.shape[-1])  # one-hot synthetic twin


def _dataset(config: Config):
    workers = config.num_workers or None  # -w: decode thread count
    if config.data_dir:
        return PCBDataset(root=config.data_dir, seed=config.seed,
                          workers=workers)
    try:
        return PCBDataset(seed=config.seed, workers=workers)
    except FileNotFoundError:
        return synthetic_pcb(seed=config.seed, num_classes=NUM_CLASSES)


def _model(config: Config, dataset) -> DenseNet:
    h, w, c = example_shape(dataset)
    return DenseNet(dense_blocks=config.num_layers, bn_size=config.size,
                    num_classes=_num_classes(dataset),
                    double_softmax=config.double_softmax,
                    dtype=config_dtype(config), in_channels=c,
                    image_size=(h, w))


def _layers(config: Config, dataset):
    h, w, c = example_shape(dataset)
    return [layer.to(memory_format=torch.channels_last)
            for layer in densenet_layer_sequence(
                dense_blocks=config.num_layers, bn_size=config.size,
                num_classes=_num_classes(dataset),
                double_softmax=config.double_softmax, in_channels=c,
                image_size=(h, w))]


SPEC = WorkloadSpec(
    name="cnn",
    build_dataset=_dataset,
    build_model=_model,
    build_loss=classifier_loss,
    build_layers=_layers,
    partitioner=block_partition,   # reference CNN/model.py:196-201
    stage_input=nchw_input,
    double_softmax=True,
    build_optimizer=lambda c, steps: reference_optimizer(
        "cnn", c.learning_rate if c.learning_rate != 1e-3 else None,
        epoch_steps=steps),
)


def main(argv=None):
    return run_workload(SPEC, parse_args(argv, workload="cnn"))


if __name__ == "__main__":
    main()
