"""MLP workload: MQTT intrusion detection (reference ``src/pytorch/MLP``),
the port of ``distributed_deep_learning_tpu/workloads/mlp.py``::

    python -m distributed_deep_learning_tpu_torch mlp -l 2 -e 10 -b 32

The input width comes from the data (quirk Q6).  The real CSV
(``/data/MQTT/dataset.csv``, or ``--data-dir``'s ``dataset.csv``) when it
exists, the synthetic twin otherwise; an explicit ``--data-dir`` never
falls back.
"""

from __future__ import annotations

import functools
import os

from distributed_deep_learning_tpu_torch.data.datasets import synthetic_mqtt
from distributed_deep_learning_tpu_torch.data.mqtt import load_mqtt
from distributed_deep_learning_tpu_torch.models.mlp import (
    MLP, mlp_layer_sequence)
from distributed_deep_learning_tpu_torch.parallel.partition import \
    balanced_partition
from distributed_deep_learning_tpu_torch.train.objectives import (
    RowMean, cross_entropy_loss)
from distributed_deep_learning_tpu_torch.train.state import \
    reference_optimizer
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, cast_input, config_dtype, example_shape, run_workload)

NUM_CLASSES = 5


def _dataset(config: Config):
    if config.data_dir:
        return load_mqtt(os.path.join(config.data_dir, "dataset.csv"))
    try:
        return load_mqtt()
    except FileNotFoundError:
        return synthetic_mqtt(seed=config.seed)


def _model(config: Config, dataset) -> MLP:
    return MLP(in_features=example_shape(dataset)[-1],
               hidden_size=config.size, num_hidden_layers=config.num_layers,
               num_classes=NUM_CLASSES, double_softmax=config.double_softmax,
               dtype=config_dtype(config))


def _layers(config: Config, dataset):
    return mlp_layer_sequence(example_shape(dataset)[-1], config.size,
                              config.num_layers, NUM_CLASSES,
                              config.double_softmax)


def classifier_loss(config: Config) -> RowMean:
    """Softmax CE; under ``--double-softmax`` on the head's probabilities
    (quirk Q4: the same math)."""
    if config.double_softmax:
        return RowMean(functools.partial(cross_entropy_loss,
                                         from_probabilities=True))
    return RowMean(cross_entropy_loss)


SPEC = WorkloadSpec(
    name="mlp",
    build_dataset=_dataset,
    build_model=_model,
    build_loss=classifier_loss,
    build_layers=_layers,
    partitioner=balanced_partition,   # reference MLP/model.py:62-76
    stage_input=cast_input,
    double_softmax=True,
    build_optimizer=lambda c, steps: reference_optimizer("mlp",
                                                         c.learning_rate),
)


def main(argv=None):
    return run_workload(SPEC, parse_args(argv, workload="mlp"))


if __name__ == "__main__":
    main()
