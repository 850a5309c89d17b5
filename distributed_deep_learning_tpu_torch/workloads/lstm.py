"""LSTM workload: CNN-LSTM on predictive maintenance (reference
``src/pytorch/LSTM``), the port of
``distributed_deep_learning_tpu/workloads/lstm.py``::

    python -m distributed_deep_learning_tpu_torch lstm -e 2 -b 32

``-l`` is the LSTM layer count, ``-s`` the hidden width.  The loss is L1
over the 5 raw targets while "accuracy" counts argmax matches (quirk Q5).
``-m data`` syncs gradients like every workload; ``--no-sync`` gives the
reference's unsynced replicas (quirk Q2).  The real CSV when it exists
(``--data-dir``'s ``dataset.csv`` is one machine), the synthetic twin
otherwise; an explicit ``--data-dir`` never falls back.
"""

from __future__ import annotations

import os

from distributed_deep_learning_tpu_torch.data.datasets import synthetic_pdm
from distributed_deep_learning_tpu_torch.data.pdm import load_pdm
from distributed_deep_learning_tpu_torch.models.cnn_lstm import (
    CNNLSTM, cnn_lstm_layer_sequence)
from distributed_deep_learning_tpu_torch.parallel.partition import \
    lstm_aware_partition
from distributed_deep_learning_tpu_torch.train.objectives import (RowMean,
                                                                  l1_loss)
from distributed_deep_learning_tpu_torch.train.state import \
    reference_optimizer
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, cast_input, config_dtype, example_shape, run_workload)

NUM_TARGETS = 5


def _dataset(config: Config):
    if config.data_dir:
        return load_pdm(os.path.join(config.data_dir, "dataset.csv"),
                        instances_per_machine=None)
    try:
        return load_pdm()
    except FileNotFoundError:
        return synthetic_pdm(seed=config.seed)


def _model(config: Config, dataset) -> CNNLSTM:
    history, features = example_shape(dataset)
    return CNNLSTM(hidden_layers=config.num_layers, hidden_size=config.size,
                   num_targets=NUM_TARGETS, history=history,
                   num_features=features, dtype=config_dtype(config))


def _layers(config: Config, dataset):
    history, features = example_shape(dataset)
    return cnn_lstm_layer_sequence(config.num_layers, config.size,
                                   NUM_TARGETS, history=history,
                                   num_features=features)


SPEC = WorkloadSpec(
    name="lstm",
    build_dataset=_dataset,
    build_model=_model,
    build_loss=lambda c: RowMean(l1_loss),
    build_layers=_layers,
    partitioner=lstm_aware_partition,   # reference LSTM/model.py:98-124
    stage_input=cast_input,
    build_optimizer=lambda c, steps: reference_optimizer("lstm",
                                                         c.learning_rate),
)


def main(argv=None):
    return run_workload(SPEC, parse_args(argv, workload="lstm"))


if __name__ == "__main__":
    main()
