"""MQTT intrusion-detection CSV loader (the MLP workload's dataset): the
port of ``distributed_deep_learning_tpu/data/mqtt.py``.

Reference semantics (``src/pytorch/MLP/dataset.py:24-37``): read the CSV
with pandas, drop the first (index) column; each row is features
``data[:-5]`` + a 5-wide one-hot-ish target ``data[-5:]``.  The reference
moved every row to device inside ``__getitem__``; here rows stay host-side
NumPy and batching/device placement happen in :mod:`.loader` (SURVEY.md
§3.5).
"""

from __future__ import annotations

import os

import numpy as np

from distributed_deep_learning_tpu_torch.data.datasets import ArrayDataset

NUM_TARGETS = 5


def load_mqtt(path: str = "/data/MQTT/dataset.csv") -> ArrayDataset:
    """Load the real CSV; raises FileNotFoundError when /data is absent
    (callers fall back to :func:`..datasets.synthetic_mqtt`)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — use data.datasets.synthetic_mqtt for the "
            "shape-compatible synthetic twin")
    from distributed_deep_learning_tpu_torch import native

    # native C++ parser (multi-threaded; pandas replaced per SURVEY §2.4);
    # drop the index column like the reference
    data = native.read_csv(path, skip_header=True, drop_first_col=True)
    return ArrayDataset(np.ascontiguousarray(data[:, :-NUM_TARGETS]),
                        np.ascontiguousarray(data[:, -NUM_TARGETS:]))
