"""Predictive-maintenance windowed dataset (reference ``LSTM/dataset.py``):
the port of ``distributed_deep_learning_tpu/data/pdm.py``.

Semantics reproduced exactly (``LSTM/dataset.py:24-45``):

* CSV of ``machines × instances_per_machine`` rows (reference: 100 × 8759),
  last 5 columns are targets, the rest features;
* sliding windows of ``history`` rows that never cross a machine boundary:
  ``idx2pos`` maps the flat index to a window *end* ≥ row ``history-1``
  within its machine (``:36-39``);
* the item is ``(rows[pos-history+1 .. pos], targets_of_row[pos-history+1])``
  — note the target comes from the **first** (oldest) row of the window
  (``data[0,-5:]``, ``:45``), which we keep as the workload definition.

Unlike the reference (per-item pandas ``.iloc`` + ``.to(device)``), windows
are gathered for a whole batch at once with a single fancy-index — the
window tensor never materialises beyond the batch.
"""

from __future__ import annotations

import os

import numpy as np

NUM_TARGETS = 5


class PdMWindowedDataset:
    """Batch-gather windowed view over per-machine rows; ArrayDataset-API
    compatible (``__len__``/``batch``)."""

    def __init__(self, features: np.ndarray, targets: np.ndarray,
                 history: int = 10, instances_per_machine: int = 8759):
        if len(features) != len(targets):
            raise ValueError("features/targets length mismatch")
        if instances_per_machine < history:  # == history: one full window
            raise ValueError(
                f"instances_per_machine={instances_per_machine} is shorter "
                f"than history={history}: each machine needs at least one "
                "full window")
        if len(features) % instances_per_machine:
            raise ValueError(
                f"{len(features)} rows not divisible by instances_per_machine "
                f"{instances_per_machine}")
        self.features = features
        self.targets = targets
        self.history = history - 1          # reference keeps history-1
        self.instances_pm = instances_per_machine
        self.div = instances_per_machine - self.history
        self.machines = len(features) // instances_per_machine
        self._offsets = np.arange(-self.history, 1)  # window row offsets

    def __len__(self) -> int:
        return self.div * self.machines

    def idx2pos(self, idx: np.ndarray) -> np.ndarray:
        """Flat index → window-end row, skipping machine boundaries
        (reference ``LSTM/dataset.py:36-39``)."""
        idx = np.asarray(idx)
        machine = idx // self.div
        base = machine * self.instances_pm + self.history
        return base + (idx - machine * self.div)

    def batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        from distributed_deep_learning_tpu_torch import native

        pos = self.idx2pos(np.asarray(indices))
        # windows ending at pos (inclusive), via the native C++ gather
        x = native.window_gather(self.features, pos, self.history + 1)
        y = native.take(self.targets, pos - self.history)  # first row (Q5)
        return x, y


def load_pdm(path: str = "/data/PredictiveMaintenance/dataset.csv",
             history: int = 10,
             instances_per_machine: int | None = 8759) -> PdMWindowedDataset:
    """Load the real CSV (all-float32, last 5 columns targets).

    ``instances_per_machine=None`` treats the whole file as ONE machine
    (fixture/arbitrary CSVs); the default 8759 is the reference dataset's
    per-machine row count (``LSTM/dataset.py``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — use data.datasets.synthetic_pdm for the "
            "shape-compatible synthetic twin")
    from distributed_deep_learning_tpu_torch import native

    data = native.read_csv(path, skip_header=True)
    ipm = len(data) if instances_per_machine is None \
        else instances_per_machine  # 0 is an error, not "one machine";
    # ipm-vs-history validation lives in PdMWindowedDataset.__init__
    return PdMWindowedDataset(
        np.ascontiguousarray(data[:, :-NUM_TARGETS]),
        np.ascontiguousarray(data[:, -NUM_TARGETS:]),
        history=history,
        instances_per_machine=ipm)
