"""In-memory array datasets: the port of the parts of
``distributed_deep_learning_tpu/data/datasets.py`` the ``gpt`` workload
uses.  Datasets are NumPy on the host; :mod:`.loader` batches them and
copies each batch to the device once.
"""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """(features, targets) arrays with uniform leading dimension."""

    def __init__(self, features: np.ndarray, targets: np.ndarray):
        if len(features) != len(targets):
            raise ValueError(f"length mismatch {len(features)} vs {len(targets)}")
        self.features = features
        self.targets = targets

    def __len__(self) -> int:
        return len(self.features)

    def batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Gather one batched (x, y) pair — the only hot-path data op."""
        indices = np.asarray(indices)
        return self.features[indices], self.targets[indices]


def synthetic_lm(n: int = 1024, seq_len: int = 64, vocab_size: int = 1024,
                 seed: int = 0) -> ArrayDataset:
    """Causal-LM twin: rows follow a cyclic +1 token rule from a random
    start (x[t+1] = x[t] + 1 over [1, vocab)), so next-token accuracy
    climbs within an epoch.  Features = rows[:, :-1], targets =
    rows[:, 1:]."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, vocab_size, size=(n, 1))
    ramp = np.arange(seq_len + 1)[None, :]
    rows = ((start - 1 + ramp) % (vocab_size - 1) + 1).astype(np.int32)
    return ArrayDataset(np.ascontiguousarray(rows[:, :-1]),
                        np.ascontiguousarray(rows[:, 1:]))
