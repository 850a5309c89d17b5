"""Seeded 70/10/20 train/val/test split and per-rank shards: copies of
``distributed_deep_learning_tpu/data/splits.py``'s ``train_val_test_split``
and ``shard_indices``, so both packages split alike for a seed."""

from __future__ import annotations

import dataclasses

import numpy as np

FRACTIONS = (0.7, 0.1, 0.2)  # reference split (CNN/main.py:70-74)


@dataclasses.dataclass(frozen=True)
class Splits:
    train: np.ndarray
    val: np.ndarray
    test: np.ndarray

    def __iter__(self):
        return iter((self.train, self.val, self.test))


def train_val_test_split(n: int, seed: int = 42,
                         fractions: tuple[float, float, float] = FRACTIONS
                         ) -> Splits:
    """Permute ``range(n)`` with a seeded NumPy RNG and cut 70/10/20."""
    if not np.isclose(sum(fractions), 1.0):
        raise ValueError(f"fractions must sum to 1, got {fractions}")
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(n * fractions[0])
    n_val = int(n * fractions[1])
    return Splits(train=perm[:n_train],
                  val=perm[n_train:n_train + n_val],
                  test=perm[n_train + n_val:])


def shard_indices(indices: np.ndarray, num_shards: int,
                  shard: int) -> np.ndarray:
    """Disjoint per-rank shard of a split (``--no-sync``'s quirk Q1), every
    shard of the same length (the remainder dropped)."""
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    per = len(indices) // num_shards
    return indices[shard * per:(shard + 1) * per]
