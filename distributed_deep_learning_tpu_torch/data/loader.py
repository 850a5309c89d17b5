"""Host-side batched loader feeding device tensors: the port of
``distributed_deep_learning_tpu/data/loader.py`` for one device (no mesh).

The epoch order is the JAX loader's: the train split is shuffled with
``np.random.default_rng((seed, epoch))`` and the remainder dropped, so both
packages see the same batches for a seed.  On the card each host batch is
copied into pinned memory and sent with ``non_blocking=True`` on a copy
stream; batch k+1's copy is queued before batch k is handed over, so it
runs while step k computes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.data.datasets import ArrayDataset


class DeviceLoader:
    """Iterates seeded batches of one split as tensors on ``device``."""

    def __init__(self, dataset: ArrayDataset, indices: np.ndarray,
                 batch_size: int, device, *, shuffle: bool = False,
                 seed: int = 42, drop_remainder: bool = True):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = idx[rng.permutation(len(idx))]
        if self.drop_remainder:
            idx = idx[:len(idx) - len(idx) % self.batch_size]
        return idx

    def iter_host_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """This epoch's host-side (x, y) batches."""
        idx = self._epoch_indices()
        for start in range(0, len(idx), self.batch_size):
            yield self.dataset.batch(idx[start:start + self.batch_size])

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        if self.device.type != "cuda":
            for x, y in self.iter_host_batches():
                yield (torch.from_numpy(x).to(self.device),
                       torch.from_numpy(y).to(self.device))
            return
        copy = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        prev = None
        for batch in self.iter_host_batches():
            cur = self._upload(batch, copy)
            if prev is not None:
                yield _hand_over(*prev, compute)
            prev = cur
        if prev is not None:
            yield _hand_over(*prev, compute)

    def _upload(self, batch, copy: "torch.cuda.Stream"):
        with torch.cuda.stream(copy):
            tensors = tuple(torch.from_numpy(a).pin_memory()
                            .to(self.device, non_blocking=True)
                            for a in batch)
            done = torch.cuda.Event()
            done.record(copy)
        return tensors, done


def _hand_over(tensors, done, stream):
    """Make ``stream`` wait for the copy and own the tensors' memory."""
    stream.wait_event(done)
    for t in tensors:
        t.record_stream(stream)
    return tensors


def make_loaders(dataset: ArrayDataset, splits, batch_size: int, device,
                 seed: int = 42):
    """(train, val, test) loaders with the reference's semantics: train
    shuffles per epoch, the eval splits iterate in fixed order."""
    train = DeviceLoader(dataset, splits.train, batch_size, device,
                         shuffle=True, seed=seed)
    val = DeviceLoader(dataset, splits.val, batch_size, device, seed=seed)
    test = DeviceLoader(dataset, splits.test, batch_size, device, seed=seed)
    return train, val, test
