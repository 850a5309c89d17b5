"""Host-side batched loader feeding device tensors: the port of
``distributed_deep_learning_tpu/data/loader.py``.

The epoch order is the JAX loader's: the train split is shuffled with
``np.random.default_rng((seed, epoch))`` and the remainder dropped, so both
packages see the same batches for a seed.  ``batch_size`` is the global
batch; under ``-m data`` each rank gathers only its rows of it (the JAX
loader's ``_local_rows``: rank r of W holds rows ``[r B/W, (r+1) B/W)``).
With ``accum`` microbatches a rank holds its share of each microbatch
instead, in microbatch order, so its i-th local chunk is its part of
the global batch's i-th microbatch (JAX cuts the global batch into
microbatches before sharding them).  On the card each host batch is
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
                 seed: int = 42, drop_remainder: bool = True,
                 rank: int = 0, world: int = 1, accum: int = 1):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self._local_rows = local_rows(self.batch_size, rank, world, accum)

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

    def iter_host_batches(self, skip: int = 0
                          ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """This epoch's host-side (x, y) batches, this rank's rows only,
        after the first ``skip`` (mid-epoch resume: those are not
        gathered)."""
        idx = self._epoch_indices()
        for start in range(skip * self.batch_size, len(idx),
                           self.batch_size):
            rows = idx[start:start + self.batch_size]
            if len(rows) == self.batch_size:
                rows = rows[self._local_rows]
            yield self.dataset.batch(rows)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        return self.iter_batches()

    def iter_batches(self, skip: int = 0
                     ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Device batches after the first ``skip``."""
        if self.device.type != "cuda":
            for x, y in self.iter_host_batches(skip):
                yield (torch.from_numpy(x).to(self.device),
                       torch.from_numpy(y).to(self.device))
            return
        copy = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        prev = None
        for batch in self.iter_host_batches(skip):
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


def local_rows(batch_size: int, rank: int = 0, world: int = 1,
               accum: int = 1) -> np.ndarray:
    """The rows of a global batch that ``rank`` of ``world`` gathers:
    its contiguous 1/world share of each of the ``accum`` microbatches.
    Raises ``ValueError`` when the batch does not divide (as the JAX
    loaders and accumulation step do)."""
    if batch_size % (world * accum):
        what = (f"data-parallel size {world}" if accum == 1 else
                f"data-parallel size {world} x accumulation factor {accum}")
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{what}")
    micro = batch_size // accum
    per = micro // world
    return np.concatenate([np.arange(i * micro + rank * per,
                                     i * micro + (rank + 1) * per)
                           for i in range(accum)])


def make_loaders(dataset: ArrayDataset, splits, batch_size: int, device,
                 seed: int = 42, *, rank: int = 0, world: int = 1,
                 accum: int = 1):
    """(train, val, test) loaders with the reference's semantics: train
    shuffles per epoch, the eval splits iterate in fixed order.  Each
    yields this rank's rows of every global batch; only the train loader
    is laid out for ``accum`` microbatches (evaluation takes whole
    batches)."""
    kw = dict(seed=seed, rank=rank, world=world)
    train = DeviceLoader(dataset, splits.train, batch_size, device,
                         shuffle=True, accum=accum, **kw)
    val = DeviceLoader(dataset, splits.val, batch_size, device, **kw)
    test = DeviceLoader(dataset, splits.test, batch_size, device, **kw)
    return train, val, test
