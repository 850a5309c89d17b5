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

:func:`make_loaders` can wrap the train loader in :class:`PrefetchLoader`
(JAX's): a thread gathers the next batches and queues their uploads while
the caller's step runs, and the caller's thread makes its stream wait for
each batch's copy as it takes the batch.  It does so only when asked
(``prefetch > 0``; see :func:`make_loaders`).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

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

    def local_batch(self, rows: np.ndarray
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's part of the global batch of dataset ``rows``, on
        the device (a tuner's probe batch)."""
        x, y = self.dataset.batch(np.asarray(rows)[self._local_rows])
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        return self.iter_batches()

    def iter_batches(self, skip: int = 0
                     ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Device batches after the first ``skip``."""
        prev = None
        for cur in self.iter_staged(skip):
            if prev is not None:
                yield self.hand_over(prev)
            prev = cur
        if prev is not None:
            yield self.hand_over(prev)

    def iter_staged(self, skip: int = 0) -> Iterator:
        """The batches after the first ``skip`` on their way to the
        device, for :meth:`hand_over`: on the card each batch's tensors,
        their copy queued on a copy stream, and the event recorded after
        it; elsewhere the tensors."""
        if self.device.type != "cuda":
            for x, y in self.iter_host_batches(skip):
                yield (torch.from_numpy(x).to(self.device),
                       torch.from_numpy(y).to(self.device))
            return
        copy = torch.cuda.Stream(self.device)
        for batch in self.iter_host_batches(skip):
            yield self._upload(batch, copy)

    def hand_over(self, staged):
        """A staged batch's tensors, the calling thread's current stream
        made to wait for their copy and to own their memory."""
        if self.device.type != "cuda":
            return staged
        return _hand_over(*staged, torch.cuda.current_stream(self.device))

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


class PrefetchLoader:
    """JAX's ``PrefetchLoader`` over a :class:`DeviceLoader`: while the
    caller's step k runs, a thread builds batches k+1..k+``depth`` (the
    host gather and, on the card, the pinned upload on the copy stream;
    :meth:`DeviceLoader.iter_staged`), and the caller's thread hands each
    over to its own stream as it takes it.  The batches are the wrapped
    loader's, in its order.  ``iter_batches(skip)`` skips inside the
    wrapped loader, before any gather; an early ``break`` (closing the
    iterator) stops and joins the thread, and an exception raised in the
    thread is raised in the caller."""

    def __init__(self, loader: DeviceLoader, depth: int = 2):
        self.loader = loader
        self.depth = max(1, int(depth))

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        return self.iter_batches()

    def iter_batches(self, skip: int = 0
                     ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        loader = self.loader
        return _prefetched(lambda: loader.iter_staged(skip),
                           loader.hand_over, loader.device, self.depth)


def _prefetched(source: Callable[[], Iterator], hand_over, device,
                depth: int):
    """``hand_over(item)`` for each item of ``source()``, which a thread
    iterates at most ``depth`` items ahead, on ``device`` (an index-less
    ``cuda`` is the caller's current card)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=depth)
    empty = queue.Empty     # still bound if the generator closes at exit
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded wait, so that an abandoned consumer (an early break
        # from the epoch loop) never strands the producer on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            if device.type == "cuda":
                # a new thread's current card is 0: rank r of a spawned
                # -m data run pins and copies for cuda:r
                torch.cuda.set_device(device)
            for item in source():
                if not put(item):
                    return
        except BaseException as exc:    # raised again in the consumer
            put(exc)
            return
        put(end)

    thread = threading.Thread(target=produce, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield hand_over(item)
    finally:
        stop.set()
        while True:     # unblock a producer mid-put
            try:
                q.get_nowait()
            except empty:
                break
        thread.join(timeout=5.0)


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
                 accum: int = 1, prefetch: int = 0):
    """(train, val, test) loaders with the reference's semantics: train
    shuffles per epoch, the eval splits iterate in fixed order.  Each
    yields this rank's rows of every global batch; only the train loader
    is laid out for ``accum`` microbatches (evaluation takes whole
    batches).  ``prefetch > 0`` wraps the train loader in
    :class:`PrefetchLoader`, that many batches deep.  The JAX package
    prefetches 2 deep; here the default is 0 (not wrapped), because on an
    H100 the thread made no step reliably faster (``chip_smoke.py``'s
    ``prefetch_ab``): it contends for the interpreter lock with the
    thread that launches the kernels."""
    kw = dict(seed=seed, rank=rank, world=world)
    train = DeviceLoader(dataset, splits.train, batch_size, device,
                         shuffle=True, accum=accum, **kw)
    if prefetch:
        train = PrefetchLoader(train, depth=prefetch)
    val = DeviceLoader(dataset, splits.val, batch_size, device, **kw)
    test = DeviceLoader(dataset, splits.test, batch_size, device, **kw)
    return train, val, test
