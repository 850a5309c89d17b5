"""``data/loader.PrefetchLoader`` (JAX's, a thread that builds the next
batches while the caller's step runs) on the CPU: its batches equal the
plain loader's (``prefetch=0``) bit for bit, with and without a
mid-epoch ``skip``, across epochs; ``len`` and ``set_epoch`` pass
through; an exception raised while a batch is built reaches the
consumer; an early ``break`` stops and joins the thread, also with the
queue full; on a card the thread makes the caller's card (``cuda:r`` of
rank r; a new thread's is 0) current before it builds a batch (the
card's calls stubbed here).  ``make_loaders`` wraps only the train
loader, and only when asked."""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu_torch.data import loader as tloader
from distributed_deep_learning_tpu_torch.data.datasets import (ArrayDataset,
                                                               synthetic_lm)
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

JOIN_TIMEOUT = 10.0


def _loaders(depth, **kw):
    ds = synthetic_lm(n=120, seq_len=9, vocab_size=61, seed=3)
    splits = train_val_test_split(len(ds), seed=42)
    return tloader.make_loaders(ds, splits, 8, "cpu", seed=5,
                                prefetch=depth, **kw)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def _wait_gone(timeout=JOIN_TIMEOUT):
    deadline = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return _prefetch_threads()


@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("layout", [{}, {"rank": 1, "world": 2, "accum": 2}])
def test_batches_equal_the_plain_loaders(depth, skip, layout):
    plain = _loaders(0, **layout)[0]
    fetched = _loaders(depth, **layout)[0]
    assert isinstance(fetched, tloader.PrefetchLoader)
    assert isinstance(plain, tloader.DeviceLoader)
    assert len(fetched) == len(plain) > skip
    for epoch in (1, 2):
        plain.set_epoch(epoch)
        fetched.set_epoch(epoch)
        want = list(plain.iter_batches(skip))
        got = list(fetched.iter_batches(skip))
        assert len(got) == len(want) == len(plain) - skip
        for (x, y), (xw, yw) in zip(got, want):
            assert x.dtype == xw.dtype and y.dtype == yw.dtype
            torch.testing.assert_close(x, xw, rtol=0, atol=0)
            torch.testing.assert_close(y, yw, rtol=0, atol=0)
    assert not _wait_gone()


def test_only_the_train_loader_prefetches():
    train, val, test = _loaders(2)
    assert isinstance(train, tloader.PrefetchLoader)
    assert train.depth == 2
    assert type(val) is type(test) is tloader.DeviceLoader
    # unasked, no loader is wrapped (the runner's loaders)
    ds = synthetic_lm(n=120, seq_len=9, vocab_size=61, seed=3)
    loaders = tloader.make_loaders(ds, train_val_test_split(len(ds), seed=42),
                                   8, "cpu", seed=5)
    assert all(type(x) is tloader.DeviceLoader for x in loaders)


class _Failing(ArrayDataset):
    """Raises while gathering its third batch."""

    def __init__(self, *a):
        super().__init__(*a)
        self.calls = 0

    def batch(self, rows):
        self.calls += 1
        if self.calls == 3:
            raise OSError("disk went away")
        return super().batch(rows)


def test_a_producer_exception_reaches_the_consumer():
    ds = synthetic_lm(n=120, seq_len=9, vocab_size=61, seed=3)
    failing = _Failing(ds.features, ds.targets)
    loader = tloader.PrefetchLoader(tloader.DeviceLoader(
        failing, np.arange(96), 8, "cpu", shuffle=True), depth=2)
    got = []
    with pytest.raises(OSError, match="disk went away"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 2
    assert not _wait_gone()


@pytest.mark.parametrize("depth", [1, 4])
def test_an_early_break_joins_the_thread(depth):
    train = _loaders(depth)[0]
    train.set_epoch(1)
    before = set(_prefetch_threads())
    it = train.iter_batches()
    next(it)
    time.sleep(0.2)             # let the producer fill the queue and block
    (thread,) = set(_prefetch_threads()) - before
    for _ in it:
        break
    it.close()
    thread.join(JOIN_TIMEOUT)
    assert not thread.is_alive()
    # and a fresh pass starts from the epoch's first batch again
    plain = _loaders(0)[0]
    plain.set_epoch(1)
    again = train.iter_batches()
    torch.testing.assert_close(next(again)[0],
                               next(plain.iter_batches())[0], rtol=0, atol=0)
    again.close()
    assert not _wait_gone()


@pytest.mark.parametrize("device,want", [("cuda", 3), ("cuda:1", 1)])
def test_the_producer_takes_the_callers_card(device, want, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(
        torch.cuda, "set_device",
        lambda d: calls.append(("set", d, threading.current_thread().name)))

    def source():
        calls.append(("first batch", threading.current_thread().name))
        yield from range(4)

    got = list(tloader._prefetched(source, lambda b: b * 10,
                                   torch.device(device), 2))
    assert got == [0, 10, 20, 30]
    assert calls == [("set", torch.device("cuda", want), "prefetch"),
                     ("first batch", "prefetch")]
