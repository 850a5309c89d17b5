"""Shared threaded-decode machinery for image datasets (PCB and
ImageFolder): the port of
``distributed_deep_learning_tpu/data/_threaded.py``.

One implementation of the two concurrency-sensitive pieces both loaders
need (review finding: they had drifted into near-identical copies):

* a bounded LRU over decoded full-resolution images, safe to share across
  decode threads (decode happens OUTSIDE the lock — PIL/libjpeg releases
  the GIL, and a rare duplicate decode of the same path is cheaper than
  serialising the pool);
* a LAZILY constructed thread pool for ``batch()`` — the reference's
  DataLoader ``num_workers`` analogue (``-w``).  Lazy so a dataset built
  before a ``fork`` (spawned local ranks) never inherits dead executor
  threads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np


class ThreadedDecodeMixin:
    """Mix into a dataset exposing ``item(i) -> (x, y)``."""

    def _init_decode(self, workers: int, max_cached: int) -> None:
        self._workers = max(1, int(workers))
        self._pool = None
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cache_lock = threading.Lock()
        self._max_cached = max_cached

    def _cached(self, path: str,
                decode: Callable[[str], np.ndarray]) -> np.ndarray:
        with self._cache_lock:
            img = self._cache.get(path)
            if img is not None:
                self._cache.move_to_end(path)
                return img
        img = decode(path)
        with self._cache_lock:
            self._cache[path] = img
            while len(self._cache) > self._max_cached:
                self._cache.popitem(last=False)
        return img

    def _map_items(self, idx: list[int]) -> list:
        if self._workers > 1 and len(idx) > 1:
            if self._pool is None:
                with self._cache_lock:  # two pump threads must not race
                    if self._pool is None:
                        from concurrent.futures import ThreadPoolExecutor

                        self._pool = ThreadPoolExecutor(self._workers)
            return list(self._pool.map(self.item, idx))
        return [self.item(i) for i in idx]

    def batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        items = self._map_items([int(i) for i in np.asarray(indices)])
        return (np.stack([x for x, _ in items]),
                np.stack([y for _, y in items]))
