"""File-based tokenized text: the port of the parts of
``distributed_deep_learning_tpu/data/tokens.py`` the ``gpt`` workload
uses.  ``--data-dir`` holds a ``tokens.npy`` int array ``(N, T)``; token id
0 is reserved for padding.
"""

from __future__ import annotations

import os

import numpy as np

from distributed_deep_learning_tpu_torch.data.datasets import ArrayDataset

TOKENS_FILE = "tokens.npy"


class TokenArrayDataset(ArrayDataset):
    """ArrayDataset that remembers the vocabulary it was built over."""

    def __init__(self, features, targets, vocab_size: int):
        super().__init__(features, targets)
        self.vocab_size = int(vocab_size)


def load_tokens(root: str) -> np.ndarray | None:
    """``(N, T)`` int32 tokens from ``<root>/tokens.npy``, or None."""
    path = os.path.join(os.fspath(root), TOKENS_FILE)
    if not os.path.exists(path):
        return None
    tokens = np.load(path)
    if tokens.ndim != 2 or not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(f"{path}: expected a 2-D integer array, got "
                         f"{tokens.shape} {tokens.dtype}")
    return np.ascontiguousarray(tokens, np.int32)


def lm_dataset(tokens: np.ndarray,
               vocab_size: int | None = None) -> TokenArrayDataset:
    """Next-token prediction rows: features ``tokens[:, :-1]``, targets the
    one-step shift ``tokens[:, 1:]``; the vocabulary is ``max id + 1``
    unless given."""
    tokens = np.asarray(tokens, np.int32)
    if tokens.shape[1] < 2:
        raise ValueError("lm_dataset needs rows of at least 2 tokens")
    vocab = vocab_size or int(tokens.max()) + 1
    return TokenArrayDataset(np.ascontiguousarray(tokens[:, :-1]),
                             np.ascontiguousarray(tokens[:, 1:]), vocab)
