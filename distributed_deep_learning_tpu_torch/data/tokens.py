"""File-based tokenized text: the port of
``distributed_deep_learning_tpu/data/tokens.py`` for the ``gpt``,
``transformer`` and ``bert`` workloads.  ``--data-dir`` holds a
``tokens.npy`` int array ``(N, T)``; token id 0 is reserved for padding.
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


def mlm_dataset(tokens: np.ndarray, *, mask_id: int = 103,
                mask_rate: float = 0.15, seed: int = 42,
                vocab_size: int | None = None) -> TokenArrayDataset:
    """BERT-style masking: ``mask_rate`` of the non-pad positions become
    ``mask_id`` in the features; targets keep the original id exactly at
    the masked sites and 0 (ignored by the loss) elsewhere."""
    rng = np.random.default_rng(seed)
    tokens = np.asarray(tokens, np.int32)
    maskable = tokens != 0
    masked = np.logical_and(rng.random(tokens.shape) < mask_rate, maskable)
    features = np.where(masked, mask_id, tokens).astype(np.int32)
    targets = np.where(masked, tokens, 0).astype(np.int32)
    vocab = vocab_size or max(int(tokens.max()) + 1, mask_id + 1)
    return TokenArrayDataset(features, targets, vocab)


def seq2seq_dataset(tokens: np.ndarray, *, src_len: int | None = None,
                    vocab_size: int | None = None) -> TokenArrayDataset:
    """Source⊕target rows for the seq2seq workload: each ``(N, T)`` row
    splits at ``src_len`` (default ``T // 2``).  Features stay the whole
    row (the model slices it), targets are the target half."""
    tokens = np.asarray(tokens, np.int32)
    src_len = src_len or tokens.shape[1] // 2
    if not 0 < src_len < tokens.shape[1]:
        raise ValueError(f"src_len {src_len} outside row length "
                         f"{tokens.shape[1]}")
    vocab = vocab_size or int(tokens.max()) + 1
    return TokenArrayDataset(tokens, tokens[:, src_len:].copy(), vocab)


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
