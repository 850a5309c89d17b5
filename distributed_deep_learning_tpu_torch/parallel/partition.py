"""Stage partitioners: the port of
``distributed_deep_learning_tpu/parallel/partition.py``, a copy (the port
imports nothing of the JAX package, not even its numpy modules).

The reference buries three partitioning algorithms inside model constructors
(SURVEY.md C12a-c); here they are standalone functions returning an
assignment array ``stage_of_layer[i] ∈ [0, n_stages)``.  All three reference
contracts are preserved:

* :func:`balanced_partition` — contiguous split with remainder spread
  (reference ``MLP/model.py:62-76``).
* :func:`block_partition` — fixed-size blocks per stage, generalising the
  hard-coded ``{i: i//4}`` (reference ``CNN/model.py:196-201``, noted there
  as "currently always 8,1 or 8,2").
* :func:`lstm_aware_partition` — structure-aware: stem pinned to stage 0,
  head to the next stage after the last hidden layer's, hidden LSTM layers
  spread, mid-model pooling placed midway (reference ``LSTM/model.py:98-124``).
"""

from __future__ import annotations

import numpy as np


def validate_assignment(assignment: np.ndarray, n_stages: int) -> np.ndarray:
    """Check an assignment is usable for staged execution: values in range,
    non-decreasing (stages are contiguous layer runs), starting at stage 0."""
    a = np.asarray(assignment, dtype=np.int64)
    if a.ndim != 1 or len(a) == 0:
        raise ValueError("assignment must be a non-empty 1-D array")
    if a[0] != 0:
        raise ValueError("first layer must be on stage 0")
    if (np.diff(a) < 0).any():
        raise ValueError("stage assignment must be non-decreasing")
    if a.max() >= n_stages or a.min() < 0:
        raise ValueError(f"stage ids must lie in [0,{n_stages})")
    return a


def stage_slices(assignment: np.ndarray, n_stages: int) -> list[tuple[int, int]]:
    """Per-stage contiguous [start, end) layer ranges (empty stages allowed)."""
    a = validate_assignment(assignment, n_stages)
    slices = []
    for s in range(n_stages):
        idx = np.flatnonzero(a == s)
        slices.append((int(idx[0]), int(idx[-1]) + 1) if len(idx) else
                      (len(a), len(a)))
    return slices


def balanced_partition(n_layers: int, n_stages: int) -> np.ndarray:
    """Contiguous balanced split; stage sizes differ by at most 1.

    Same contract as the reference MLP partitioner (``MLP/model.py:62-76``):
    every stage gets ``n_layers // n_stages`` layers and the remainder is
    spread one-per-stage.
    """
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_layers < n_stages:
        raise ValueError(f"cannot split {n_layers} layers into {n_stages} stages")
    sizes = np.full(n_stages, n_layers // n_stages, dtype=np.int64)
    sizes[:n_layers % n_stages] += 1
    return np.repeat(np.arange(n_stages), sizes)


def block_partition(n_layers: int, n_stages: int, block_size: int = 4) -> np.ndarray:
    """``stage = min(layer // block_size, n_stages-1)`` — the generalised form
    of the reference CNN's hard-coded ``{i: i//4}`` (``CNN/model.py:200``),
    clamped so it works for any stage count, with the reference's exact
    behaviour at its "8 layers, 1-2 devices" operating point."""
    if n_stages < 1 or block_size < 1:
        raise ValueError("n_stages and block_size must be >= 1")
    a = np.minimum(np.arange(n_layers) // block_size, n_stages - 1)
    return a.astype(np.int64)


def lstm_aware_partition(n_layers: int, n_stages: int) -> np.ndarray:
    """Structure-aware split for the CNN-LSTM layer sequence
    ``[stem, pool, lstm_1..lstm_H, head]`` (reference ``LSTM/model.py:98-124``).

    Contract (matching the reference's intent, not its arithmetic):

    * one layer per stage when ``n_layers == n_stages``;
    * the stem starts on stage 0 and the head lands on the stage after the
      last hidden layer's (clamped to ``n_stages-1``);
    * the hidden LSTM layers are spread contiguously and balanced;
    * the pooling layer (index 1) sits midway between the stem's stage and
      the first LSTM's stage.
    """
    if n_layers < 3:
        raise ValueError("lstm layer sequence needs >= 3 layers (stem/pool/head)")
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_layers == n_stages:
        return np.arange(n_layers, dtype=np.int64)
    n_hidden = n_layers - 3
    a = np.zeros(n_layers, dtype=np.int64)
    if n_hidden > 0:
        # spread hidden layers over stages, balanced, non-decreasing
        hidden_stages = (np.arange(n_hidden) * n_stages) // n_hidden
        hidden_stages = np.minimum(hidden_stages, n_stages - 1)
        a[2:2 + n_hidden] = hidden_stages
    a[-1] = min(n_stages - 1, a[-2] + 1)
    first_lstm_stage = a[2] if n_hidden > 0 else a[-1]
    a[1] = first_lstm_stage // 2  # pooling midway (reference LSTM/model.py:123)
    return validate_assignment(a, n_stages)
