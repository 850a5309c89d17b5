"""Ulysses attention (``parallel/ulysses.py``) against the JAX package's
on a ``seq`` mesh of two devices: two spawned gloo ranks run the model
adapter (all-to-all head/sequence resharding, autograd-aware) on the
cases of ``test_torch_ring_attention`` (causal, window, padding with a
fully padded row, cross attention, GQA K/V, and the gradients), with the
dense inner attention and with the flash kernels' (their plain versions
on the CPU), against JAX's ``ulysses_attention``; then
``TransformerSeq2Seq``'s padded forward and one train step from JAX's
weights (the JAX test's tolerances).  Head counts the group does not
divide, and a dense mask, are refused."""

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu_torch.parallel import ulysses
from test_torch_ring_attention import (CASES, check_attention, check_wmt,
                                       run_scheme)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

#: where the kernels' plain version and JAX's dense inner agree: rows
#: with a visible key (a fully padded row averages different keys)
FLASH_CASES = ("causal", "window", "gqa")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_scheme("ulysses", 2, 2, tmp_path_factory.mktemp("ulysses"),
                      flash_inner=True)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ulysses_matches_jax(name, runs):
    ranks, want = runs
    check_attention(ranks, want, name, 2)


@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_inner_matches_jax(name, runs):
    ranks, want = runs
    check_attention(ranks, want, name, 2, tol=1e-4, suffix="_flash")


def test_padded_rows_are_finite(runs):
    ranks, _ = runs
    for name in ("padded", "causal_padded", "cross"):
        assert np.isfinite(ranks[0][name + "_flash"]["out"].numpy()).all()


def test_seq2seq_through_ulysses_matches_jax(runs):
    check_wmt(*runs)


def test_indivisible_heads_and_dense_masks_are_refused():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(NotImplementedError, match="dense mask"):
        ulysses.make_attention_fn(None)(
            q, q, q, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="heads"):
        ulysses.check_heads(3, 3, 2)
    with pytest.raises(ValueError, match="heads"):
        ulysses.check_heads(4, 1, 2)
