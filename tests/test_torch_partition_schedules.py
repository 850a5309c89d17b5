"""The port's partitioners and pipeline schedules against the JAX
package's, exactly, on a grid; the single-controller executor's live stage
inputs against the schedule's bound (``residency_bound``)."""

import importlib
import itertools
import re

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.parallel import partition as jpart
from distributed_deep_learning_tpu_torch.parallel import partition as tpart
from distributed_deep_learning_tpu_torch.parallel import spmd_pipeline as tsp
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

# the JAX package's parallel/__init__ exports a function of that name
jsp = importlib.import_module(
    "distributed_deep_learning_tpu.parallel.spmd_pipeline")
GRID = [(n, s) for n in range(1, 13) for s in range(1, 6)]


@pytest.mark.parametrize("name", ["balanced_partition", "block_partition",
                                  "lstm_aware_partition"])
def test_partitioners_equal_jax(name):
    mine, theirs = getattr(tpart, name), getattr(jpart, name)
    for n_layers, n_stages in GRID:
        try:
            want = theirs(n_layers, n_stages)
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc))):
                mine(n_layers, n_stages)
            continue
        got = mine(n_layers, n_stages)
        np.testing.assert_array_equal(got, want)
        assert tpart.stage_slices(got, n_stages) == \
            jpart.stage_slices(want, n_stages)


@pytest.mark.parametrize("assignment", [[1, 1], [0, 2, 1], [0, 3], []])
def test_validate_assignment_refuses_as_jax(assignment):
    with pytest.raises(ValueError) as theirs:
        jpart.validate_assignment(np.asarray(assignment), 3)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        tpart.validate_assignment(np.asarray(assignment), 3)


def test_one_f_one_b_tables_equal_jax():
    for M, S in itertools.product(range(1, 9), range(1, 6)):
        assert tsp.one_f_one_b_schedule(M, S) == \
            jsp.one_f_one_b_schedule(M, S)


@pytest.mark.parametrize("V", [2, 3, 4])
def test_interleaved_tables_equal_jax(V):
    for M, S in itertools.product(range(1, 9), range(1, 5)):
        assert tsp.interleaved_1f1b_schedule(M, S, V) == \
            jsp.interleaved_1f1b_schedule(M, S, V)
        assert tsp.residency_bound(M, S, V) == \
            jsp._schedule_tables(M, S, V)["resid_depth"]


def _trunk(S, V, d=8):
    """A stacked trunk of residual ReLU-dense stages and a dense head."""
    g = torch.Generator().manual_seed(S * 10 + V)
    lead = (S,) if V == 1 else (V, S)
    stacked = {"w": torch.randn(*lead, d, d, generator=g) * 0.3}
    head = {"w": torch.randn(d, 5, generator=g) * 0.3}

    def stage_fn(p, x, generator=None):
        return x + torch.relu(x @ p["w"])

    def head_loss(hp, y, t):
        return torch.nn.functional.cross_entropy(y @ hp["w"], t)

    return stacked, head, stage_fn, head_loss


@pytest.mark.parametrize("M,S,V", [(1, 3, 1), (4, 2, 1), (8, 4, 1),
                                   (5, 3, 1), (4, 2, 2), (8, 3, 2),
                                   (6, 2, 3)])
def test_executor_matches_autograd_within_the_residency_bound(M, S, V):
    """Loss, trunk, head and input gradients of 1F1B/interleaved against
    autograd through the plain stage walk (sum of microbatch means over
    M); each virtual stage's peak of live inputs within the bound, and
    that bound reached by the first stage."""
    stacked, head, stage_fn, head_loss = _trunk(S, V)
    g = torch.Generator().manual_seed(M)
    x = torch.randn(2 * M, 8, generator=g)
    t = torch.randint(0, 5, (2 * M,), generator=g)
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    hp = {k: v.clone().requires_grad_() for k, v in head.items()}
    xr = x.clone().requires_grad_()
    total = 0.0
    for m in range(M):
        h = xr[2 * m:2 * m + 2]
        for v in range(S * V):
            idx = v if V == 1 else (v // S, v % S)
            h = stage_fn({k: p[idx] for k, p in leaves.items()}, h)
        total = total + head_loss(hp, h, t[2 * m:2 * m + 2])
    (total / M).backward()
    fn = tsp.spmd_pipeline_1f1b if V == 1 else tsp.spmd_pipeline_interleaved
    stats = {}
    loss, tg, hg, dx = fn(stage_fn, head_loss, stacked, head, x, t,
                          microbatch_size=2, stats=stats)
    torch.testing.assert_close(loss, (total / M).detach())
    torch.testing.assert_close(tg["w"], leaves["w"].grad)
    torch.testing.assert_close(hg["w"], hp["w"].grad)
    torch.testing.assert_close(dx, xr.grad)
    bound = tsp.residency_bound(M, S, V)
    assert max(stats["peak_live"]) <= bound
    if V == 1:
        assert stats["peak_live"][0] == min(M, 2 * S - 1)


@pytest.mark.parametrize("M,S,V", [(4, 2, 1), (8, 4, 1), (6, 2, 3)])
def test_executor_runs_the_last_virtual_stage_once(M, S, V):
    """Each virtual stage runs twice a microbatch (its forward without
    autograd, its backward's recompute) but the last, whose forward only
    keeps its input: ``(2·S·V − 1)·M`` stage calls, ``S·V·M`` of them
    under autograd."""
    stacked, head, stage_fn, head_loss = _trunk(S, V)
    calls = []

    def counted(p, x, generator=None):
        calls.append(torch.is_grad_enabled())
        return stage_fn(p, x, generator)

    g = torch.Generator().manual_seed(M)
    x = torch.randn(2 * M, 8, generator=g)
    t = torch.randint(0, 5, (2 * M,), generator=g)
    fn = tsp.spmd_pipeline_1f1b if V == 1 else tsp.spmd_pipeline_interleaved
    fn(counted, head_loss, stacked, head, x, t, microbatch_size=2)
    assert len(calls) == (2 * S * V - 1) * M
    assert sum(calls) == S * V * M
