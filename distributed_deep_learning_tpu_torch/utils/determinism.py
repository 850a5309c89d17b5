"""Determinism checks: the port of
``distributed_deep_learning_tpu/utils/determinism.py``.

:func:`check_step_determinism` runs one train step twice from the same
state and batch and diffs everything the step touched bit for bit: the
parameters, the optimizer state, the floating buffers and the dropout
generator's state (NaNs compare equal).  The flash kernels reduce without
atomics, so their backward is deterministic and a mismatch is a real
fault; the elastic and sentinel bit-identity contracts rest on it.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import numpy as np
import torch


class NondeterminismError(AssertionError):
    def __init__(self, paths: list[str]):
        self.paths = paths
        super().__init__(
            f"step produced different results on identical inputs at: "
            f"{paths[:10]}{'...' if len(paths) > 10 else ''}")


def _leaves(tree: Any, prefix: str = ""):
    """``(path, leaf)`` of nested dicts, lists and tuples, sorted by key."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:     # numpy has no bf16: its bits
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def diff_trees(a: Any, b: Any) -> list[str]:
    """Paths of leaves that differ bit for bit (NaNs compare equal; a
    leaf missing from one side counts as different)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    bad = sorted(set(la) ^ set(lb))
    for path in sorted(set(la) & set(lb)):
        na, nb = _host(la[path]), _host(lb[path])
        if na.shape != nb.shape or na.dtype != nb.dtype:
            bad.append(path)
        elif not np.array_equal(na, nb,
                                equal_nan=na.dtype.kind in "fc"):
            bad.append(path)
    return bad


def state_tree(state) -> dict:
    """What a train step changes in a
    :class:`..train.state.TrainState`, as one tree of host copies: the
    model's state dict (parameters and buffers), the optimizer's state
    dict, the update count and the generator's state."""
    return {"params": {k: v.detach().cpu().clone()
                       for k, v in state.model.state_dict().items()},
            "optimizer": copy.deepcopy(
                _cpu(state.optimizer.state_dict())),
            "step": int(state.step),
            "generator": None if state.generator is None
            else state.generator.get_state().clone()}


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def load_tree(state, tree: dict) -> None:
    """Put ``tree`` (:func:`state_tree`) back into ``state``."""
    with torch.no_grad():
        state.model.load_state_dict(tree["params"])
    state.optimizer.load_state_dict(copy.deepcopy(tree["optimizer"]))
    state.step = tree["step"]
    if tree["generator"] is not None:
        state.generator.set_state(tree["generator"])


def check_step_determinism(step_fn: Callable, state, *batch,
                           runs: int = 2) -> None:
    """Run ``step_fn(state, *batch)`` ``runs`` times, each from the state
    as it was before the first, and require the state after each run and
    the step's metrics to be bit-identical; ``state`` is left as the
    first run left it.  Raises :class:`NondeterminismError`."""
    start, ref = state_tree(state), None
    for i in range(runs):
        if i:
            load_tree(state, start)
        _, metrics = step_fn(state, *batch)
        out = {"state": state_tree(state),
               "metrics": {k: _cpu(v) for k, v in metrics.items()}}
        if ref is None:
            ref = out
            continue
        bad = diff_trees(ref, out)
        if bad:
            raise NondeterminismError(bad)
    load_tree(state, ref["state"])
