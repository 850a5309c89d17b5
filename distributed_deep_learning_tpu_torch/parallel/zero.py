"""ZeRO-style state sharding: the port of
``distributed_deep_learning_tpu/parallel/zero.py``.

The JAX package shards state by handing its one jitted step sharded
``PartitionSpec`` s and letting XLA insert the collectives.  The same two
dataflows here:

* ``--zero 1`` (:func:`zero1_optimizer`): parameters replicated, the
  optimizer state split over the ranks of one mesh axis by
  ``torch.distributed.optim.ZeroRedundancyOptimizer``: the gradients are
  averaged as in ``-m data``, each rank updates the parameters whose
  state it holds, and broadcasts them.  It splits whole parameters among
  the ranks, where the JAX package splits each large leaf's largest
  divisible dim (:func:`leaf_shard_spec`); the update is the same
  elementwise, so the numerics are ``-m data``'s.
* ``--zero fsdp`` (:func:`apply_fsdp`): parameters and optimizer state
  split by FSDP2's ``fully_shard``, once a transformer layer and once at
  the root, on dim 0 over the mesh axis (over ``(data, fsdp)`` as a
  replicate x shard mesh when both have ranks): parameters are gathered
  for a layer's forward and backward, gradients reduce-scattered.

JAX picks the axis (``workloads/base.py:405`` there): ``fsdp`` when it
has ranks, else ``data``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from distributed_deep_learning_tpu_torch.parallel.shards import (
    local, resharded)


def leaf_shard_spec(leaf: Any, axis_size: int, axis: str = "fsdp",
                    min_leaf_size: int = 2 ** 14) -> tuple:
    """The JAX package's per-leaf rule, as a tuple of axis names (None:
    not split; ``()`` replicated): the largest dim of ``leaf``'s shape
    divisible by ``axis_size`` is split over ``axis``, leaves below
    ``min_leaf_size`` elements stay replicated.  Not what the port's
    ZeRO-1 applies (whole parameters a rank, see above): it states the
    JAX layout, which the tests hold against the JAX package's."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape or axis_size <= 1:
        return ()
    if math.prod(shape) < min_leaf_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % axis_size == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def zero_axis(sizes: dict) -> str:
    """The axis ZeRO shards over: ``fsdp`` when it has ranks, else
    ``data``."""
    return "fsdp" if sizes.get("fsdp", 1) > 1 else "data"


def zero1_optimizer(tx, model: nn.Module, group) -> torch.optim.Optimizer:
    """``tx`` (a ``train.state.Optimizer``) over ``model``'s parameters,
    its state split over ``group``'s ranks (ZeRO-1)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    cls, params, kwargs = tx.parts(model.named_parameters(),
                                   layout=getattr(model, "flax_layout",
                                                  None))
    return ZeroRedundancyOptimizer(params, optimizer_class=cls,
                                   process_group=group, **kwargs)


def fsdp_mesh(layout):
    """The ``DeviceMesh`` FSDP2 shards over: ``fsdp`` (with ``data``
    replicated, HSDP, when both have ranks), else ``data``."""
    if layout.sizes["fsdp"] > 1 and layout.sizes["data"] > 1:
        return layout.mesh["data", "fsdp"]
    return layout.mesh[zero_axis(layout.sizes)]


def apply_fsdp(model: nn.Module, layout) -> nn.Module:
    """``fully_shard`` ``model``'s transformer layers, then the root, over
    :func:`fsdp_mesh` (in place; the parameters become DTensors split on
    dim 0)."""
    from torch.distributed.fsdp import fully_shard

    from distributed_deep_learning_tpu_torch.models.transformer import \
        TransformerLayer

    mesh = fsdp_mesh(layout)
    for mod in model.modules():
        if isinstance(mod, TransformerLayer):
            fully_shard(mod, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of optimizer state this rank holds (its local parts)."""
    inner = getattr(optimizer, "optim", optimizer)   # ZeRO's local one
    total = 0
    for st in inner.state.values():
        for v in st.values():
            if isinstance(v, torch.Tensor):
                t = local(v)
                total += t.numel() * t.element_size()
    return total


def param_bytes(model: nn.Module) -> int:
    """Bytes of parameters this rank holds (its local parts)."""
    return sum(local(p).numel() * local(p).element_size()
               for p in resharded(model).parameters())
