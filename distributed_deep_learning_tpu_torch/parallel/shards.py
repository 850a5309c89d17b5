"""What a rank holds of a parameter, and how to see the whole of it.

Two layouts split a parameter across ranks here:

* ``--zero fsdp`` (:mod:`.zero`): FSDP2 makes each parameter a
  ``DTensor`` sharded on dim 0 (uneven chunks allowed) over the mesh
  dimensions it was given;
* tensor and expert parallelism (:mod:`.tensor_parallel`): each
  parameter stays a plain tensor holding an even slice of one dim, and
  carries a :class:`TensorShard` as ``param.tp_shard``.

The optimizers' per-parameter statistics (a global gradient norm,
LAMB's trust ratio, Adafactor's factored moments) are statistics of the
whole parameter; :func:`whole_sum`, :func:`whole` and :func:`local_part`
let them be taken so, whatever the layout.  A parameter of neither
layout is whole already.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A tensor-parallel slice: ``index`` of ``parts`` even slices of
    ``dim`` over ``group`` (``axis`` names the mesh axis)."""

    dim: int
    index: int
    parts: int
    group: object
    axis: str


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor())


def resharded(model):
    """``model`` with every FSDP2 module's parameters back in their
    sharded form (FSDP2 leaves the root's gathered after a forward, and
    swaps the registered parameters while they are), so that
    ``named_parameters`` lists what a rank holds."""
    from torch.distributed.fsdp import FSDPModule

    for mod in model.modules():
        if isinstance(mod, FSDPModule):
            mod.reshard()
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of ``t`` (``t`` itself unless it is a DTensor)."""
    return t.to_local() if is_dtensor(t) else t


def shard_groups(p) -> list:
    """The process groups ``p`` is split over (empty when whole)."""
    if is_dtensor(p):
        return [p.device_mesh.get_group(i)
                for i, pl in enumerate(p.placements) if pl.is_shard()]
    shard = getattr(p, "tp_shard", None)
    return [] if shard is None else [shard.group]


def is_split(p) -> bool:
    return bool(shard_groups(p))


def whole_sum(p, x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's part of ``p``, summed over every part
    (in place; one all-reduce a group ``p`` is split over)."""
    for group in shard_groups(p):
        dist.all_reduce(x, group=group)
    return x


def whole(p, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part, laid out as
    ``p`` is (``t`` a DTensor, or a plain tensor shaped like ``p``'s
    local part); ``t`` itself when ``p`` is whole."""
    if is_dtensor(p):
        if not is_dtensor(t):
            t = _dtensor().from_local(t, p.device_mesh, p.placements,
                                      shape=p.shape, stride=p.stride())
        return full_tensor(t)
    shard = getattr(p, "tp_shard", None)
    if shard is None:
        return t
    return _all_gather(t, shard.group, shard.dim)


def full_tensor(t) -> torch.Tensor:
    """``t.full_tensor()`` of a DTensor (not differentiable), gathered by
    c10d's list all-gather one shard placement at a time, each rank's
    part padded to ``torch.chunk``'s largest: DTensor's own functional
    collectives crash on a gloo group over CUDA tensors (ranks sharing a
    card).  Two placements splitting one dim take ``full_tensor``."""
    dims = [pl.dim for pl in t.placements if pl.is_shard()]
    if len(dims) != len(set(dims)):
        return t.full_tensor()
    x, mesh = t.to_local(), t.device_mesh
    for i, pl in enumerate(t.placements):
        if not pl.is_shard():
            continue
        d, k, n = pl.dim, mesh.size(i), t.shape[pl.dim]
        pad = -(-n // k) - x.shape[d]
        if pad:
            x = torch.cat([x, x.new_zeros(*x.shape[:d], pad,
                                          *x.shape[d + 1:])], d)
        parts = [torch.empty_like(x) for _ in range(k)]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(i))
        x = torch.cat(parts, d).narrow(d, 0, n)
    return x


def local_part(p, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` (laid out as the whole of ``p``), a
    plain tensor shaped like ``p``'s local part."""
    if is_dtensor(p):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, p.device_mesh, p.placements,
                                 src_data_rank=None).to_local()
    shard = getattr(p, "tp_shard", None)
    if shard is None:
        return full
    n = full.shape[shard.dim] // shard.parts
    return full.narrow(shard.dim, shard.index * n, n).clone()


def whole_shape(p) -> tuple[int, ...]:
    """The shape of the whole parameter."""
    if is_dtensor(p):
        return tuple(p.shape)
    shard = getattr(p, "tp_shard", None)
    shape = list(p.shape)
    if shard is not None:
        shape[shard.dim] *= shard.parts
    return tuple(shape)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank
    order (a tensor-parallel slice's index is its rank in the group)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


# --- the collectives of a tensor-parallel forward ---------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients (the input
    is replicated, each rank's branch adds its part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """The ranks' partial outputs summed; the backward passes the
    (replicated) gradient to every rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Every rank's columns of the last dim, in rank order (this rank's
    are ``[start, start + n)``); the backward keeps this rank's columns of
    the replicated gradient."""

    @staticmethod
    def forward(ctx, x, group, start):
        ctx.cols = (start, x.shape[-1])
        return _all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.cols
        return g[..., start:start + n].contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a rank's part of a split computation (no-op without
    a group)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial ``x`` (no-op without a group)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_last(x: torch.Tensor, group, start: int) -> torch.Tensor:
    """Every rank's columns of the last dim, in order (see
    :class:`_GatherLast`)."""
    return x if group is None else _GatherLast.apply(x, group, start)
