"""Compressed gradient all-reduce for data-parallel training: the port of
``distributed_deep_learning_tpu/train/compress.py``.

``--grad-compress`` trades gradient precision for wire bytes on ``-m
data``'s one gradient all-reduce.  JAX owns that reduction inside a
``shard_map``; here it is a ``DistributedDataParallel`` communication
hook (:meth:`GradCompression.register`) on the batch group:

* ``bf16``: the bucket's gradients cast to bf16, all-reduced (SUM), cast
  back and divided by the ranks (JAX's ``_psum_bf16``);
* ``int8``: as JAX's ``_psum_int8``, one common scale a **parameter**
  (the bucket's per-parameter ``amax`` vector in one all-reduce MAX,
  ``scale = max(amax / 127, 1e-30)``), round half to even, an int32 SUM,
  ``summed * scale / n``, and the error-feedback residual ``v - q *
  scale`` carried to the next step.  The residual is keyed by parameter
  name (DDP rebuilds its buckets after the first iteration), and lives on
  ``TrainState.comm_residual``.

The steps take local means as JAX's do (``train.step``'s ``local_mean``).
At one rank JAX reduces nothing, and neither does the port: no hook is
registered and no residual attached.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

METHODS = ("bf16", "int8")


class GradCompression:
    """The hook's state: ``method``, the batch ``group`` (None: the
    default group) of ``batch_world`` ranks, this rank's ``batch_rank``,
    the parameters' names and, for int8, the ``residual`` (name ->
    tensor)."""

    def __init__(self, method: str, model, group, batch_rank: int,
                 batch_world: int, residual: dict | None = None):
        if method not in METHODS:
            raise ValueError(f"unknown compression {method!r}; choose from "
                             f"{sorted(METHODS)}")
        self.method, self.residual = method, residual
        self.batch_group = group
        self.batch_rank, self.batch_world = batch_rank, batch_world
        self.names = {p: n for n, p in model.named_parameters()}

    def reduce(self, bucket_params, buffer: torch.Tensor) -> None:
        """The bucket's flat gradients (``buffer``, laid out in
        ``bucket_params`` order) replaced by their compressed mean."""
        n, group = self.batch_world, self.batch_group
        if self.method == "bf16":
            wire = buffer.to(torch.bfloat16)
            dist.all_reduce(wire, group=group)
            buffer.copy_(wire.to(buffer.dtype) / n)
            return
        views, start = [], 0
        for p in bucket_params:
            views.append(buffer[start:start + p.numel()])
            start += p.numel()
        names = [self.names[p] for p in bucket_params]
        vs = [g if self.residual is None
              else g + self.residual[name].reshape(-1)
              for g, name in zip(views, names)]
        amax = torch.stack([v.abs().amax() for v in vs])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        qs = [torch.clamp(torch.round(v / scale[i]), -127, 127)
              .to(torch.int8) for i, v in enumerate(vs)]
        summed = torch.cat([q.to(torch.int32) for q in qs])
        dist.all_reduce(summed, group=group)
        start = 0
        for i, (g, q, v, name) in enumerate(zip(views, qs, vs, names)):
            part = summed[start:start + g.numel()]
            start += g.numel()
            g.copy_(part.to(buffer.dtype) * scale[i] / n)
            if self.residual is not None:
                self.residual[name].copy_(
                    (v - q.to(buffer.dtype) * scale[i])
                    .reshape(self.residual[name].shape))


def compress_hook(state: GradCompression, bucket):
    """The DDP communication hook: the bucket reduced in place."""
    buffer = bucket.buffer()
    state.reduce(bucket.parameters(), buffer)
    fut = torch.futures.Future()
    fut.set_result(buffer)
    return fut
