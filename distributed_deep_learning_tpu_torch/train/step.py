"""Train and eval steps: the port of ``distributed_deep_learning_tpu/train/step.py``.

A train step is forward, loss, backward and the optimizer update, all
enqueued on the device; its metrics stay device tensors, so a step never
waits for the card (the loop fetches them once per phase).

Under ``-m data`` the model runs wrapped in ``DistributedDataParallel``
(``ddp``), each rank on its rows of the global batch.  JAX's ``-m data``
is one program over the global batch, so its loss is the mean over every
counted site of the global batch; DDP averages each rank's own mean,
which differs as soon as ranks hold different numbers of pad tokens.  So
before the backward the ranks all-reduce ``[local loss × local sites,
local sites, correct, count]`` (the sites depend on the targets only) and
each rank backpropagates ``local loss × sites × world / global sites``:
DDP's average of those gradients is the gradient of the global mean, and
the metrics are the global batch's, as JAX logs them.  At world 1 the
scale is exactly 1.  ``loss_fn.sites(targets)`` gives the count (see
:class:`..objectives.TokenCrossEntropy`).

Auxiliary losses follow the JAX train state's convention: what a train
forward sows (:func:`..models.layers.sow_loss`, the MoE load-balance
losses) is summed and added to the objective, one microbatch at a time,
but not to the logged loss; evaluation sows nothing into a collection.
The collection closes when the forward returns, so a ``--remat``
recompute in the backward adds nothing.  A model that sows nothing
computes exactly the objective it did without the collection.  Under
``-m data`` every rank adds the same global term (``models.moe``'s
routing sums it over the ranks differentiably), and DDP's average of the
ranks' gradients is its gradient.

``local_mean`` is what JAX's ``shard_map`` steps do (``--grad-compress``,
``--comm``): each rank backpropagates its own shard's mean loss, takes
BatchNorm statistics and routes on its own rows; the gradients are
averaged by the synchronising party (the DDP communication hook of
:mod:`.compress`, or :class:`..parallel.collectives.ExplicitFSDP`), the
logged loss is the mean of the ranks' losses, and the floating buffers
(running statistics) are averaged over the ranks after the update.

``sentinel`` (:class:`.sentinel.SentinelConfig`) puts the anomaly
sentinel between the backward and the update
(:func:`.sentinel.guarded_update`): the global gradient norm of the whole
parameters and the loss decide whether the update is applied or
contained.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.models.layers import \
    collect_losses
from distributed_deep_learning_tpu_torch.train.objectives import \
    prediction_metrics
from distributed_deep_learning_tpu_torch.train.state import TrainState

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def global_mean(loss, pred, y, loss_fn, world: int, group=None):
    """``(objective, metrics)`` of one rank's share of a global batch: one
    all-reduce of ``[loss × sites, sites, correct, count]`` (f64) over
    ``group`` (the batch axes' ranks; default all), the objective whose
    averaged gradient is the global mean's, and the global metrics."""
    m = prediction_metrics(pred.detach(), y, loss)
    sites = loss_fn.sites(y)
    stats = torch.stack([loss.detach().double() * sites, sites.double(),
                         m["correct"].double(), m["count"].double()])
    dist.all_reduce(stats, group=group)
    total = stats[1].clamp_min(1.0)
    objective = loss * (sites * world / total).float()
    return objective, {"loss": (stats[0] / total).float(),
                       "correct": stats[2].to(torch.int32),
                       "count": stats[3].to(torch.int32)}


def local_metrics(loss, pred, y, world: int, group=None):
    """A shard's metrics summed over ``group``: the mean of the ranks'
    losses and the summed counts (JAX's ``psum(...)/n``)."""
    m = prediction_metrics(pred.detach(), y, loss)
    stats = torch.stack([loss.detach().double(), m["correct"].double(),
                         m["count"].double()])
    dist.all_reduce(stats, group=group)
    return {"loss": (stats[0] / world).float(),
            "correct": stats[1].to(torch.int32),
            "count": stats[2].to(torch.int32)}


@torch.no_grad()
def average_buffers(model, world: int, group=None) -> None:
    """Every floating buffer (BatchNorm's running statistics) averaged
    over ``group`` in f32, as JAX averages ``model_state``."""
    for b in model.buffers():
        if b.is_floating_point():
            t = b.float()
            dist.all_reduce(t, group=group)
            b.copy_(t / world)


def make_step_fns(loss_fn: LossFn, *, ddp=None, remat: bool = False,
                  remat_policy: str = "nothing", accum_steps: int = 1,
                  global_batch: bool = False, group=None,
                  local_mean: bool = False, comm=None, sentinel=None):
    """``(train_step, eval_step)``: ``train_step(state, x, y) -> (state,
    metrics)`` updates ``state`` in place; ``eval_step(state, x, y) ->
    metrics``.  ``ddp`` (``DistributedDataParallel`` over ``state.model``)
    makes them ``-m data`` steps over this rank's rows, with the global
    batch's loss and metrics; so does ``global_batch`` for a model that
    averages its gradients itself (FSDP).  ``group`` is the process group
    of the ranks the batch is split over (default: all).  ``remat`` recomputes each layer in the
    backward, keeping what ``remat_policy`` names (one of
    ``utils.config.REMAT_POLICIES``); numerics do not change.
    ``accum_steps`` cuts the batch into that many microbatches before one
    update (:mod:`.accumulate`).  The gradients of a train step stay on
    the parameters until the next one starts."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    kw = {"remat": remat_policy} if remat else {}
    synced = ddp is not None or global_batch
    world = dist.get_world_size(group) if synced else 1

    def train_step(state: TrainState, x, y):
        B = x.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accumulation "
                             f"factor {accum_steps}")
        m = B // accum_steps
        net = ddp if ddp is not None else state.model
        snapshot = None
        if sentinel is not None:
            from distributed_deep_learning_tpu_torch.train.sentinel import \
                StepSnapshot

            snapshot = StepSnapshot(state)
        if comm is not None:
            state.wait_fence()      # the gather writes the saved params
            comm.gather()
        net.train()
        state.optimizer.zero_grad(set_to_none=True)
        metrics = []
        for i in range(accum_steps):
            mx, my = x[i * m:(i + 1) * m], y[i * m:(i + 1) * m]
            # one gradient all-reduce a step: DDP syncs the last backward
            sync = contextlib.nullcontext() if ddp is None \
                or i == accum_steps - 1 else ddp.no_sync()
            with sync:
                with collect_losses() as sown:
                    pred = net(mx, generator=state.generator, **kw)
                loss = loss_fn(pred, my)
                if not synced:
                    objective = loss
                    metrics.append(prediction_metrics(pred.detach(), my,
                                                      loss))
                elif local_mean:
                    objective = loss
                    metrics.append(local_metrics(loss, pred, my, world,
                                                 group))
                else:
                    objective, mm = global_mean(loss, pred, my, loss_fn,
                                                world, group)
                    metrics.append(mm)
                if sown:
                    objective = objective + sum(sown)
                (objective / accum_steps).backward()   # exact at 1
        if comm is not None:
            comm.reduce_gradients(state.comm_residual)
        # JAX's accumulated metrics: mean loss, summed correct and count
        out = {"loss": torch.stack([mm["loss"] for mm in metrics]).mean(),
               "correct": sum(mm["correct"] for mm in metrics),
               "count": sum(mm["count"] for mm in metrics)}
        if sentinel is not None:
            from distributed_deep_learning_tpu_torch.train.sentinel import \
                guarded_update

            return guarded_update(state, out, sentinel, snapshot)
        state.apply_gradients()
        if synced and local_mean:
            average_buffers(state.model, world, group)
        return state, out

    @torch.no_grad()
    def eval_step(state: TrainState, x, y):
        if comm is not None:
            state.wait_fence()
            comm.gather(exact=True)
        state.model.eval()
        pred = state.model(x)
        loss = loss_fn(pred, y)
        if not synced:
            return prediction_metrics(pred, y, loss)
        return global_mean(loss, pred, y, loss_fn, world, group)[1]

    return train_step, eval_step
