"""Gradient accumulation: the port of
``distributed_deep_learning_tpu/train/accumulate.py``.

The batch is cut into ``accum_steps`` microbatches, run one after the
other (activations of one microbatch live at a time), and one optimizer
update follows.  JAX's rule: the gradient is the mean of the microbatch
means (not the full batch's token mean when pads are uneven), the logged
loss is the mean of the microbatch losses, and correct/count are summed.
Under ``-m data`` each rank's batch holds its share of every global
microbatch (:func:`..data.loader.local_rows`), each microbatch's loss is
the global one (:func:`.step.global_mean`), and every microbatch but the
last runs inside ``ddp.no_sync()``, so the gradients are all-reduced once
a step.  The step itself is :func:`.step.make_step_fns`'s: one step body
serves every accumulation factor, 1 included.
"""

from __future__ import annotations

from typing import Callable

from distributed_deep_learning_tpu_torch.train.step import make_step_fns


def make_accum_step_fns(loss_fn: Callable, *, accum_steps: int, ddp=None):
    """``(train_step, eval_step)`` with ``accum_steps``-way accumulation;
    drop-in for :func:`.step.make_step_fns`.  The batch must divide by
    ``accum_steps``."""
    return make_step_fns(loss_fn, ddp=ddp, accum_steps=accum_steps)
