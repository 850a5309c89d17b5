"""Train and eval steps: the port of ``distributed_deep_learning_tpu/train/step.py``.

A train step is forward, loss, backward and the optimizer update, all
enqueued on the device; its metrics stay device tensors, so a step never
waits for the card (the loop fetches them once per phase).
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_deep_learning_tpu_torch.train.objectives import \
    prediction_metrics
from distributed_deep_learning_tpu_torch.train.state import TrainState

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_step_fns(loss_fn: LossFn):
    """``(train_step, eval_step)``: ``train_step(state, x, y) -> (state,
    metrics)`` updates ``state`` in place; ``eval_step(state, x, y) ->
    metrics``.  The gradients of a train step stay on the parameters until
    the next one starts."""

    def train_step(state: TrainState, x, y):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = model(x, generator=state.generator)
        loss = loss_fn(pred, y)
        loss.backward()
        state.apply_gradients()
        return state, prediction_metrics(pred.detach(), y, loss)

    @torch.no_grad()
    def eval_step(state: TrainState, x, y):
        state.model.eval()
        pred = state.model(x)
        return prediction_metrics(pred, y, loss_fn(pred, y))

    return train_step, eval_step
