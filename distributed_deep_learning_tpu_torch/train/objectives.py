"""Losses and metrics: the port of
``distributed_deep_learning_tpu/train/objectives.py``.

* ``cross_entropy_loss``: mean softmax CE against one-hot(ish) targets;
  ``from_probabilities`` (quirk Q4, the reference's Softmax fed into
  ``CrossEntropyLoss``) is the same math, as in the JAX package;
* ``l1_loss``: the ``lstm`` workload's mean absolute error (quirk Q5);
* ``RowMean``: such a per-row loss as an object whose ``sites`` are the
  batch's rows, the count ``-m data``'s global mean weights it by.

* ``token_cross_entropy``: mean CE over non-pad token positions, with
  optional label smoothing (ε on the target, ε/V spread over the rest),
  always in f32: a bf16 model's logits arrive f32 (its tied head), and
  nothing here casts to the model's dtype.
* ``TokenCrossEntropy``: that loss as an object that also counts the
  sites its mean is over, which ``-m data`` needs for the global-batch
  mean (:mod:`.step`).
* ``prediction_metrics``: the per-step triple the loop sums — batch loss,
  argmax matches, prediction sites (non-pad tokens for token targets, rows
  for one-hot targets).  The loop keeps the reference's
  Σ(batch-mean loss) / Σ(sites) formula (quirk Q9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def token_cross_entropy(logits, targets, label_smoothing: float = 0.0,
                        pad_id: int | None = 0):
    """Mean CE of ``logits`` ``(..., T, V)`` against integer ``targets``
    ``(..., T)``, positions equal to ``pad_id`` excluded (``None``: every
    position counts).  Computed in f32."""
    valid = (targets != pad_id if pad_id is not None
             else torch.ones_like(targets, dtype=torch.bool)).float()
    tgt = targets.clamp_min(0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, tgt[..., None])[..., 0]
    if label_smoothing:
        eps, V = label_smoothing, logits.shape[-1]
        per_tok = -(1.0 - eps) * picked - (eps / V) * logp.sum(-1)
    else:
        per_tok = -picked
    return (per_tok * valid).sum() / valid.sum().clamp_min(1.0)


def cross_entropy_loss(logits, targets, from_probabilities: bool = False):
    """Mean over rows of ``-sum(targets * log_softmax(logits))`` (optax's
    ``softmax_cross_entropy``), in f32.  ``from_probabilities`` changes
    nothing: softmax CE applied to probabilities is quirk Q4 itself."""
    del from_probabilities
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets.float() * logp).sum(-1).mean()


def l1_loss(pred, targets):
    return (pred.float() - targets.float()).abs().mean()


@dataclasses.dataclass(frozen=True)
class RowMean:
    """A loss that is a mean over the rows of a batch, every row of equal
    weight (``cross_entropy_loss``, ``l1_loss``); ``sites(targets)`` is
    the number of rows."""

    fn: Callable = cross_entropy_loss

    def __call__(self, pred, targets):
        return self.fn(pred, targets)

    def sites(self, targets):
        return torch.tensor(targets.shape[0], device=targets.device)


@dataclasses.dataclass(frozen=True)
class TokenCrossEntropy:
    """``token_cross_entropy`` with fixed options; ``sites(targets)`` is
    the count its mean divides by."""

    label_smoothing: float = 0.0
    pad_id: int | None = 0

    def __call__(self, logits, targets):
        return token_cross_entropy(logits, targets, self.label_smoothing,
                                   self.pad_id)

    def sites(self, targets):
        """The count of ``targets != pad_id`` (every position with
        ``pad_id`` None)."""
        if self.pad_id is None:
            return torch.tensor(targets.numel(), device=targets.device)
        return (targets != self.pad_id).sum()


def _correct_and_count(pred, targets):
    pred_cls = pred.argmax(-1)
    if targets.dim() == pred_cls.dim() and not targets.is_floating_point():
        # token-level: id 0 is pad, neither correct nor counted
        valid = targets != 0
        return (((pred_cls == targets) & valid).sum(),
                valid.sum().to(torch.int32))
    n_sites = math.prod(pred.shape[:-1])
    return ((pred_cls == targets.argmax(-1)).sum(),
            torch.tensor(n_sites, dtype=torch.int32, device=pred.device))


def prediction_metrics(pred, targets, loss) -> dict:
    """``{"loss", "correct", "count"}`` as device tensors (no host sync)."""
    correct, count = _correct_and_count(pred, targets)
    return {"loss": loss.detach(), "correct": correct.to(torch.int32),
            "count": count}
