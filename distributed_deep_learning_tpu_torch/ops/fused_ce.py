"""Fused linear + cross-entropy: the LM loss without ``(N, V)`` logits.

The port of ``distributed_deep_learning_tpu/ops/fused_ce.py``.  The tied
head of a language model makes ``(batch * seq, vocab)`` logits, in f32 the
largest activation of a training step (GPT-2 small at B 4, T 2048, V 32768:
1 GiB), and the plain path keeps them for the backward as well.  This op
folds the head's product into the cross-entropy block by block over the
vocabulary:

* forward: per block ``logits_blk = h @ W_blk.T`` ``(N, block)``, folded
  into a running (max, sum of exp) online log-sum-exp, and each row's
  target logit picked when it falls in the block;
* backward: each block's logits computed again, ``softmax_blk -
  onehot_blk`` folded into ``dh`` and into the block's rows of ``dW``.

Peak extra memory is ``(N, block)`` instead of ``(N, V)``.  All of it runs
in f32, as the JAX op does; the block products are ``torch.matmul`` (the
JAX op is a ``lax.scan`` of matmuls, outside any Pallas kernel).  The
forward keeps each row's log-sum-exp for the backward, where the JAX op
computes it again: the same values from the same blocks in the same order.

Semantics are the JAX op's: a vocabulary that the block does not divide
gets a zero-padded last block whose columns are masked to ``NEG_INF``;
rows whose target is ``ignore_id`` count for nothing, and the loss is the
mean over the counted rows (at least one).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _blocks(table, block):
    """``(start, W_blk, width)`` over the vocabulary: ``W_blk`` is
    ``(block, d)`` f32, the last one zero-padded when ``block`` does not
    divide ``V``; ``width`` is its count of real rows."""
    V, d = table.shape
    block = min(block, V)
    w = table.float()
    for start in range(0, V, block):
        wb = w[start:start + block]
        width = wb.shape[0]
        if width < block:
            wb = torch.cat([wb, wb.new_zeros(block - width, d)])
        yield start, wb, width


def _block_logits(h32, wb, width):
    """One block's logits, its padding columns masked to ``NEG_INF``."""
    logits = h32 @ wb.T                                     # (N, block)
    if width < wb.shape[0]:
        logits[:, width:] = NEG_INF
    return logits


def _targets_in(targets, start, block):
    """Each row's target column inside the block and whether it is there."""
    local = targets - start
    inside = (local >= 0) & (local < block)
    return local.clamp(0, block - 1), inside


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, targets, ignore_id, block):
        N = h.shape[0]
        h32 = h.float()
        m = h32.new_full((N,), NEG_INF)
        s = h32.new_zeros(N)
        tgt = h32.new_zeros(N)
        for start, wb, width in _blocks(table, block):
            logits = _block_logits(h32, wb, width)
            new_m = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(-1)
            m = new_m
            local, inside = _targets_in(targets, start, wb.shape[0])
            picked = logits.gather(1, local[:, None])[:, 0]
            tgt = torch.where(inside, picked, tgt)
        logz = m + torch.log(s)
        valid = targets != ignore_id
        count = valid.sum().clamp_min(1)
        loss = torch.where(valid, logz - tgt, 0.0).sum() / count
        ctx.save_for_backward(h, table, targets, logz)
        ctx.ignore_id, ctx.block = ignore_id, block
        return loss

    @staticmethod
    def backward(ctx, g):
        h, table, targets, logz = ctx.saved_tensors
        want_h, want_w = ctx.needs_input_grad[:2]
        h32 = h.float()
        valid = targets != ctx.ignore_id
        count = valid.sum().clamp_min(1)
        scale = (g / count) * valid.float()                 # (N,)
        dh = torch.zeros_like(h32) if want_h else None
        dw = torch.empty(table.shape, dtype=torch.float32,
                         device=table.device) if want_w else None
        for start, wb, width in _blocks(table, ctx.block):
            logits = _block_logits(h32, wb, width)
            delta = torch.exp(logits - logz[:, None])       # softmax block
            local, inside = _targets_in(targets, start, wb.shape[0])
            delta.scatter_add_(1, local[:, None], -inside.float()[:, None])
            delta *= scale[:, None]
            if want_h:
                dh += delta @ wb
            if want_w:
                dw[start:start + width] = (delta.T @ h32)[:width]
        return (dh.to(h.dtype) if want_h else None,
                dw.to(table.dtype) if want_w else None, None, None, None)


def fused_linear_cross_entropy(h, table, targets, ignore_id: int = 0,
                               block: int = 512):
    """Mean cross-entropy of ``softmax(h @ table.T)`` against ``targets``
    without the ``(N, V)`` logits.

    ``h`` is ``(..., d)``, ``table`` ``(V, d)`` (the embedding layout of
    the tied head), ``targets`` ``(...)`` ids; rows whose target is
    ``ignore_id`` are left out of the mean.  Differentiable in ``h`` and
    ``table``; the gradients come back in their dtypes."""
    d = h.shape[-1]
    return _FusedLinearCrossEntropy.apply(
        h.reshape(-1, d), table, targets.reshape(-1).long(), int(ignore_id),
        int(block))
