"""Ulysses sequence parallelism: all-to-all head/sequence resharding.  The
port of ``distributed_deep_learning_tpu/parallel/ulysses.py``.

Activations arrive split over the sequence (each rank of the ``seq``
group owns ``T/S`` tokens of every head); an ``all_to_all_single``
scatters the heads and gathers the sequence, so each rank holds ``H/S``
whole-sequence heads; attention runs locally (the ``inner`` function:
the port's dense ``dot_product_attention`` by default, or the flash
kernels through :func:`..ops.attention.make_attention_fn`), and the
mirror all-to-all restores the sequence split.  Both all-to-alls are
autograd-aware (each one's backward is the other).  ``key_valid`` has no
head axis to scatter, so it is all-gathered over the group.

:func:`make_attention_fn` is the model adapter; like the ring's
(:mod:`.ring_attention`), it takes and returns the global arrays.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.parallel.ring_attention import (
    check_divisible, seq_all_gather, seq_gather, seq_slice)


def _to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``(B, Tl, H, D)`` sequence blocks -> ``(B, S*Tl, H/S, D)``."""
    S = dist.get_world_size(group)
    B, Tl, H, D = x.shape
    send = x.reshape(B, Tl, S, H // S, D).permute(2, 0, 1, 3, 4)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, S * Tl, H // S, D)


def _to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``(B, T, H/S, D)`` head groups -> ``(B, T/S, H, D)``."""
    S = dist.get_world_size(group)
    B, T, Hs, D = x.shape
    send = x.reshape(B, S, T // S, Hs, D).permute(1, 0, 2, 3, 4)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, T // S, S * Hs, D)


class _ToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g.contiguous(), ctx.group), None


class _ToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g.contiguous(), ctx.group), None


def _dense_inner(q, k, v, *, causal=False, dtype=None, **kw):
    """The port's dense attention, GQA K/V expanded (a head group's query
    heads read its own KV heads)."""
    from distributed_deep_learning_tpu_torch.models.transformer import \
        dot_product_attention

    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    return dot_product_attention(q, k, v, causal=causal, dtype=dtype, **kw)


def check_heads(H: int, Hkv: int, S: int) -> None:
    """Each rank takes ``H/S`` query and ``Hkv/S`` KV heads."""
    if H % S or Hkv % S:
        raise ValueError(f"{H} heads ({Hkv} KV heads) not divisible over "
                         f"seq={S} (use ring attention for head counts the "
                         "mesh does not divide)")


def ulysses_attention(q, k, v, *, group, causal: bool = False,
                      window: int | None = None, key_valid=None,
                      attention_fn=None):
    """Exact attention for this rank's sequence block over ``group``: q
    ``(B, Tl, H, D)``, k/v ``(B, Tkl, Hkv, D)``, ``key_valid`` ``(B,
    Tkl)``; ``attention_fn(q, k, v, causal=..., dtype=..., [window=...],
    [key_valid=...])`` runs on the full sequence of ``H/S`` heads."""
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    check_heads(q.shape[2], k.shape[2], dist.get_world_size(group))
    if key_valid is not None and tuple(key_valid.shape) != \
            (k.shape[0], k.shape[1]):
        raise ValueError(f"key_valid shape {tuple(key_valid.shape)} != "
                         f"({k.shape[0]}, {k.shape[1]})")
    inner = attention_fn or _dense_inner
    qh, kh, vh = (_ToHeads.apply(t, group) for t in (q, k, v))
    kw = {} if window is None else {"window": window}
    if key_valid is not None:
        kw["key_valid"] = seq_all_gather(key_valid.to(torch.uint8),
                                         group).to(torch.bool)
    oh = inner(qh, kh, vh, causal=causal, dtype=qh.dtype, **kw)
    return _ToSeq.apply(oh.contiguous(), group)


def make_attention_fn(group, causal: bool = False, inner=None):
    """Ulysses as a model's ``attention`` callable, on the global arrays
    (the JAX adapter); ``inner`` picks the local attention (e.g. the flash
    kernels' :func:`..ops.attention.make_attention_fn`).  A dense ``mask``
    is refused, as in JAX."""
    forced_causal = causal

    def attn(q, k, v, *, mask=None, key_valid=None, causal=False,
             window=None, dtype=None):
        if mask is not None:
            raise NotImplementedError(
                "ulysses attention supports key_valid padding masks and "
                "causal=...; arbitrary dense mask tensors are unsupported "
                "— a global (T, T) mask defeats sequence sharding")
        check_divisible(q.shape[1], k.shape[1], group)
        kv = None
        if key_valid is not None:
            n = key_valid.shape[1] // dist.get_world_size(group)
            my = dist.get_rank(group)
            kv = key_valid[:, my * n:(my + 1) * n]
        out = ulysses_attention(seq_slice(q, group), seq_slice(k, group),
                                seq_slice(v, group), group=group,
                                causal=causal or forced_causal,
                                window=window, key_valid=kv,
                                attention_fn=inner)
        return seq_gather(out, group).to(dtype or q.dtype)

    return attn
