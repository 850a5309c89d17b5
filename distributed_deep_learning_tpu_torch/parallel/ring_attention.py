"""Ring attention: exact attention over a sequence split across the ranks
of a ``seq`` group.  The port of
``distributed_deep_learning_tpu/parallel/ring_attention.py``.

Queries stay put; each rank's K/V block (and its ``key_valid`` block)
travels round the group by ``batch_isend_irecv``, one hop a step, and
every rank folds each visiting block into its queries' softmax.  The
hop for block *r+1* is issued before block *r*'s attention runs, so the
wire and the compute overlap.

* **On the CPU** the fold is JAX's ``_block_attention`` recurrence, step
  for step (running max ``m``, denominator ``l``, numerator ``acc``, in
  f32; GQA K/V expanded): ``fold="recurrence"``, the default there.
* **On the card** (``fold="lse"``, the only fold there) each hop is one
  call of the flash forward kernel
  (:func:`..ops.attention.flash_forward`), which returns ``(out_h,
  lse_h)``; the hops merge by their LSE in f32.  On CPU tensors the same
  fold runs through the kernel's plain version, so the tests hold the
  merge against JAX too.  A hop's mask is chosen
  from the blocks' global positions (:func:`hop_mask`): the diagonal
  block runs causal with the window, an earlier block runs non-causal
  when every pair is visible, else causal with ``q_offset = q_start -
  k_start``; a block wholly in the future or outside the window is not
  launched (and still forwarded round the ring).  A hop's row that sees
  no key has an LSE near -1e20 and weighs 0 in the merge, so a row with
  no valid key anywhere returns exactly 0, as JAX's does.

The backward (:class:`_Ring`) sends K/V round again; each hop calls
:func:`..ops.attention.flash_backward_parts` (the dQ and dK/dV kernels,
or their plain versions) with the **global** LSE and ``delta =
rowsum(dO * O)``; dQ accumulates on the rank, and dK/dV accumulate in
f32 and travel with their block back to its owner.

:func:`make_attention_fn` is the model adapter (``models.transformer``'s
``attention`` callable).  As under JAX's ``shard_map``, it takes and
returns the global ``(B, T, H, D)`` arrays, which the rest of the model
holds replicated over ``seq``: it slices its rank's block, runs the
ring, and all-gathers the output; its backward slices the incoming
(replicated) gradient and all-gathers dQ, dK and dV, so no parameter
gradient needs a reduction over ``seq``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.parallel.collectives import Hop

NEG_INF = -1e30
#: a hop's LSE below this means the row saw no key in that hop (the
#: kernels' empty row: max(m, -1e20) + log(max(l, 1e-30)))
LSE_FLOOR = -1e19


def hop_mask(my: int, j: int, Tl: int, Tkl: int, causal: bool,
             window: int | None) -> dict | None:
    """The flash call's mask for rank ``my``'s queries (block of ``Tl``)
    against block ``j`` of the keys (``Tkl``): ``dict(causal, window,
    q_offset)``, or None when no pair of the two blocks is visible."""
    if not causal:
        return dict(causal=False, window=None, q_offset=0)
    q_lo, q_hi = my * Tl, my * Tl + Tl - 1
    k_lo, k_hi = j * Tkl, j * Tkl + Tkl - 1
    if q_hi < k_lo or (window is not None and q_lo - k_hi >= window):
        return None
    if q_lo >= k_hi and (window is None or q_hi - k_lo < window):
        return dict(causal=False, window=None, q_offset=0)
    return dict(causal=True, window=window, q_offset=q_lo - k_lo)


def ring_hops(my: int, S: int, Tl: int, Tkl: int, causal: bool,
              window: int | None) -> list:
    """``[(j, mask or None)]`` in hop order: hop ``r`` visits block ``(my
    - r) mod S``; the kernel runs for each hop whose mask is not None."""
    return [((my - r) % S, hop_mask(my, (my - r) % S, Tl, Tkl, causal,
                                    window)) for r in range(S)]


def _block_attention(q, k, v, m, l, acc, q_start, k_start, causal,
                     window=None, key_valid=None):
    """JAX's fold of one visiting block, in f32: q ``(B, H, Tq, D)``,
    k/v ``(B, H, Tk, D)``, m/l ``(B, H, Tq)``, acc ``(B, H, Tq, D)``,
    ``key_valid`` ``(B, Tk)`` of the visiting block."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        q_pos = q_start + torch.arange(q.shape[2], device=q.device)
        k_pos = k_start + torch.arange(k.shape[2], device=q.device)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)[None,
                                                                      None]
    if key_valid is not None:
        kvm = key_valid[:, None, None, :]
        mask = kvm if mask is None else mask & kvm
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    new_m = torch.maximum(m, scores.amax(-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None])
    if key_valid is not None:
        p = p * mask                 # a row with no valid key yet counts 0
    new_l = l * correction + p.sum(-1)
    new_acc = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v)
    return new_m, new_l, new_acc


def _rotate(blocks: list, group) -> list:
    """Start the hop of each tensor of ``blocks`` (None stays None)."""
    return [None if b is None else Hop(b, group) for b in blocks]


def _landed(hops: list) -> list:
    return [None if h is None else h.wait() for h in hops]


def _as_bytes(kv):
    return None if kv is None else kv.to(torch.uint8)


def _as_bool(kv):
    return None if kv is None else kv.to(torch.bool)


def _forward_plain(q, k, v, key_valid, group, causal, window):
    """JAX's recurrence over the ring: ``(out, lse)``, lse ``(B, H, Tl)``
    f32 (-1e20 where a row saw no key)."""
    S, my = dist.get_world_size(group), dist.get_rank(group)
    Tl, Tkl = q.shape[1], k.shape[1]
    G = q.shape[2] // k.shape[2]
    q_ = q.float().transpose(1, 2)
    m = torch.full(q_.shape[:3], NEG_INF, device=q.device)
    l = torch.zeros(q_.shape[:3], device=q.device)
    acc = torch.zeros_like(q_)
    blk = [k, v, _as_bytes(key_valid)]
    for r in range(S):
        hops = _rotate(blk, group) if r < S - 1 else None
        kb, vb, kvb = blk
        k_ = kb.float().repeat_interleave(G, dim=2).transpose(1, 2)
        v_ = vb.float().repeat_interleave(G, dim=2).transpose(1, 2)
        m, l, acc = _block_attention(q_, k_, v_, m, l, acc, my * Tl,
                                     ((my - r) % S) * Tkl, causal, window,
                                     _as_bool(kvb))
        if hops is not None:
            blk = _landed(hops)
    seen = l > 0
    out = torch.where(seen[..., None], acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    lse = torch.where(seen, m + torch.log(l.clamp_min(1e-30)), -1e20)
    return out.transpose(1, 2).to(q.dtype), lse


def _forward_kernels(q, k, v, key_valid, group, causal, window, sm_scale):
    """One flash forward call a visible hop, merged by LSE in f32."""
    from distributed_deep_learning_tpu_torch.ops.attention import \
        flash_forward

    S, my = dist.get_world_size(group), dist.get_rank(group)
    plan = ring_hops(my, S, q.shape[1], k.shape[1], causal, window)
    shape = (q.shape[0], q.shape[2], q.shape[1])          # (B, H, Tl)
    M = torch.full(shape, -math.inf, device=q.device)
    L = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    blk = [k, v, _as_bytes(key_valid)]
    for r, (_, mask) in enumerate(plan):
        hops = _rotate(blk, group) if r < S - 1 else None
        if mask is not None:
            kb, vb, kvb = blk
            o, lse = flash_forward(q, kb, vb, _as_bool(kvb),
                                   sm_scale=sm_scale, **mask)
            lse = torch.where(lse > LSE_FLOOR, lse, -math.inf)
            new = torch.maximum(M, lse)
            safe = torch.where(torch.isfinite(new), new, 0.0)
            a, b = torch.exp(M - safe), torch.exp(lse - safe)
            L = L * a + b
            acc = acc * a.transpose(1, 2)[..., None] \
                + o.float() * b.transpose(1, 2)[..., None]
            M = new
        if hops is not None:
            blk = _landed(hops)
    seen = L > 0
    out = acc / torch.where(seen, L, 1.0).transpose(1, 2)[..., None]
    lse = torch.where(seen, M + torch.log(torch.where(seen, L, 1.0)), -1e20)
    return out.to(q.dtype), lse


#: the forward's folds of the visiting blocks
FOLDS = ("recurrence", "lse")


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, group, causal, window, sm_scale,
                fold):
        if fold == "recurrence":
            out, lse = _forward_plain(q, k, v, key_valid, group, causal,
                                      window)
        else:
            out, lse = _forward_kernels(q, k, v, key_valid, group, causal,
                                        window, sm_scale)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.opts = (group, causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        from distributed_deep_learning_tpu_torch.ops.attention import (
            _delta, flash_backward_parts)

        q, k, v, key_valid, out, lse = ctx.saved_tensors
        group, causal, window, sm_scale = ctx.opts
        S, my = dist.get_world_size(group), dist.get_rank(group)
        dout = dout.contiguous()
        delta = _delta(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        blk = [k, v, _as_bytes(key_valid)]
        plan = ring_hops(my, S, q.shape[1], k.shape[1], causal, window)
        for r, (_, mask) in enumerate(plan):
            kb, vb, kvb = blk
            hops = _rotate(blk, group) if r < S - 1 else None
            if mask is not None:
                dq_h, dk_h, dv_h = flash_backward_parts(
                    q, kb, vb, _as_bool(kvb), dout, lse, delta,
                    sm_scale=sm_scale, **mask)
                dq += dq_h.float()
                dkv[0] += dk_h.float()
                dkv[1] += dv_h.float()
            # the block's dK/dV go on with it; after S hops each is home
            dkv = Hop(dkv, group).wait()
            if hops is not None:
                blk = _landed(hops)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q, k, v, *, group, causal: bool = False,
                   window: int | None = None, key_valid=None,
                   sm_scale: float | None = None, fold: str | None = None):
    """Exact attention for this rank's sequence block over ``group`` (the
    ``seq`` ranks, in sequence order): q ``(B, Tl, H, D)``, k/v ``(B,
    Tkl, Hkv, D)`` (``Hkv`` dividing H), ``key_valid`` ``(B, Tkl)`` bool
    for this rank's keys.  ``causal`` and ``window`` act on global
    positions (``rank * Tl``, ``rank * Tkl``).  ``fold`` (one of
    :data:`FOLDS`; default ``lse`` on the card, ``recurrence`` on the
    CPU) says how the forward folds the visiting blocks.  Returns ``(B,
    Tl, H, D)`` in q's dtype; differentiable in q, k and v."""
    on_card = q.device.type == "cuda"
    if fold is None:
        fold = "lse" if on_card else "recurrence"
    if fold not in FOLDS or (on_card and fold != "lse"):
        raise ValueError(f"fold {fold!r}: choose from {FOLDS} ('lse' on "
                         "the card, where each hop is a flash kernel call)")
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads not a multiple of "
                         f"{k.shape[2]} KV heads")
    if key_valid is not None and tuple(key_valid.shape) != \
            (k.shape[0], k.shape[1]):
        raise ValueError(f"key_valid shape {tuple(key_valid.shape)} != "
                         f"({k.shape[0]}, {k.shape[1]})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if on_card:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if key_valid is not None:
            key_valid = key_valid.contiguous()
    return _Ring.apply(q, k, v, key_valid, group, bool(causal), window,
                       float(sm_scale), fold)


# --- the model adapter: global arrays in, global arrays out ---------------

class _SeqSlice(torch.autograd.Function):
    """This rank's block of dim 1; the backward all-gathers the blocks'
    gradients (each rank's is its block's)."""

    @staticmethod
    def forward(ctx, x, group):
        S, my = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[1] // S
        ctx.group = group
        return x[:, my * n:(my + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return seq_all_gather(g, ctx.group), None


class _SeqGather(torch.autograd.Function):
    """Every rank's block along dim 1, in rank order; the backward keeps
    this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return seq_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        S, my = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        n = g.shape[1] // S
        return g[:, my * n:(my + 1) * n].contiguous(), None


def seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``(B, n, ...)`` blocks of every rank -> ``(B, S*n, ...)``."""
    S = dist.get_world_size(group)
    parts = x.new_empty((S,) + tuple(x.shape))
    dist.all_gather_into_tensor(parts, x.unsqueeze(0).contiguous(),
                                group=group)
    return parts.transpose(0, 1).reshape((x.shape[0], S * x.shape[1])
                                         + tuple(x.shape[2:]))


def seq_slice(x, group):
    return _SeqSlice.apply(x, group)


def seq_gather(x, group):
    return _SeqGather.apply(x, group)


def check_divisible(T: int, Tk: int, group) -> None:
    S = dist.get_world_size(group)
    if T % S or Tk % S:
        raise ValueError(f"sequence lengths q={T}, k={Tk} must divide "
                         f"seq={S}")


def make_attention_fn(group, causal: bool = False, fold: str | None = None):
    """Ring attention as a model's ``attention`` callable (the JAX
    adapter): ``attn(q, k, v, *, mask=None, key_valid=None, causal=False,
    window=None, dtype=None)`` on the global arrays.  ``causal=True`` here
    forces it for every call; ``fold`` is :func:`ring_attention`'s.  A
    dense ``mask`` is refused, as in JAX."""
    forced_causal = causal

    def attn(q, k, v, *, mask=None, key_valid=None, causal=False,
             window=None, dtype=None):
        if mask is not None:
            raise NotImplementedError(
                "ring attention computes masks internally from global "
                "positions (causal=...) and per-key validity "
                "(key_valid=...); arbitrary dense mask tensors are "
                "unsupported — a global (T, T) mask defeats sequence "
                "sharding")
        check_divisible(q.shape[1], k.shape[1], group)
        kv = None
        if key_valid is not None:
            n = key_valid.shape[1] // dist.get_world_size(group)
            my = dist.get_rank(group)
            kv = key_valid[:, my * n:(my + 1) * n]
        out = ring_attention(seq_slice(q, group), seq_slice(k, group),
                             seq_slice(v, group), group=group,
                             causal=causal or forced_causal, window=window,
                             key_valid=kv, fold=fold)
        return seq_gather(out, group).to(dtype or q.dtype)

    return attn


def full_attention(q, k, v, *, causal: bool = False):
    """Single-device reference: ``softmax(q k^T / sqrt(d)) v`` on ``(B, T,
    H, D)``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
