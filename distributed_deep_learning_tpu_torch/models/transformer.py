"""The transformer family: the port of
``distributed_deep_learning_tpu/models/transformer.py`` — the GPT-style
``CausalLM``, for training and inference, and the north-star
``TransformerSeq2Seq`` (with the ``transformer`` workload's
``Seq2SeqAdapter``) and ``BertEncoder``.

Same function as the flax model: pre-LN layers (``ln_eps`` 1e-6), q/k/v/out
projections with biases, tanh-approximated GELU (flax's ``nn.gelu``
default), learned or rotary positions (RoPE rotates split halves, not
interleaved pairs), grouped-query attention, ``pad_id`` positions masked
out of attention, a weight-tied head computed in f32, and dropout after
the attention output and after the MLP while training.

``dtype=torch.bfloat16`` follows flax's ``dtype=bf16`` with f32
parameters: the embedding row and the ``pos`` table are cast to bf16 and
the residual stream stays bf16, each Linear casts its weight and bias to
its input's dtype and returns bf16, each LayerNorm takes its statistics in
f32 and returns its input's dtype, the dense attention's softmax runs in
f32, and the tied head stays f32 on both operands.  The casts are explicit
(not ``torch.autocast``, whose op lists put them elsewhere: under it
``layer_norm`` returns f32).  ``remat`` recomputes each layer in the
backward: under the policy ``nothing`` all of it (``torch.utils.checkpoint``,
replaying its dropout masks), under ``dots`` and ``dots_no_batch`` only
what lies between the ``Dense`` products (:func:`..layers.remat_call`).  :meth:`CausalLM.loss` is the
tied head fused with the token cross-entropy (:mod:`..ops.fused_ce`),
which never holds the ``(N, V)`` logits.

Every forward runs through :meth:`CausalLM.run`, which takes the
attention as a function ``attend(layer, q, k, v) -> y``.  The full
forward attends causally over its own tokens, densely or through the flash
kernels (``attention="flash"``, which take unexpanded GQA K/V);
:meth:`CausalLM.cached_forward`
attends over a dense KV cache (:func:`generate`'s); the serving engines
(``serve/engine.py``) attend over their slot table or block pools.  The
model itself holds no cache.

``TransformerSeq2Seq`` and ``BertEncoder`` share the layer: pre-LN
:class:`TransformerLayer` with ``causal`` self-attention and, in the
decoder, cross-attention over the encoder's output (q from the decoder,
k/v from ``encoded``, keys masked where the source is pad).  Their
attention is dense or the flash kernels, causal or not, with padded keys
(:func:`attend_qkv`); their head is the tied embedding in f32.

:func:`load_flax_params` carries weights over from a flax ``params`` tree
(nested dicts of numpy arrays) without importing flax.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import (  # noqa: F401
    REMAT_SAVED_OPS, lecun_normal_, recomputable, remat_call)
from distributed_deep_learning_tpu_torch.ops.attention import flash_attention
from distributed_deep_learning_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy
from distributed_deep_learning_tpu_torch.parallel.shards import (
    copy_to, gather_last)

#: ``attend(layer_index, q, k, v) -> y``: q ``(B, T, H, hd)``, k/v
#: ``(B, T, Hkv, hd)``, y ``(B, T, H, hd)``
Attend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]

MASK_FILL = -1e9   # the JAX package's fill: finite in bf16 as well
ATTENTIONS = ("dense", "flash")
DTYPES = (torch.float32, torch.bfloat16)

class Dense(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype
    (flax's ``Dense(dtype=...)`` over f32 parameters)."""

    def forward(self, x):
        return F.linear(x, recomputable(self.weight.to, x.dtype),
                        self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with f32 statistics and f32 scale/bias, returning
    ``dtype`` (flax's ``LayerNorm(dtype=...)``), or the input's dtype when
    ``dtype`` is None (the models whose residual stream stays in the
    compute dtype)."""

    def __init__(self, normalized_shape, eps: float = 1e-5, *,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(normalized_shape, eps=eps)
        self.out_dtype = dtype

    def forward(self, x):
        return F.layer_norm(recomputable(torch.Tensor.float, x),
                            self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(
                                self.out_dtype or x.dtype)


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """flax's ``nn.Dropout`` in train mode: keep each element with
    probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``;
    the mask comes from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(q, k, v, *, mask=None, key_valid=None,
                          causal=False, window=None, dtype=torch.float32):
    """Plain softmax attention; q/k/v are ``(B, T, H, D)``.

    ``key_valid`` is a ``(B, Tk)`` bool padding mask, ``causal`` a flag,
    ``window`` a causal sliding-window size; a dense ``mask``
    broadcastable to ``(B, H, Tq, Tk)`` is combined with them.  Masked
    logits are filled with -1e9, and the softmax runs in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if key_valid is not None:
        kv = key_valid[:, None, None, :]
        mask = kv if mask is None else mask & kv
    Tq, Tk = q.shape[1], k.shape[1]
    if causal:
        tril = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril()[None, None]
        mask = tril if mask is None else mask & tril
    if window is not None:
        if not causal and mask is None:
            raise ValueError("window requires causal attention")
        qp = torch.arange(Tq, device=q.device)[:, None]
        kp = torch.arange(Tk, device=q.device)[None, :]
        band = ((qp - kp) < window)[None, None]
        mask = band if mask is None else mask & band
    if mask is not None:
        # a scalar fill, not a tensor made from host data: a CUDA graph
        # (serve/graphs.py) cannot capture a host-to-device copy
        logits = logits.masked_fill(~mask, MASK_FILL)
    weights = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotary embedding on ``(B, T, H, D)`` (D even): feature pairs
    ``(x[..., :D/2], x[..., D/2:])`` rotate by ``position * base^(-2i/D)``.
    ``positions`` is ``(T,)``, shared by the batch, or ``(B, T)``."""
    if x.shape[-1] % 2:
        raise ValueError(f"RoPE requires an even head_dim, got "
                         f"{x.shape[-1]} (pick num_heads so that "
                         "d_model/num_heads is even)")
    d2 = x.shape[-1] // 2
    freqs = base ** (-torch.arange(d2, dtype=torch.float32,
                                   device=x.device) / d2)
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def causal_prefix_attention(q, k, v, key_valid, start, *, window=None):
    """Attention of a chunk of queries at positions ``start + arange(T)``
    over a whole cache ``k``/``v`` ``(B, L, H, hd)``: key ``j`` is seen
    iff ``j <= query position`` and ``key_valid[:, j]`` (and inside the
    window).  The decode-mode attention of the flax model, used for
    multi-token prefill chunks and for single-token steps alike.
    ``start`` is an int shared by the batch, or a ``(B,)`` tensor giving
    each row its own (the slot engine's per-slot positions, where the flax
    engine vmaps a per-slot ``cache_index``)."""
    T, L = q.shape[1], k.shape[1]
    steps = torch.arange(T, device=q.device)
    qpos = (start[:, None] + steps if isinstance(start, torch.Tensor)
            else (start + steps)[None])                      # (B or 1, T)
    kpos = torch.arange(L, device=q.device)
    mask = kpos <= qpos[..., None]                           # (B or 1, T, L)
    if window is not None:
        mask = mask & (qpos[..., None] - kpos < window)
    return dot_product_attention(q, k, v, mask=mask[:, None],
                                 key_valid=key_valid, dtype=q.dtype)


class MultiHeadAttention(nn.Module):
    """q/k/v projections to heads, RoPE, and the output projection; the
    attention between them is the caller's.

    Under tensor parallelism (``parallel.tensor_parallel``) the
    projections hold this rank's heads: ``num_heads`` and ``kv_heads``
    are the local counts (the GQA group is unchanged), and ``tp_group``
    is the ``model`` group, whose ranks sum their gradients of the input
    in the backward."""

    def __init__(self, d_model: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, rope: bool = False):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_kv_heads {kv_heads} must divide "
                             f"num_heads {num_heads}")
        self.num_heads, self.kv_heads = num_heads, kv_heads
        self.head_dim = d_model // num_heads
        self.rope = rope
        hd = self.head_dim
        self.q = Dense(d_model, num_heads * hd)
        self.k = Dense(d_model, kv_heads * hd)
        self.v = Dense(d_model, kv_heads * hd)
        self.out = Dense(num_heads * hd, d_model)
        self.tp_group = None

    @property
    def group(self) -> int:
        return self.num_heads // self.kv_heads

    def project(self, x, positions, x_kv=None):
        """``x`` ``(B, T, d)`` -> q ``(B, T, H, hd)``, and k/v ``(B, S,
        Hkv, hd)`` from ``x_kv`` ``(B, S, d)`` (``x`` itself unless given:
        cross-attention reads the encoder's output), rotated at
        ``positions`` under RoPE."""
        B, T, _ = x.shape
        x = copy_to(x, self.tp_group)
        kv = x if x_kv is None else copy_to(x_kv, self.tp_group)
        S = kv.shape[1]
        q = self.q(x).view(B, T, self.num_heads, self.head_dim)
        k = self.k(kv).view(B, S, self.kv_heads, self.head_dim)
        v = self.v(kv).view(B, S, self.kv_heads, self.head_dim)
        if self.rope:
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        return q, k, v

    def expand(self, kv):
        """GQA on the dense path: repeat each kv head for its group."""
        g = self.group
        return kv if g == 1 else kv.repeat_interleave(g, dim=2)


def reset_transformer_(model: nn.Module,
                       generator: Optional[torch.Generator] = None):
    """The flax initialisers of this module's models: N(0, 0.02)
    embeddings (``tok`` and a learned ``pos``), Xavier-uniform
    projections, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        model.tok.weight.normal_(0.0, 0.02, generator=generator)
        if model.pos is not None:
            model.pos.normal_(0.0, 0.02, generator=generator)
    return reset_linear_norm_(model, generator)


def reset_linear_norm_(model: nn.Module,
                       generator: Optional[torch.Generator] = None):
    """Xavier-uniform ``nn.Linear`` weights with zero biases and unit
    LayerNorm scales with zero biases, in module order."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                fan_in, fan_out = mod.in_features, mod.out_features
                a = float(np.sqrt(6.0 / (fan_in + fan_out)))
                mod.weight.uniform_(-a, a, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model


def attend_qkv(attention: str, attn: MultiHeadAttention, q, k, v, *,
               causal: bool, key_valid=None, window: Optional[int] = None):
    """The full forward's attention of one ``MultiHeadAttention``: the
    flash kernels (``attention="flash"``; GQA K/V unexpanded), dense
    attention (``"dense"``), or an adapter callable (JAX's
    ``attention_fn``: ``parallel.ring_attention``'s and
    ``parallel.ulysses``' ``make_attention_fn``, which also take the K/V
    unexpanded), causal or not, with ``key_valid`` ``(B, Tk)`` masking
    keys and an optional causal ``window``."""
    if callable(attention):
        return attention(q, k, v, key_valid=key_valid, causal=causal,
                         window=window, dtype=q.dtype)
    if attention == "flash":
        return flash_attention(q, k, v, causal=causal, key_valid=key_valid,
                               window=window)
    return dot_product_attention(q, attn.expand(k), attn.expand(v),
                                 key_valid=key_valid, causal=causal,
                                 window=window, dtype=q.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def tied_logits(tok: nn.Embedding, hidden):
    """The weight-tied output projection, f32 on both operands.  A table
    split over its vocabulary (``parallel.tensor_parallel``'s
    ``VocabParallelEmbedding``: ``group``, ``vocab_start``) computes its
    rows' logits and gathers every rank's."""
    group = getattr(tok, "group", None)
    h = copy_to(hidden.float(), group)
    logits = torch.einsum("...d,vd->...v", h, tok.weight.float())
    if group is None:
        return logits
    return gather_last(logits, group, tok.vocab_start)


class TransformerLayer(nn.Module):
    """Pre-LN block: self-attention, then (``cross_attention``) attention
    over an encoder's output, then the MLP, each with a residual.
    ``causal`` is the self-attention's masking, read by the model that
    builds the layer's attention (:meth:`attends`).  ``dtype`` is the
    LayerNorms' output dtype (None: their input's).  A subclass with its
    own :meth:`feed_forward` passes ``mlp_dim=None`` (no dense MLP)."""

    def __init__(self, d_model: int, num_heads: int,
                 mlp_dim: Optional[int], *,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 ln_eps: float = 1e-6, causal: bool = False,
                 cross_attention: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.causal, self.cross_attention = causal, cross_attention
        self.ln_attn = LayerNorm(d_model, eps=ln_eps, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, num_heads,
                                            num_kv_heads, rope)
        if cross_attention:
            self.ln_cross = LayerNorm(d_model, eps=ln_eps, dtype=dtype)
            self.cross_attn = MultiHeadAttention(d_model, num_heads)
        self.ln_mlp = LayerNorm(d_model, eps=ln_eps, dtype=dtype)
        if mlp_dim is not None:
            self.mlp_in = Dense(d_model, mlp_dim)
            self.mlp_out = Dense(mlp_dim, d_model)

    def attends(self, attention: str, self_valid=None, cross_valid=None):
        """``(attend, cross_attend)`` for :meth:`forward`: the
        self-attention (causal when the layer is) over ``self_valid``
        keys, and the non-causal cross-attention over ``cross_valid``
        keys (None without cross-attention)."""
        def attend(q, k, v):
            return attend_qkv(attention, self.self_attn, q, k, v,
                              causal=self.causal, key_valid=self_valid)

        if not self.cross_attention:
            return attend, None

        def cross(q, k, v):
            return attend_qkv(attention, self.cross_attn, q, k, v,
                              causal=False, key_valid=cross_valid)

        return attend, cross

    def forward(self, x, positions, attend, drop=None, encoded=None,
                cross_attend=None):
        """``attend(q, k, v) -> y`` is the layer's self-attention;
        ``drop(h)``, when given, is the dropout applied to each
        sub-block's output before its residual add; ``encoded`` ``(B, S,
        d)`` and ``cross_attend`` drive the cross-attention."""
        B, T, _ = x.shape
        q, k, v = self.self_attn.project(recomputable(self.ln_attn, x),
                                         positions)
        # flattened inside the recipe: the dense attention's output is a
        # transposed product, and its contiguous copy is what out() saves
        o = recomputable(lambda q, k, v: attend(q, k, v).reshape(B, T, -1),
                         q, k, v)
        h = self.self_attn.out(o)
        x = x + (h if drop is None else drop(h))
        if self.cross_attention:
            q, k, v = self.cross_attn.project(
                recomputable(self.ln_cross, x), None, x_kv=encoded)
            o = recomputable(
                lambda q, k, v: cross_attend(q, k, v).reshape(B, T, -1),
                q, k, v)
            h = self.cross_attn.out(o)
            x = x + (h if drop is None else drop(h))
        h = self.feed_forward(recomputable(self.ln_mlp, x))
        return x + (h if drop is None else drop(h))

    def feed_forward(self, h):
        """The MLP on the normalised residual ``h``."""
        return self.mlp_out(recomputable(_gelu, self.mlp_in(h)))


class CausalLM(nn.Module):
    """Decoder-only LM with the flax ``CausalLM``'s fields.

    ``forward(tokens)`` returns final hidden states ``(B, T, d)`` (logits
    ``(B, T, V)`` with ``with_logits``); ``logits_from`` is the tied head
    in f32.  ``attention`` picks the full forward's attention (``dense``
    or the ``flash`` kernels); ``dropout_rate`` applies in training mode
    only (``model.train()``); ``dtype`` is the compute dtype (f32 or
    bf16; the parameters stay f32)."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 8192, *,
                 pos_embedding: str = "learned",
                 attention_window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, ln_eps: float = 1e-6,
                 pad_id: Optional[int] = 0, with_logits: bool = False,
                 attention: str = "dense", dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {dtype}; choose from "
                             f"{DTYPES}")
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_embedding {pos_embedding!r}")
        if not callable(attention) and attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r}; choose from "
                             f"{ATTENTIONS}")
        self.attention, self.dropout_rate = attention, dropout_rate
        self.dtype = dtype
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.d_model, self.num_heads, self.mlp_dim = d_model, num_heads, mlp_dim
        self.max_len = max_len
        self.pos_embedding = pos_embedding
        self.attention_window = attention_window
        self.num_kv_heads = num_kv_heads
        self.pad_id, self.with_logits = pad_id, with_logits
        rope = pos_embedding == "rope"
        self.tok = nn.Embedding(vocab_size, d_model)
        self.pos = None if rope else nn.Parameter(
            torch.empty(max_len, d_model))
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, num_heads, mlp_dim,
                             num_kv_heads=num_kv_heads, rope=rope,
                             ln_eps=ln_eps, causal=True)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model, eps=ln_eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers (:func:`reset_transformer_`)."""
        return reset_transformer_(self, generator)

    def flax_layout(self, name: str):
        """``(to_flax, from_flax)`` for the parameter ``name`` (see
        :func:`flax_layout`)."""
        return flax_layout(name, self.layers[0].self_attn.head_dim)

    def token_valid(self, tokens):
        """Attendable positions: ``tokens != pad_id`` (all with no pad)."""
        if self.pad_id is None:
            return torch.ones_like(tokens, dtype=torch.bool)
        return tokens != self.pad_id

    def run(self, tokens, positions, attend: Attend, drop=None, *,
            remat: Optional[str] = None,
            generator: Optional[torch.Generator] = None):
        """Embed ``tokens`` ``(B, T)`` at absolute ``positions`` (``(T,)``
        or ``(B, T)``), run every layer with ``attend(i, q, k, v)`` as its
        attention (and ``drop`` as its dropout, when given), and return the
        final-norm hidden states in the compute dtype.  ``remat`` (a
        policy of :data:`REMAT_SAVED_OPS`) recomputes each layer;
        ``generator`` is the one ``drop`` draws from, replayed in the
        recompute."""
        x = self.tok(tokens).to(self.dtype)
        if self.pos is not None:
            x = x + self.pos[positions].to(x.dtype)
        for i, layer in enumerate(self.layers):
            def block(x, layer=layer, i=i):
                return layer(x, positions,
                             lambda q, k, v: attend(i, q, k, v), drop)
            x = block(x) if remat is None else \
                remat_call(block, x, remat, generator)
        return self.final_norm(x)

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        """The full causal forward; ``generator`` draws the dropout masks
        in training mode; ``remat`` (a policy name) recomputes each layer
        in the backward."""
        T = tokens.shape[1]
        valid = self.token_valid(tokens) if self.pad_id is not None \
            else None

        def attend(i, q, k, v):
            return attend_qkv(self.attention, self.layers[i].self_attn, q,
                              k, v, causal=True, key_valid=valid,
                              window=self.attention_window)

        drop = None
        if self.training and self.dropout_rate > 0:
            def drop(h):
                return dropout(h, self.dropout_rate, generator)

        h = self.run(tokens, torch.arange(T, device=tokens.device), attend,
                     drop, remat=remat, generator=generator)
        return self.logits_from(h) if self.with_logits else h

    def logits_from(self, hidden):
        """Weight-tied output projection, f32 on both operands
        (:func:`tied_logits`)."""
        return tied_logits(self.tok, hidden)

    def loss(self, hidden, targets):
        """Mean next-token cross-entropy through the fused head
        (:func:`..ops.fused_ce.fused_linear_cross_entropy`, f32 hidden and
        table): positions whose target is ``pad_id`` are left out, and with
        ``pad_id=None`` every position counts.  Pass the hidden states of
        ``tokens[:, :-1]`` against ``tokens[:, 1:]``."""
        # -1 never equals a vocabulary id, so it excludes nothing
        ignore_id = self.pad_id if self.pad_id is not None else -1
        # a vocab-split table: each rank's rows, combined over its group
        return fused_linear_cross_entropy(
            hidden.float(), self.tok.weight.float(), targets, ignore_id,
            group=getattr(self.tok, "group", None),
            vocab_start=getattr(self.tok, "vocab_start", 0))

    # --- dense KV cache (the flax decode-mode cache) ----------------------
    def init_cache(self, batch: int, total_len: int) -> dict:
        """Zeroed cache for ``batch`` rows of ``total_len`` positions:
        per layer ``cached_key``/``cached_value`` ``(B, L, Hkv, hd)`` in
        the compute dtype (the flax decode cache's) and ``cached_valid``
        ``(B, L)``, plus the shared ``index``."""
        dev, dt = self.tok.weight.device, self.dtype
        attn = self.layers[0].self_attn
        shape = (batch, total_len, attn.kv_heads, attn.head_dim)
        layers = [{"cached_key": torch.zeros(shape, dtype=dt, device=dev),
                   "cached_value": torch.zeros(shape, dtype=dt, device=dev),
                   "cached_valid": torch.zeros(shape[:2], dtype=torch.bool,
                                               device=dev)}
                  for _ in self.layers]
        return {"layers": layers, "index": 0}

    def cached_forward(self, tokens, cache: dict):
        """One cached forward (a prompt chunk or a 1-token step): writes
        the tokens' K/V and validity at ``cache["index"]``, attends each
        query over the causal prefix of the cache, advances the index.
        Updates ``cache`` in place and returns the hidden states."""
        idx, T = cache["index"], tokens.shape[1]
        if idx + T > cache["layers"][0]["cached_key"].shape[1]:
            raise ValueError(f"cache of {cache['layers'][0]['cached_key'].shape[1]}"
                             f" positions cannot take {T} more at {idx}")
        valid = self.token_valid(tokens)

        def attend(i, q, k, v):
            c = cache["layers"][i]
            c["cached_key"][:, idx:idx + T] = k
            c["cached_value"][:, idx:idx + T] = v
            c["cached_valid"][:, idx:idx + T] = valid
            attn = self.layers[i].self_attn
            return causal_prefix_attention(
                q, attn.expand(c["cached_key"]),
                attn.expand(c["cached_value"]), c["cached_valid"], idx,
                window=self.attention_window)

        positions = idx + torch.arange(T, device=tokens.device)
        h = self.run(tokens, positions, attend)
        cache["index"] = idx + T
        return h


def _same(t):
    return t


def flax_layout(name: str, head_dim: int):
    """``(to_flax, from_flax)`` for the parameter ``name`` of a model of
    this module: maps between its tensor and the flax parameter's layout,
    the inverse of :func:`load_flax_params` (``Dense`` kernels ``(in,
    out)``, the q/k/v ``DenseGeneral`` kernels ``(d, H, hd)`` with biases
    ``(H, hd)``, ``out``'s kernel ``(H, hd, d)``; every other parameter
    as it is).  Per-axis rules of the flax package that take a parameter's
    shape (Adafactor's factoring, per-channel int8 scales) go through
    it."""
    parts = name.split(".")
    if len(parts) < 2:
        return _same, _same
    hd = head_dim
    kind, leaf = parts[-2], parts[-1]
    if kind in ("q", "k", "v"):
        if leaf == "bias":
            return (lambda t: t.reshape(-1, hd),
                    lambda t: t.reshape(-1))
        return (lambda t: t.T.reshape(t.shape[1], -1, hd),
                lambda t: t.reshape(t.shape[0], -1).T)
    if kind == "out" and leaf == "weight":
        return (lambda t: t.T.reshape(-1, hd, t.shape[0]),
                lambda t: t.reshape(-1, t.shape[-1]).T)
    if leaf == "weight" and kind in ("mlp_in", "mlp_out", "mlm_dense",
                                     "router"):
        return (lambda t: t.T, lambda t: t.T)
    return _same, _same


def validate_sampling(top_k: int | None, top_p: float | None) -> None:
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def sample_tokens(model: CausalLM, hidden_last, *, temperature: float = 0.0,
                  top_k: int | None = None, top_p: float | None = None,
                  generator: Optional[torch.Generator] = None):
    """Project ``(B, d)`` hidden states through the tied head and pick one
    token per row: greedy at ``temperature == 0``, else sample from
    ``softmax(logits / temperature)`` after top-k then top-p filtering.
    The pad id is never picked."""
    return pick_tokens(model, model.logits_from(hidden_last),
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       generator=generator)


def pick_tokens(model: CausalLM, nl, *, temperature: float = 0.0,
                top_k: int | None = None, top_p: float | None = None,
                generator: Optional[torch.Generator] = None):
    """The choice half of :func:`sample_tokens`, on ``(B, V)`` f32 logits,
    which it masks in place.  Greedy without ``top_k`` it makes no host
    copy and no sync, so a CUDA graph can capture it."""
    if model.pad_id is not None:
        nl[:, model.pad_id].fill_(-torch.inf)
    if top_k is not None and top_k < nl.shape[-1]:
        kth = torch.topk(nl, top_k, dim=-1).values[:, -1:]
        nl = torch.where(nl >= kth, nl, -torch.inf)
    if temperature == 0.0:
        return nl.argmax(dim=-1)
    scaled = nl / temperature
    if top_p is not None and top_p < 1.0:
        order = torch.argsort(scaled, dim=-1, descending=True)
        sp = torch.softmax(scaled, dim=-1).gather(-1, order)
        drop_sorted = torch.cumsum(sp, dim=-1) - sp > top_p
        drop = torch.zeros_like(drop_sorted).scatter(-1, order, drop_sorted)
        scaled = torch.where(drop, -torch.inf, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: CausalLM, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None,
             generator: Optional[torch.Generator] = None):
    """KV-cached generation: the port of the flax package's
    ``generate``.  ``prompt`` is ``(B, P)`` token ids on the model's
    device; returns the ``(B, max_new_tokens)`` continuation in the
    prompt's dtype.  The whole prompt is prefilled in one
    :meth:`CausalLM.cached_forward` (the causal prefix mask keeps it
    causal), then each new token is a 1-token step; every row continues
    from its final position, pad positions in the prompt are masked out.
    Greedy at ``temperature == 0``, else sampled (top-k, then top-p) from
    ``generator``, which defaults to one seeded with 0 on the prompt's
    device (the flax default is ``jax.random.key(0)``)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    validate_sampling(top_k, top_p)
    B, P = prompt.shape
    if P + max_new_tokens > model.max_len:
        raise ValueError(f"prompt {P} + {max_new_tokens} new tokens "
                         f"exceeds max_len {model.max_len}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)

    def pick(hidden):
        return sample_tokens(model, hidden[:, -1], temperature=temperature,
                             top_k=top_k, top_p=top_p, generator=generator)

    cache = model.init_cache(B, P + max_new_tokens)
    out = [pick(model.cached_forward(prompt.long(), cache))]
    for _ in range(max_new_tokens - 1):
        out.append(pick(model.cached_forward(out[-1][:, None], cache)))
    return torch.stack(out, 1).to(prompt.dtype)


class _EncoderModel(nn.Module):
    """What :class:`TransformerSeq2Seq` and :class:`BertEncoder` share with
    the flax models: one ``Embed`` (``tok`` N(0, 0.02) and learned
    ``pos`` of ``max_len`` rows, positions from 0) whose table is also the
    f32 tied head, pre-LN :class:`TransformerLayer` stacks, the compute
    ``dtype``, ``attention`` (``dense`` or ``flash``), dropout in
    training mode, and ``remat`` per layer (:func:`remat_call`)."""

    def __init__(self, vocab_size: int, d_model: int, num_heads: int,
                 max_len: int, attention: str, dropout_rate: float,
                 dtype: torch.dtype):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {dtype}; choose from "
                             f"{DTYPES}")
        if not callable(attention) and attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r}; choose from "
                             f"{ATTENTIONS}")
        self.vocab_size, self.d_model, self.num_heads = vocab_size, \
            d_model, num_heads
        self.max_len = max_len
        self.attention, self.dropout_rate, self.dtype = attention, \
            dropout_rate, dtype
        self.tok = nn.Embedding(vocab_size, d_model)
        self.pos = nn.Parameter(torch.empty(max_len, d_model))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers (:func:`reset_transformer_`)."""
        return reset_transformer_(self, generator)

    def flax_layout(self, name: str):
        return flax_layout(name, self.d_model // self.num_heads)

    def embed(self, tokens):
        """Token rows plus positions ``0..T-1``, in the compute dtype."""
        T = tokens.shape[1]
        return self.tok(tokens).to(self.dtype) + self.pos[:T].to(self.dtype)

    def logits_from(self, hidden):
        """Weight-tied output projection, f32 on both operands
        (:func:`tied_logits`)."""
        return tied_logits(self.tok, hidden)

    def _drop(self, generator):
        if not (self.training and self.dropout_rate > 0):
            return None
        return lambda h: dropout(h, self.dropout_rate, generator)

    def stack(self, layers, x, drop, remat, generator, *, self_valid,
              encoded=None, cross_valid=None):
        """``x`` through ``layers``, each with its attention built over
        ``self_valid`` (and ``cross_valid`` keys of ``encoded``)."""
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in layers:
            attend, cross = layer.attends(self.attention, self_valid,
                                          cross_valid)

            def block(x, layer=layer, attend=attend, cross=cross):
                return layer(x, positions, attend, drop, encoded=encoded,
                             cross_attend=cross)
            x = block(x) if remat is None else \
                remat_call(block, x, remat, generator)
        return x


class TransformerSeq2Seq(_EncoderModel):
    """Transformer-base encoder-decoder (WMT14 en-de shape) with the flax
    ``TransformerSeq2Seq``'s fields: ``forward({"inputs": (B, S),
    "targets": (B, T)})`` (token ids, 0 = pad) is teacher-forced training
    and returns f32 logits ``(B, T, V)`` at every target position.

    One shared embedding serves source, target and the tied head.  The
    encoder's self-attention and the cross-attention mask pad sources
    (``inputs != 0``); the decoder's self-attention is causal over the
    right-shifted targets (BOS 0) and masks keys where ``targets == 0``,
    as the flax model does."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 6,
                 d_model: int = 512, num_heads: int = 8, mlp_dim: int = 2048,
                 *, max_len: int = 4096, attention: str = "dense",
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, d_model, num_heads, max_len, attention,
                         dropout_rate, dtype)
        self.num_layers = num_layers
        self.enc = nn.ModuleList(
            TransformerLayer(d_model, num_heads, mlp_dim)
            for _ in range(num_layers))
        self.enc_norm = LayerNorm(d_model, eps=1e-6)
        self.dec = nn.ModuleList(
            TransformerLayer(d_model, num_heads, mlp_dim, causal=True,
                             cross_attention=True)
            for _ in range(num_layers))
        self.dec_norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        inputs, targets = batch["inputs"], batch["targets"]
        src_valid, tgt_valid = inputs != 0, targets != 0
        drop = self._drop(generator)
        x = self.stack(self.enc, self.embed(inputs), drop, remat, generator,
                       self_valid=src_valid)
        encoded = self.enc_norm(x)
        y_in = F.pad(targets, (1, 0))[:, :-1]       # shift right, BOS 0
        y = self.stack(self.dec, self.embed(y_in), drop, remat, generator,
                       self_valid=tgt_valid, encoded=encoded,
                       cross_valid=src_valid)
        return self.logits_from(self.dec_norm(y))


class Seq2SeqAdapter(nn.Module):
    """The ``transformer`` workload's model: ``x`` is source and target
    ids concatenated along the sequence (``src_len`` source positions),
    as the flax ``Seq2SeqAdapter`` takes them."""

    def __init__(self, model: TransformerSeq2Seq, src_len: int):
        super().__init__()
        self.model, self.src_len = model, src_len

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.model.reset_parameters(generator)
        return self

    def flax_layout(self, name: str):
        return self.model.flax_layout(name)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        return self.model({"inputs": x[:, :self.src_len],
                           "targets": x[:, self.src_len:]},
                          generator=generator, remat=remat)


class BertEncoder(_EncoderModel):
    """BERT-base-shaped bidirectional encoder with the MLM head (the flax
    ``BertEncoder``): non-causal layers over ``tokens != 0`` keys, a final
    LayerNorm, then ``mlm_dense`` (``lecun_normal``, as flax's default
    ``Dense``) → GELU → ``mlm_norm`` → the tied f32 head."""

    def __init__(self, vocab_size: int = 30522, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12, mlp_dim: int = 3072,
                 *, max_len: int = 4096, attention: str = "dense",
                 dropout_rate: float = 0.0, ln_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, d_model, num_heads, max_len, attention,
                         dropout_rate, dtype)
        self.num_layers = num_layers
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, num_heads, mlp_dim, ln_eps=ln_eps)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model, eps=ln_eps)
        self.mlm_dense = Dense(d_model, d_model)
        self.mlm_norm = LayerNorm(d_model, eps=ln_eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        lecun_normal_(self.mlm_dense.weight, self.d_model, generator)
        return self

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        x = self.stack(self.layers, self.embed(tokens),
                       self._drop(generator), remat, generator,
                       self_valid=tokens != 0)
        x = self.final_norm(x)
        h = self.mlm_norm(_gelu(self.mlm_dense(x)))
        return self.logits_from(h)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def linear_flax_state(node, prefix, n_in_axes=1):
    """A flax ``Dense``/``DenseGeneral`` (``n_in_axes`` input axes) →
    ``nn.Linear``'s ``weight`` ``(out, in)`` and ``bias`` under
    ``prefix``."""
    kern = np.asarray(node["kernel"])
    n_in = int(np.prod(kern.shape[:n_in_axes]))
    return {f"{prefix}weight": _t(kern.reshape(n_in, -1).T),
            f"{prefix}bias": _t(np.asarray(node["bias"]).reshape(-1))}


def _norm_state(node, prefix):
    return {f"{prefix}weight": _t(node["scale"]),
            f"{prefix}bias": _t(node["bias"])}


def _attention_state(node, prefix):
    sd = {}
    for name in ("q", "k", "v"):
        sd.update(linear_flax_state(node[name], f"{prefix}{name}."))
    sd.update(linear_flax_state(node["out"], f"{prefix}out.", n_in_axes=2))
    return sd


def layer_flax_state(lp, prefix: str) -> dict:
    """One flax ``TransformerLayer``'s (or ``MoETransformerLayer``'s)
    params → a :class:`TransformerLayer` (``models.moe``'s
    ``MoETransformerLayer``) state under ``prefix`` (``""`` or ending in a
    dot).  flax numbers a layer's LayerNorms in call order:
    self-attention, cross-attention (decoder layers only), MLP.  The
    routed MLP's ``w_in``/``w_out`` keep flax's ``(E, d, m)``/``(E, m,
    d)`` layout."""
    cross = "cross_attn" in lp
    sd = _norm_state(lp["LayerNorm_0"], f"{prefix}ln_attn.")
    sd.update(_attention_state(lp["self_attn"], f"{prefix}self_attn."))
    if cross:
        sd.update(_norm_state(lp["LayerNorm_1"], f"{prefix}ln_cross."))
        sd.update(_attention_state(lp["cross_attn"], f"{prefix}cross_attn."))
    sd.update(_norm_state(lp[f"LayerNorm_{2 if cross else 1}"],
                          f"{prefix}ln_mlp."))
    if "moe" in lp:
        moe = lp["moe"]
        sd.update(linear_flax_state(moe["router"], f"{prefix}moe.router."))
        sd[f"{prefix}moe.w_in"] = _t(moe["w_in"])
        sd[f"{prefix}moe.w_out"] = _t(moe["w_out"])
        return sd
    sd.update(linear_flax_state(lp["Dense_0"], f"{prefix}mlp_in."))
    sd.update(linear_flax_state(lp["Dense_1"], f"{prefix}mlp_out."))
    return sd


def _stacked_trunk_state(trunk) -> dict:
    """A ``PipelinedTrunk``'s flax params (``block_<i>`` subtrees whose
    leaves lead with ``(S,)`` or ``(V, S)``) → ``stack.blocks.<i>...``
    stacked the same way."""
    lead = np.asarray(trunk["block_0"]["LayerNorm_0"]["scale"]).shape[:-1]
    slices = []
    for index in np.ndindex(*lead):
        sd = {}
        i = 0
        while f"block_{i}" in trunk:
            sub = _map_tree(lambda a: np.asarray(a)[index],
                            trunk[f"block_{i}"])
            sd.update(layer_flax_state(sub, f"stack.blocks.{i}."))
            i += 1
        slices.append(sd)
    return {k: torch.stack([s[k] for s in slices]).reshape(
                *lead, *slices[0][k].shape) for k in slices[0]}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_flax_params(params) -> dict:
    """``state_dict`` from a flax ``params`` tree (nested dicts of numpy
    arrays, as ``jax.tree.map(np.asarray, params)`` gives them; a
    ``{"params": ...}`` wrapper is accepted) for the model it comes from:
    :class:`CausalLM` (``layer_i`` and ``final_norm``),
    :class:`BertEncoder` (the same plus ``mlm_dense`` and ``mlm_norm``),
    ``models.moe.MoELM`` (``layer_i`` and ``moe_layer_i`` in turn),
    :class:`TransformerSeq2Seq` (``enc_i``, ``enc_norm``, ``dec_i`` with
    ``cross_attn``, ``dec_norm``), the workload's
    :class:`Seq2SeqAdapter` (the seq2seq tree under ``model``) or
    ``models.pipelined_lm.PipelinedLM`` (``embed``, the stacked ``trunk``
    and ``head``).  Dense kernels ``(in, out)`` and the ``DenseGeneral``
    head kernels ``(d, H, hd)`` / ``(H, hd, d)`` become ``nn.Linear``
    weights ``(out, in)``."""
    if "params" in params and "embed" not in params \
            and "model" not in params:
        params = params["params"]
    if "model" in params and "embed" not in params:
        return {f"model.{k}": v
                for k, v in load_flax_params(params["model"]).items()}
    if "trunk" in params:
        sd = {"embed.tok.weight": _t(params["embed"]["tok"]["embedding"])}
        if "pos" in params["embed"]:
            sd["embed.pos"] = _t(params["embed"]["pos"])
        sd.update({f"trunk.{k}": v
                   for k, v in _stacked_trunk_state(params["trunk"]).items()})
        sd.update(linear_flax_state(params["head"]["Dense_0"], "head.dense."))
        return sd

    def stack(prefix, into):
        i = 0
        while f"{prefix}_{i}" in params:
            sd.update(layer_flax_state(params[f"{prefix}_{i}"],
                                       f"{into}.{i}."))
            i += 1

    sd = {"tok.weight": _t(params["embed"]["tok"]["embedding"])}
    if "pos" in params["embed"]:
        sd["pos"] = _t(params["embed"]["pos"])
    if "enc_0" in params:
        stack("enc", "enc")
        stack("dec", "dec")
        sd.update(_norm_state(params["enc_norm"], "enc_norm."))
        sd.update(_norm_state(params["dec_norm"], "dec_norm."))
        return sd
    i = 0
    while True:
        lp = params.get(f"layer_{i}", params.get(f"moe_layer_{i}"))
        if lp is None:
            break
        sd.update(layer_flax_state(lp, f"layers.{i}."))
        i += 1
    sd.update(_norm_state(params["final_norm"], "final_norm."))
    if "mlm_dense" in params:
        sd.update(linear_flax_state(params["mlm_dense"], "mlm_dense."))
        sd.update(_norm_state(params["mlm_norm"], "mlm_norm."))
    return sd
