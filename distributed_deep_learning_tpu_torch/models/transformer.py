"""GPT-style CausalLM, for training and inference: the port of
``distributed_deep_learning_tpu/models/transformer.py``.

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
replaying its dropout masks), under ``dots`` only what lies between the
``Dense`` products (:func:`remat_call`).  :meth:`CausalLM.loss` is the
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

:func:`load_flax_params` carries weights over from a flax ``params`` tree
(nested dicts of numpy arrays) without importing flax.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_deep_learning_tpu_torch.ops.attention import flash_attention
from distributed_deep_learning_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy

#: ``attend(layer_index, q, k, v) -> y``: q ``(B, T, H, hd)``, k/v
#: ``(B, T, Hkv, hd)``, y ``(B, T, H, hd)``
Attend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]

MASK_FILL = -1e9   # the JAX package's fill: finite in bf16 as well
ATTENTIONS = ("dense", "flash")
DTYPES = (torch.float32, torch.bfloat16)

#: ``--remat-policy`` -> the products whose outputs the backward keeps
#: (jax's ``dots_saveable`` and ``dots_with_no_batch_dims_saveable``: in
#: this model the batched dots are the dense attention's, whose output the
#: port recomputes under either); "nothing" recomputes every op of the layer
REMAT_SAVED_OPS = {
    "nothing": (),
    "dots": ("Dense",),
    "dots_no_batch": ("Dense",),
}


class _Recompute:
    """The ``dots`` policy for one layer's forward: every tensor autograd
    saves passes through :meth:`pack`, and the outputs the layer marks
    recomputable (:func:`recomputable`: its LayerNorms, casts, attention
    and GELU, everything but a ``Dense`` product) are dropped when the
    layer's forward ends and computed again when the backward unpacks one
    of them.  A saved tensor is matched to a marked output by its storage
    (device and address, both alive until :meth:`finish`), so views of it
    (a reshape a matmul saves) are rebuilt from the recomputed tensor with
    the same strides."""

    active: Optional["_Recompute"] = None

    def __init__(self):
        self.marked = []       # (tensor, fn, args)
        self.saved = []        # every pack's handle, resolved in finish()

    def mark(self, out, fn, args):
        # only a non-empty tensor that owns its whole storage: anything
        # else sharing that storage is a view of it
        if out.numel() and out.is_contiguous() and \
                out.storage_offset() == 0 and \
                out.untyped_storage().nbytes() == \
                out.numel() * out.element_size():
            self.marked.append((out, fn, args))

    def pack(self, t):
        handle = [t, None]     # the tensor, or a recipe once finished
        self.saved.append(handle)
        return handle

    @staticmethod
    def unpack(handle):
        t, recipe = handle
        if recipe is None:
            return t
        return recipe.view(id(handle))

    def finish(self):
        recipes = {}
        for out, fn, args in self.marked:
            recipes[_storage_key(out)] = _Recipe(fn, args)
        for handle in self.saved:
            t = handle[0]
            recipe = recipes.get(_storage_key(t))
            if recipe is None:
                continue
            recipe.views[id(handle)] = (t.size(), t.stride(),
                                        t.storage_offset())
            recipe.waiting.add(id(handle))
            handle[:] = [None, recipe]
        self.marked = self.saved = None


def _storage_key(t):
    return t.device, t.untyped_storage().data_ptr()


class _Recipe:
    """How to compute one dropped output again, cached until each saved
    view of it has been unpacked once (a second backward through a
    retained graph computes it again at each unpack)."""

    def __init__(self, fn, args):
        self.fn, self.args, self.out = fn, args, None
        self.views = {}        # handle id -> (size, stride, offset)
        self.waiting = set()   # handle ids not unpacked yet

    def view(self, key):
        out = self.out
        if out is None:
            with torch.no_grad():
                out = self.fn(*self.args)
        self.waiting.discard(key)
        self.out = out if self.waiting else None
        return out.as_strided(*self.views[key])


def recomputable(fn, *args):
    """``fn(*args)``; under the ``dots`` policy the backward computes it
    again instead of keeping it (see :class:`_Recompute`)."""
    out = fn(*args)
    rc = _Recompute.active
    if rc is not None and out.grad_fn is not None and \
            all(out is not a for a in args):
        rc.mark(out, fn, args)
    return out


class Dense(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype
    (flax's ``Dense(dtype=...)`` over f32 parameters)."""

    def forward(self, x):
        return F.linear(x, recomputable(self.weight.to, x.dtype),
                        self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with f32 statistics and f32 scale/bias, returning
    the input's dtype (flax's ``LayerNorm(dtype=...)``)."""

    def forward(self, x):
        return F.layer_norm(recomputable(torch.Tensor.float, x),
                            self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def remat_call(fn, x, policy: str, generator: Optional[torch.Generator]):
    """``fn(x)`` with its activations recomputed in the backward.

    ``nothing``: ``torch.utils.checkpoint`` (non-reentrant) keeps only
    ``x`` and recomputes all of ``fn``.  ``checkpoint`` restores the
    default generators' state, not ``generator``'s, so the recompute
    rewinds ``generator`` to where the forward found it (the same dropout
    masks) and puts it back after.

    ``dots`` and ``dots_no_batch``: the outputs of the ``Dense`` products
    are kept, and what lies between them (LayerNorms, casts, the attention
    and the GELU) is computed again when the backward needs it
    (:class:`_Recompute`, through saved-tensor hooks; no op-level
    dispatch).  Dropout masks are kept, so nothing random is replayed."""
    if policy not in REMAT_SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy!r}; choose from "
                         f"{sorted(REMAT_SAVED_OPS)}")
    if REMAT_SAVED_OPS[policy]:
        rc, outer = _Recompute(), _Recompute.active
        _Recompute.active = rc
        try:
            with torch.autograd.graph.saved_tensors_hooks(rc.pack,
                                                          rc.unpack):
                y = fn(x)
        finally:
            _Recompute.active = outer
        rc.finish()
        return y
    if generator is None:
        return checkpoint(fn, x, use_reentrant=False)
    before, ran = generator.get_state(), []

    def replay(x):
        if not ran:                 # the forward: draw as usual
            ran.append(True)
            return fn(x)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return fn(x)
        finally:
            generator.set_state(after)

    return checkpoint(replay, x, use_reentrant=False)


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
    attention between them is the caller's."""

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

    @property
    def group(self) -> int:
        return self.num_heads // self.kv_heads

    def project(self, x, positions):
        """``x`` ``(B, T, d)`` -> q ``(B, T, H, hd)``, k/v ``(B, T, Hkv,
        hd)``, rotated at ``positions`` under RoPE."""
        B, T, _ = x.shape
        q = self.q(x).view(B, T, self.num_heads, self.head_dim)
        k = self.k(x).view(B, T, self.kv_heads, self.head_dim)
        v = self.v(x).view(B, T, self.kv_heads, self.head_dim)
        if self.rope:
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        return q, k, v

    def expand(self, kv):
        """GQA on the dense path: repeat each kv head for its group."""
        g = self.group
        return kv if g == 1 else kv.repeat_interleave(g, dim=2)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class TransformerLayer(nn.Module):
    """Pre-LN block: self-attention then MLP, each with a residual."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.ln_attn = LayerNorm(d_model, eps=ln_eps)
        self.self_attn = MultiHeadAttention(d_model, num_heads,
                                            num_kv_heads, rope)
        self.ln_mlp = LayerNorm(d_model, eps=ln_eps)
        self.mlp_in = Dense(d_model, mlp_dim)
        self.mlp_out = Dense(mlp_dim, d_model)

    def forward(self, x, positions, attend, drop=None):
        """``attend(q, k, v) -> y`` is the layer's attention; ``drop(h)``,
        when given, is the dropout applied to the attention and MLP
        outputs before their residual adds."""
        B, T, _ = x.shape
        q, k, v = self.self_attn.project(recomputable(self.ln_attn, x),
                                         positions)
        # flattened inside the recipe: the dense attention's output is a
        # transposed product, and its contiguous copy is what out() saves
        o = recomputable(lambda q, k, v: attend(q, k, v).reshape(B, T, -1),
                         q, k, v)
        h = self.self_attn.out(o)
        x = x + (h if drop is None else drop(h))
        h = recomputable(_gelu, self.mlp_in(recomputable(self.ln_mlp, x)))
        h = self.mlp_out(h)
        return x + (h if drop is None else drop(h))


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
        if attention not in ATTENTIONS:
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
                             ln_eps=ln_eps)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model, eps=ln_eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers: N(0, 0.02) embeddings, Xavier-uniform
        projections, zero biases, unit LayerNorm scales."""
        with torch.no_grad():
            self.tok.weight.normal_(0.0, 0.02, generator=generator)
            if self.pos is not None:
                self.pos.normal_(0.0, 0.02, generator=generator)
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    fan_in, fan_out = mod.in_features, mod.out_features
                    a = float(np.sqrt(6.0 / (fan_in + fan_out)))
                    mod.weight.uniform_(-a, a, generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
        return self

    def flax_layout(self, name: str):
        """``(to_flax, from_flax)`` for the parameter ``name``: maps
        between its tensor and the flax parameter's layout, the inverse of
        :func:`load_flax_params` (``Dense`` kernels ``(in, out)``, the q/k/v
        ``DenseGeneral`` kernels ``(d, H, hd)`` with biases ``(H, hd)``,
        ``out``'s kernel ``(H, hd, d)``; every other parameter as it is).
        Per-axis rules of the flax package that take a parameter's shape
        (Adafactor's factoring, per-channel int8 scales) go through it."""
        parts = name.split(".")
        if len(parts) < 2 or parts[0] != "layers":
            return _same, _same
        layer = self.layers[int(parts[1])]
        hd = layer.self_attn.head_dim
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
        if leaf == "weight" and kind in ("mlp_in", "mlp_out"):
            return (lambda t: t.T, lambda t: t.T)
        return _same, _same

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
            if self.attention == "flash":
                return flash_attention(q, k, v, causal=True, key_valid=valid,
                                       window=self.attention_window)
            attn = self.layers[i].self_attn
            return dot_product_attention(
                q, attn.expand(k), attn.expand(v), key_valid=valid,
                causal=True, window=self.attention_window, dtype=q.dtype)

        drop = None
        if self.training and self.dropout_rate > 0:
            def drop(h):
                return dropout(h, self.dropout_rate, generator)

        h = self.run(tokens, torch.arange(T, device=tokens.device), attend,
                     drop, remat=remat, generator=generator)
        return self.logits_from(h) if self.with_logits else h

    def logits_from(self, hidden):
        """Weight-tied output projection, f32 on both operands."""
        return torch.einsum("...d,vd->...v", hidden.float(),
                            self.tok.weight.float())

    def loss(self, hidden, targets):
        """Mean next-token cross-entropy through the fused head
        (:func:`..ops.fused_ce.fused_linear_cross_entropy`, f32 hidden and
        table): positions whose target is ``pad_id`` are left out, and with
        ``pad_id=None`` every position counts.  Pass the hidden states of
        ``tokens[:, :-1]`` against ``tokens[:, 1:]``."""
        # -1 never equals a vocabulary id, so it excludes nothing
        ignore_id = self.pad_id if self.pad_id is not None else -1
        return fused_linear_cross_entropy(hidden.float(),
                                          self.tok.weight.float(), targets,
                                          ignore_id)

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


def load_flax_params(params) -> dict:
    """``state_dict`` for :class:`CausalLM` from the flax model's
    ``params`` tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them; a ``{"params": ...}``
    wrapper is accepted).  Dense kernels ``(in, out)`` and the
    ``DenseGeneral`` head kernels ``(d, H, hd)`` / ``(H, hd, d)`` become
    ``nn.Linear`` weights ``(out, in)``."""
    if "params" in params and "embed" not in params:
        params = params["params"]

    def t(x):
        return torch.from_numpy(np.array(x, copy=True))

    def linear(node, prefix, n_in_axes=1):
        kern = np.asarray(node["kernel"])
        n_in = int(np.prod(kern.shape[:n_in_axes]))
        return {f"{prefix}.weight": t(kern.reshape(n_in, -1).T),
                f"{prefix}.bias": t(np.asarray(node["bias"]).reshape(-1))}

    def norm(node, prefix):
        return {f"{prefix}.weight": t(node["scale"]),
                f"{prefix}.bias": t(node["bias"])}

    sd = {"tok.weight": t(params["embed"]["tok"]["embedding"])}
    if "pos" in params["embed"]:
        sd["pos"] = t(params["embed"]["pos"])
    i = 0
    while f"layer_{i}" in params:
        lp, pre = params[f"layer_{i}"], f"layers.{i}"
        sd.update(norm(lp["LayerNorm_0"], f"{pre}.ln_attn"))
        sd.update(norm(lp["LayerNorm_1"], f"{pre}.ln_mlp"))
        for name in ("q", "k", "v"):
            sd.update(linear(lp["self_attn"][name],
                             f"{pre}.self_attn.{name}"))
        sd.update(linear(lp["self_attn"]["out"], f"{pre}.self_attn.out",
                         n_in_axes=2))
        sd.update(linear(lp["Dense_0"], f"{pre}.mlp_in"))
        sd.update(linear(lp["Dense_1"], f"{pre}.mlp_out"))
        i += 1
    sd.update(norm(params["final_norm"], "final_norm"))
    return sd
