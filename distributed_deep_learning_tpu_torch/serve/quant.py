"""Serving-path quantization: int8 or bf16 weights and KV cache.

The port of ``distributed_deep_learning_tpu/serve/quant.py``.  Decode reads
every weight and the slot's whole KV history for a few flops a byte, so
bytes, not flops, bound how many slots, how long a context and how large a
prefix cache fit on the card.  This module cuts those bytes with the
symmetric int8 rule of the JAX package's compressed collectives
(``parallel/collectives.py``), of which it keeps its own copy
(:func:`quantize_int8`): ``scale = max(amax / 127, 1e-30)``, ``q =
clip(round(x / scale), -127, 127)`` (round half to even, a division, not a
product with the reciprocal), and ``q * scale`` back.

* **Weights** (:func:`quantize_weights`): every parameter of two or more
  axes IN ITS FLAX LAYOUT (``CausalLM.flax_layout``) gets one scale per
  channel of that layout's last axis: a ``Dense`` kernel ``(in, out)`` per
  output feature, the q/k/v kernels ``(d, H, hd)`` and biases ``(H, hd)``
  per head-dim index shared by the heads, ``out``'s kernel ``(H, hd, d)``
  per output feature, and the tied table ``(V, d)`` and the ``pos`` table
  per model-dim column.  The other biases and the LayerNorm scales, vectors
  in flax, stay full precision.  ``bf16`` is a plain cast of
  every floating parameter.  The engine's serving copy holds the weights at
  rest and dequantizes each where it is used, inside the tick
  (:class:`QuantDense`, :class:`QuantEmbedding`, :class:`QuantTable`), so no
  full-precision copy of all weights exists between ticks.
* **KV cache** (:func:`quantize_kv`): one scale per position per head
  (:func:`quantize_rows`), so a position written by a decode tick never
  rescales its committed neighbours: blocks stay bit-frozen once written,
  and prefix reuse, copy-on-write and chain hashes work on the quantized
  pools unchanged.  A :class:`QuantTensor` carries the int8 payload and its
  f32 scales with the same leading dimensions (``(N, bs, Hkv, 1)`` scales
  for ``(N, bs, Hkv, hd)`` pools, the layout the decode kernel takes), so
  the pool ops index both alike.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.serve.cache import KV_LEAVES
from distributed_deep_learning_tpu_torch.utils.config import SERVE_DTYPES


@dataclasses.dataclass
class QuantTensor:
    """An int8 payload ``q`` and its f32 scales ``s`` as one value.  ``s``
    has ``q``'s leading dimensions (``q.shape[:-1] + (1,)`` for KV rows),
    so indexing the leading axes indexes both."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.s.numel() * self.s.element_size())

    def __getitem__(self, idx) -> "QuantTensor":
        return QuantTensor(self.q[idx], self.s[idx])

    def __setitem__(self, idx, value: "QuantTensor") -> None:
        if not isinstance(value, QuantTensor):
            raise TypeError("a float write into an int8 payload: quantize "
                            "it first (quantize_kv)")
        self.q[idx] = value.q
        self.s[idx] = value.s

    def reshape(self, shape) -> "QuantTensor":
        shape = tuple(shape)
        return QuantTensor(self.q.reshape(shape),
                           self.s.reshape(shape[:-1] + self.s.shape[-1:]))


def is_quant(x) -> bool:
    return isinstance(x, QuantTensor)


def check_dtype(name: str, value):
    """Validate a ``kv_dtype`` / ``weight_dtype`` (``None`` passes: full
    precision); the engines and the CLIs reject with this message."""
    if value is not None and value not in SERVE_DTYPES:
        raise ValueError(f"unknown {name} {value!r}; "
                         f"choose from {SERVE_DTYPES} (or leave unset "
                         "for full precision)")
    return value


# --- the int8 rule ----------------------------------------------------------


def quantize_int8(x, dim):
    """``(q, scale)``: symmetric int8 over ``dim`` (the reduced axes keep
    size 1 in ``scale``)."""
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_channels(x) -> QuantTensor:
    """One scale per channel of the last axis: ``s`` is ``(C,)``."""
    flat = x.reshape(-1, x.shape[-1])
    q, s = quantize_int8(flat, 0)
    return QuantTensor(q.reshape(x.shape), s.reshape(-1))


def quantize_rows(x) -> QuantTensor:
    """One scale per row over the last axis: ``s`` is ``x.shape[:-1] +
    (1,)`` (per position per head for KV)."""
    q, s = quantize_int8(x, -1)
    return QuantTensor(q, s)


def dequant(qt: QuantTensor, dtype):
    """``q * s`` in f32, cast to ``dtype``."""
    return (qt.q.float() * qt.s).to(dtype)


# --- weights ----------------------------------------------------------------


def _channel_dequant(q, s):
    """An int8 weight ``(out, ...)`` whose rows take ``s`` ``(C,)`` by
    ``row % C`` (the flax parameter's last axis, see the module
    docstring), as f32."""
    return (q.view(-1, s.numel(), *q.shape[1:]).float()
            * s.view(-1, *([1] * (q.dim() - 1)))).view(q.shape)


class QuantDense(nn.Module):
    """A ``Dense`` with an int8 weight: ``q`` ``(out, in)`` and the flax
    kernel's per-channel scales ``s``.  The bias is int8 too (``bias_q``,
    ``bias_s``) where flax holds it as a matrix (the q/k/v heads' ``(H,
    hd)``), else f32.  Both are dequantized at each call."""

    def __init__(self, dense, weight_layout, bias_layout):
        super().__init__()
        self.in_features, self.out_features = (dense.in_features,
                                               dense.out_features)
        to_flax, from_flax = weight_layout
        qt = quantize_channels(to_flax(dense.weight.detach()))
        self.register_buffer("q", from_flax(qt.q).contiguous())
        self.register_buffer("s", qt.s)
        to_flax, from_flax = bias_layout
        bias = dense.bias.detach()
        if to_flax(bias).dim() >= 2:
            qt = quantize_channels(to_flax(bias))
            self.register_buffer("bias_q", from_flax(qt.q).contiguous())
            self.register_buffer("bias_s", qt.s)
        else:
            self.register_parameter(
                "bias_f", nn.Parameter(bias.clone(), requires_grad=False))

    @property
    def weight(self):
        return _channel_dequant(self.q, self.s)

    @property
    def bias(self):
        if hasattr(self, "bias_q"):
            return _channel_dequant(self.bias_q, self.bias_s)
        return self.bias_f

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class QuantEmbedding(nn.Module):
    """The tied table ``(V, d)`` in int8 with one scale per model-dim
    column: a lookup dequantizes its rows, :attr:`weight` the table."""

    def __init__(self, table):
        super().__init__()
        qt = quantize_channels(table.detach())
        self.register_buffer("q", qt.q)
        self.register_buffer("s", qt.s)

    @property
    def weight(self):
        return self.q.float() * self.s

    def forward(self, tokens):
        return self.q[tokens].float() * self.s


class QuantTable(QuantEmbedding):
    """The learned ``pos`` table in int8, indexed like the parameter."""

    def __getitem__(self, positions):
        return self(positions)


def quantize_weights(model, weight_dtype: str):
    """The at-rest serving copy of ``model`` (a
    :class:`..models.transformer.CausalLM`; the caller's model is left as it
    is): ``bf16`` casts every floating parameter, ``int8`` replaces each
    ``Dense``, the tied table and the ``pos`` table by their int8 forms
    (see the module docstring).  The copy computes in the model's own
    dtype: each weight goes back to it where it is used."""
    check_dtype("weight_dtype", weight_dtype)
    out = copy.deepcopy(model)
    if weight_dtype == "bf16":
        return out.to(torch.bfloat16)
    from distributed_deep_learning_tpu_torch.models.transformer import Dense

    for name, mod in list(out.named_modules()):
        for child_name, child in list(mod.named_children()):
            if isinstance(child, Dense):
                full = f"{name}.{child_name}" if name else child_name
                setattr(mod, child_name, QuantDense(
                    child, out.flax_layout(f"{full}.weight"),
                    out.flax_layout(f"{full}.bias")))
    out.tok = QuantEmbedding(out.tok.weight)
    if out.pos is not None:
        table = out.pos.detach()
        del out.pos
        out.pos = QuantTable(table)
    return out


def dequantize_weights(model) -> dict:
    """The full-precision (f32) ``state_dict`` of a serving copy, under the
    names of :class:`..models.transformer.CausalLM`'s own."""
    sd = {}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantDense):
            sd[f"{name}.weight"] = mod.weight
            sd[f"{name}.bias"] = mod.bias.detach().float()
        elif isinstance(mod, QuantEmbedding):
            key = name if isinstance(mod, QuantTable) else f"{name}.weight"
            sd[key] = mod.weight
    for name, p in model.named_parameters():
        if not name.endswith(".bias_f"):
            sd.setdefault(name, p.detach().float())
    return sd


def weight_bytes(model) -> int:
    """At-rest bytes of a model's weights: payloads, scales and the vectors
    left in full precision."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


# --- KV cache ---------------------------------------------------------------


def quantize_kv(x, kv_dtype: str):
    """Fresh K or V rows to their at-rest form: per-row int8 or a bf16
    cast."""
    if kv_dtype == "bf16":
        return x.to(torch.bfloat16)
    if kv_dtype == "int8":
        return quantize_rows(x)
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                     f"choose from {SERVE_DTYPES}")


def quantize_cache_span(span: dict, kv_dtype: str) -> dict:
    """A model-layout cache dict (``cached_key``/``cached_value`` floats,
    ``cached_valid``) to the pools' at-rest form; validity passes exact."""
    return {name: quantize_kv(t, kv_dtype) if name in KV_LEAVES else t
            for name, t in span.items()}


def dequant_cache(cache: dict, dtype) -> dict:
    """An at-rest cache dict (a gathered slot) to the model's floating
    layout in ``dtype``."""
    out = {}
    for name, t in cache.items():
        if is_quant(t):
            t = dequant(t, dtype)
        elif name in KV_LEAVES:
            t = t.to(dtype)
        out[name] = t
    return out


def cast_kv(cache: dict, dtype) -> dict:
    """Cast the KV leaves of a non-int8 cache dict (the slot table's bf16
    path, where the cast is the whole transform)."""
    return {name: t.to(dtype) if name in KV_LEAVES else t
            for name, t in cache.items()}


# --- calibration ------------------------------------------------------------


#: the declared drift bound is ``max(DRIFT_MARGIN * worst, DRIFT_FLOOR)``
#: (the JAX function's defaults, which every caller keeps)
DRIFT_MARGIN, DRIFT_FLOOR = 1.5, 5e-3


@torch.no_grad()
def calibrate_weight_drift(model, qmodel, probe_tokens):
    """What int8 weights do to the greedy path on a probe batch, and the
    per-token log-prob drift bound to hold the engine to.

    Runs the full forward (its own attention) of ``model`` and of its serving copy ``qmodel``
    (:func:`quantize_weights`), compares ``log_softmax`` at each position's
    full-precision argmax, and returns the worst drift, ``max(DRIFT_MARGIN
    * worst, DRIFT_FLOOR)`` as the declared bound, the argmax agreement and the
    probe size (the JAX function's record)."""
    dev = next(model.parameters()).device
    toks = torch.as_tensor(probe_tokens, device=dev).long()
    if toks.dim() == 1:
        toks = toks[None]

    def logprobs(m):
        was = m.training
        h = m.eval()(toks)
        m.train(was)
        return torch.log_softmax(h if m.with_logits else m.logits_from(h),
                                 dim=-1)

    ref, deq = logprobs(model), logprobs(qmodel.to(dev))
    pick = ref.argmax(-1, keepdim=True)
    drift = (ref.gather(-1, pick) - deq.gather(-1, pick)).abs()
    measured = float(drift.max())
    return {
        "measured_max_drift": measured,
        "declared_bound": max(DRIFT_MARGIN * measured, DRIFT_FLOOR),
        "probe_argmax_agreement": float(
            (deq.argmax(-1) == pick[..., 0]).float().mean()),
        "probe_tokens": int(toks.numel()),
    }
