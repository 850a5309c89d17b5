"""Flash attention, forward and backward: the port of
``distributed_deep_learning_tpu/ops/attention_pallas.py``.

Three CUDA kernels in ``csrc/flash_attention.cu`` replace the three TPU
kernels: the forward (``_fwd_kernel``), dQ (``_dq_kernel``) and the fused
dK/dV (``_dkv_kernel``).  :func:`flash_attention` is the public entry,
a ``torch.autograd.Function`` whose forward saves ``q, k, v, key_valid,
out, lse`` and whose backward computes ``delta = rowsum(dO * O)`` in
torch, then runs dQ, then dK/dV.

The semantics are the TPU kernels': masked logits are ``NEG_INF``
(-1e30), ``lse = max(m, -1e20) + log(max(l, 1e-30))`` and ``out = acc /
max(l, 1e-30)``, so a fully padded row gets exactly zero gradients;
causal masking is top-left (query and key positions both count from 0);
a sliding ``window`` keeps ``q_pos - k_pos < window``; the low-level
entries take a ``q_offset`` added to every query position first (ring
attention's visiting blocks, :mod:`..parallel.ring_attention`); ``key_valid``
masks keys per batch row; GQA k/v carry ``Hkv`` heads and query head
``h`` reads kv head ``h // (H // Hkv)``.  All three kernels run on the
tensor cores (bf16 natively, f32 as 3xTF32, which keeps f32 accuracy);
in bf16 they round P and dS to bf16 before the products that take them,
as the TPU kernel does, and the plain versions round the same.

CPU tensors go to the plain versions, :func:`flash_attention_reference`
and :func:`flash_backward_reference`; CUDA tensors launch the kernels or
raise.  ``flash_forward.launches``, ``flash_backward_dq.launches`` and
``flash_backward_dkv.launches`` count the kernel launches.  The kernels
build at first use (:mod:`.build`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

import torch

from distributed_deep_learning_tpu_torch.ops.build import CSRC, build_library

NEG_INF = -1e30

_SOURCE = CSRC / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


# --- plain versions ---------------------------------------------------------

def _logits(q, k, key_valid, causal, window, sm_scale, q_offset=0):
    """Masked f32 logits ``(B, H, Tq, Tk)`` with k expanded over the
    group; masked entries hold ``NEG_INF``.  Query ``i`` sits at position
    ``i + q_offset``."""
    B, Tq, H, _ = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    kx = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * sm_scale
    ok = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        qp = torch.arange(Tq, device=q.device)[:, None] + q_offset
        kp = torch.arange(Tk, device=q.device)[None, :]
        ok = qp >= kp
        if window is not None:
            ok = ok & (qp - kp < window)
    ok = ok[None, None]
    if key_valid is not None:
        ok = ok & key_valid[:, None, None, :]
    return torch.where(ok, s, NEG_INF)


def _group_sum(x, Hkv):
    """``(B, T, H, D)`` per-query-head gradients summed over each GQA group
    to ``(B, T, Hkv, D)``, in f32."""
    B, T, H, D = x.shape
    return x.float().reshape(B, T, Hkv, H // Hkv, D).sum(3)


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              key_valid=None, sm_scale: float | None = None,
                              window: int | None = None, q_offset: int = 0):
    """The forward kernel's function in plain torch, in f32: returns
    ``out`` ``(B, Tq, H, D)`` in q's dtype and ``lse`` ``(B, H, Tq)`` f32.
    P is rounded to the input dtype before ``P.V`` (a no-op in f32), as
    the kernels do; ``l`` sums the unrounded P.  A row whose keys are all
    masked averages every key here and the visited ones in the kernel;
    both are finite and have zero gradient."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    Hkv = k.shape[2]
    s = _logits(q, k, key_valid, causal, window, sm_scale, q_offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    vx = v.float().repeat_interleave(q.shape[2] // Hkv, dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", _rounded(p, q.dtype), vx)
    out = out / l.permute(0, 2, 1, 3)
    lse = (m.clamp_min(-1e20) + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def flash_backward_reference(q, k, v, key_valid, out, lse, dout, *,
                             causal: bool = False,
                             sm_scale: float | None = None,
                             window: int | None = None, q_offset: int = 0):
    """The dQ and dK/dV kernels' function in plain torch, in f32:
    ``p = exp(s - lse)``, ``ds = p * (dO.V^T - delta) * scale`` with
    ``delta = rowsum(dO * O)``; dK/dV summed over each GQA group.  P and
    dS are rounded to the input dtype before the products that take them
    (a no-op in f32), as the kernels do.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    return _backward_plain(q, k, v, key_valid, dout, lse, _delta(out, dout),
                           causal=causal, sm_scale=sm_scale, window=window,
                           q_offset=q_offset)


def _backward_plain(q, k, v, key_valid, dout, lse, delta, *, causal,
                    sm_scale, window, q_offset=0):
    """:func:`flash_backward_reference` from a given ``lse`` and ``delta``
    (both ``(B, H, Tq)`` f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    H, Hkv = q.shape[2], k.shape[2]
    s = _logits(q, k, key_valid, causal, window, sm_scale, q_offset)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    vx = v.float().repeat_interleave(H // Hkv, dim=2)
    kx = k.float().repeat_interleave(H // Hkv, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vx)
    ds = _rounded(p * (dp - delta[..., None]) * sm_scale, q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, q.dtype), do)
    return (dq.to(q.dtype), _group_sum(dk, Hkv).to(k.dtype),
            _group_sum(dv, Hkv).to(v.dtype))


def _rounded(x, dtype):
    """f32 ``x`` rounded to ``dtype`` and back: what a kernel hands a
    product whose operands are in ``dtype`` (TPU kernel: ``p.astype(...)``,
    ``ds.astype(...)``)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _delta(out, dout):
    """``rowsum(dO * O)`` in f32, ``(B, H, Tq)``: computed once outside the
    kernels, as the TPU wrapper does."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# --- kernel wrappers --------------------------------------------------------

def flash_forward(q, k, v, key_valid, *, causal, sm_scale, window,
                  q_offset: int = 0):
    """``(out, lse)``: the plain version on CPU tensors, the forward kernel
    on CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         key_valid=key_valid,
                                         sm_scale=sm_scale, window=window,
                                         q_offset=q_offset)
    _check_kernel_args(q, k, v, key_valid)
    B, Tq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", q, k, v, key_valid, [out, lse],
            causal=causal, sm_scale=sm_scale, window=window,
            q_offset=q_offset)
    flash_forward.launches += 1
    return out, lse


def flash_backward_dq(q, k, v, key_valid, dout, lse, delta, *, causal,
                      sm_scale, window, q_offset: int = 0):
    """dQ kernel (CUDA tensors only)."""
    _check_kernel_args(q, k, v, key_valid, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_dq_launch", q, k, v, key_valid, [dout, lse, delta, dq],
            causal=causal, sm_scale=sm_scale, window=window,
            q_offset=q_offset)
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, key_valid, dout, lse, delta, *, causal,
                       sm_scale, window, q_offset: int = 0):
    """dK/dV kernel (CUDA tensors only), summed over each GQA group."""
    _check_kernel_args(q, k, v, key_valid, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv_launch", q, k, v, key_valid,
            [dout, lse, delta, dk, dv], causal=causal, sm_scale=sm_scale,
            window=window, q_offset=q_offset)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def flash_backward(q, k, v, key_valid, out, lse, dout, *, causal, sm_scale,
                   window, q_offset: int = 0):
    """``(dq, dk, dv)``: the plain version on CPU tensors; on CUDA tensors
    ``delta`` in torch, then the dQ kernel, then the dK/dV kernel."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, key_valid, out, lse, dout,
                                        causal=causal, sm_scale=sm_scale,
                                        window=window, q_offset=q_offset)
    dout = dout.contiguous()
    return flash_backward_parts(q, k, v, key_valid, dout, lse,
                                _delta(out, dout), causal=causal,
                                sm_scale=sm_scale, window=window,
                                q_offset=q_offset)


def flash_backward_parts(q, k, v, key_valid, dout, lse, delta, *, causal,
                         sm_scale, window, q_offset: int = 0):
    """``(dq, dk, dv)`` from a given ``lse`` and ``delta`` (a ring hop's
    share of the gradient under the global softmax): the plain version on
    CPU tensors, the dQ then the dK/dV kernel on CUDA tensors."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, key_valid, dout, lse, delta, **kw)
    dq = flash_backward_dq(q, k, v, key_valid, dout, lse, delta, **kw)
    dk, dv = flash_backward_dkv(q, k, v, key_valid, dout, lse, delta, **kw)
    return dq, dk, dv


def _launch(name, q, k, v, key_valid, tensors, *, causal, sm_scale, window,
            q_offset=0):
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_valid.data_ptr() if key_valid is not None else None,
            *(t.data_ptr() for t in tensors), B, H, Hkv, Tq, Tk, D,
            float(sm_scale), int(causal), int(window or 0), int(q_offset),
            _DTYPES[q.dtype], stream)
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg}")


def _check_kernel_args(q, k, v, key_valid, *grads) -> None:
    """Raise ValueError on anything the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid),
                    *((f"grad{i}", g) for i, g in enumerate(grads))):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "k", "v", "grad0") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernels copy rows by 16-byte cp.async)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernels take f32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernels take head_dim in {HEAD_DIMS}, got {D}")
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be ({B}, Tk, Hkv, {D}), got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if B * H > 65535:
        raise ValueError(f"kernels take B * H <= 65535, got {B * H}")
    if key_valid is not None and (key_valid.dtype != torch.bool
                                  or key_valid.shape != (B, Tk)):
        raise ValueError(f"key_valid must be bool ({B}, {Tk})")
    if grads:
        dout, lse, delta = grads
        if dout.shape != q.shape or dout.dtype != q.dtype:
            raise ValueError("dout must match q's shape and dtype")
        for name, t in (("lse", lse), ("delta", delta)):
            if t.dtype != torch.float32 or t.shape != (B, H, Tq):
                raise ValueError(f"{name} must be float32 ({B}, {H}, {Tq})")


def build() -> tuple[Path, str]:
    """Compile the kernel library (see :func:`.build.build_library`)."""
    return build_library(_SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 6 + [f32] + [i32] * 4 + [ptr]
    lib.flash_fwd_launch.argtypes = [ptr] * 6 + tail
    lib.flash_dq_launch.argtypes = [ptr] * 8 + tail
    lib.flash_dkv_launch.argtypes = [ptr] * 9 + tail
    for fn in (lib.flash_fwd_launch, lib.flash_dq_launch,
               lib.flash_dkv_launch):
        fn.restype = i32
    lib.flash_error_string.argtypes = [i32]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


# --- FLOP accounting --------------------------------------------------------
#
# ``torch.utils.flop_counter.FlopCounterMode`` counts the ATen products it
# sees; the kernels launch through ctypes, where it sees nothing, and the
# plain versions' einsums would count the kernels' recomputation.  While
# :func:`counting_flops` is on, :class:`_FlashAttention` calls the three
# kernels through custom ops instead, whose registered formulas count what
# the dense path's products count: the forward Q·Kᵀ and P·V, the dQ
# kernel dO·Vᵀ and dS·K, the dK/dV kernel Pᵀ·dO and dSᵀ·Q, each
# ``2·B·H·Tq·Tk·D`` (masked entries included, as a dense product counts
# them).

_COUNTING = [0]


@contextlib.contextmanager
def counting_flops():
    """Route the flash calls through the counted custom ops (see above)."""
    ops = _counted_ops()
    _COUNTING[0] += 1
    try:
        yield ops
    finally:
        _COUNTING[0] -= 1


def _products_flops(q_shape, k_shape, n: int = 2) -> int:
    B, Tq, H, D = q_shape
    return n * 2 * B * H * Tq * k_shape[1] * D


_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor? key_valid, bool causal, "
               "float sm_scale, int? window) -> (Tensor, Tensor)")
_BWD_ARGS = ("(Tensor q, Tensor k, Tensor v, Tensor? key_valid, Tensor dout, "
             "Tensor lse, Tensor delta, bool causal, float sm_scale, "
             "int? window)")


@functools.cache
def _counted_ops():
    """Define the custom ops and their FLOP formulas (once, at first
    use)."""
    from torch.utils.flop_counter import register_flop_formula

    def fwd(q, k, v, key_valid, causal, sm_scale, window):
        out, lse = flash_forward(q, k, v, key_valid, causal=causal,
                                 sm_scale=sm_scale, window=window)
        return out.clone(), lse.clone()

    def dq(q, k, v, key_valid, dout, lse, delta, causal, sm_scale, window):
        kw = dict(causal=causal, sm_scale=sm_scale, window=window)
        if q.device.type == "cpu":
            return _backward_plain(q, k, v, key_valid, dout, lse, delta,
                                   **kw)[0]
        return flash_backward_dq(q, k, v, key_valid, dout, lse, delta, **kw)

    def dkv(q, k, v, key_valid, dout, lse, delta, causal, sm_scale,
            window):
        kw = dict(causal=causal, sm_scale=sm_scale, window=window)
        if q.device.type == "cpu":
            return _backward_plain(q, k, v, key_valid, dout, lse, delta,
                                   **kw)[1:]
        return flash_backward_dkv(q, k, v, key_valid, dout, lse, delta,
                                  **kw)

    ops = []
    for name, fn, schema in (
            ("flash_fwd", fwd, _FWD_SCHEMA),
            ("flash_dq", dq, _BWD_ARGS + " -> Tensor"),
            ("flash_dkv", dkv, _BWD_ARGS + " -> (Tensor, Tensor)")):
        op = torch.library.custom_op(f"ddl_torch::{name}", fn,
                                     mutates_args=(), schema=schema)
        register_flop_formula(getattr(torch.ops.ddl_torch, name))(
            lambda q_shape, k_shape, *a, out_shape=None, **kw:
            _products_flops(q_shape, k_shape))
        ops.append(op)
    return tuple(ops)


# --- the autograd Function and the public entry -----------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, causal, sm_scale, window):
        if _COUNTING[0]:
            out, lse = _counted_ops()[0](q, k, v, key_valid, causal,
                                         sm_scale, window)
        else:
            out, lse = flash_forward(q, k, v, key_valid, causal=causal,
                                     sm_scale=sm_scale, window=window)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        if _COUNTING[0]:
            _, dq_op, dkv_op = _counted_ops()
            dout = dout.contiguous()
            args = (q, k, v, key_valid, dout, lse, _delta(out, dout),
                    ctx.opts["causal"], ctx.opts["sm_scale"],
                    ctx.opts["window"])
            dq = dq_op(*args)
            dk, dv = dkv_op(*args)
        else:
            dq, dk, dv = flash_backward(q, k, v, key_valid, out, lse, dout,
                                        **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, key_valid=None,
                    sm_scale: float | None = None, window: int | None = None):
    """Fused attention on ``(B, Tq, H, D)`` q with ``(B, Tk, Hkv, D)`` k/v,
    ``Hkv`` dividing H (GQA-native: k/v are never expanded).  ``key_valid``
    is an optional ``(B, Tk)`` bool padding mask (True = attend).  Returns
    ``(B, Tq, H, D)`` in q's dtype; differentiable in q, k and v."""
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads not a multiple of {Hkv} KV "
                         "heads (GQA groups must be uniform)")
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if key_valid is not None:
            key_valid = key_valid.contiguous()
    return _FlashAttention.apply(q, k, v, key_valid, bool(causal),
                                 float(sm_scale), window)


def make_attention_fn(causal: bool = False):
    """Flash attention as a model's ``attention`` callable (JAX's
    ``attention_pallas.make_attention_fn``): ``attn(q, k, v, *, mask=None,
    key_valid=None, causal=False, window=None, dtype=None)``, GQA K/V
    unexpanded; ``causal=True`` here forces it.  The JAX adapter answers a
    dense ``mask`` with dense attention; this one refuses it (the kernels
    never give way to another path)."""
    forced_causal = causal

    def attn(q, k, v, *, mask=None, key_valid=None, causal=False,
             window=None, dtype=None):
        if mask is not None:
            raise NotImplementedError(
                "the flash kernels take key_valid padding masks and "
                "causal=...; a dense (T, T) mask tensor is not supported")
        out = flash_attention(q, k, v, causal=causal or forced_causal,
                              key_valid=key_valid, window=window)
        return out.to(dtype or q.dtype)

    return attn
