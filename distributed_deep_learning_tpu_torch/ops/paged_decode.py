"""Paged flash decode: one query per slot attends straight off the block pools.

The CUDA kernel (``csrc/paged_decode.cu``) replaces the TPU kernel
``distributed_deep_learning_tpu/ops/paged_decode_pallas.py::_decode_kernel``.
Each slot's query reads the physical blocks its block table names, masks
positions at or past ``seq_lens[b]`` (and, when given, positions the
``valid_pool`` marks as padding), and keeps an online softmax in f32, so
no slot's logical cache is gathered into a copy.  The source explains the
design and what bounds it on the card.

:func:`paged_flash_decode` is the wrapper: CPU tensors go to
:func:`paged_decode_reference`, the plain version with the same
semantics (gather, dequantize, mask, one f32 softmax); CUDA tensors
launch the kernel or raise.  ``paged_flash_decode.launches`` counts the
wrapper's calls that launched it.  The kernel splits each slot's positions
over :func:`decode_splits` blocks (split-K); a call makes two CUDA
launches: the splits, into an f32 workspace allocated here, then their
combine.

The kernel is compiled at first use with ``nvcc`` into
``build/torch_kernels/`` at the repository root (one shared library with a
plain C interface, loaded with ``ctypes``), keyed by a hash of the source
and flags, so a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from distributed_deep_learning_tpu_torch.ops.build import (  # noqa: F401
    BUILD_DIR, CSRC, NVCC_FLAGS, build_library)

NEG_INF = -1e30

_SOURCE = CSRC / "paged_decode.cu"

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
#: split-K: the blocks per SM the split count aims for, and the positions
#: a block's run is a multiple of (one step of its 8 warps x 4 positions)
WAVES = 8
RUN_STEP = 32


def decode_splits(B: int, Hkv: int, Bps: int, bs: int,
                  sms: int) -> tuple[int, int]:
    """``(splits, per)``: each slot's ``Bps`` logical blocks cut into
    ``splits`` runs of ``per`` blocks (the last may be shorter), from the
    shapes alone, never from ``seq_lens``, so a decode tick does not wait
    on the card.  Aims at ``WAVES`` blocks per SM over the ``B * Hkv``
    (slot, kv head) pairs; a run is a multiple of ``RUN_STEP`` positions
    where ``bs`` divides it."""
    want = max(1, -(-WAVES * sms // (B * Hkv)))
    step = max(1, RUN_STEP // bs)
    per = min(Bps, -(-max(1, -(-Bps // want)) // step) * step)
    return -(-Bps // per), per


def paged_decode_reference(q, k_pool, v_pool, block_tables, seq_lens, *,
                           k_scale=None, v_scale=None, valid_pool=None,
                           sm_scale: float | None = None):
    """Gather each slot's logical KV (``pool[table]``), dequantize, mask
    positions ``>= seq_lens`` (and invalid ones when ``valid_pool`` is
    given), one dense f32 softmax.  ``q`` is ``(B, Hkv, G, D)``, pools
    ``(N, bs, Hkv, D)`` (int8 with ``(N, bs, Hkv, 1)`` f32 scales),
    ``block_tables`` ``(B, Bps)``, ``seq_lens`` ``(B,)``, ``valid_pool``
    ``(N, bs)`` bool.  Returns ``(B, Hkv, G, D)`` in ``q``'s dtype."""
    B, Hkv, G, D = q.shape
    bs = k_pool.shape[1]
    Bps = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    tables = block_tables.long()

    def logical(pool, scale):
        got = pool[tables].reshape(B, Bps * bs, Hkv, D)
        if scale is not None:
            got = got.float() * scale[tables].reshape(B, Bps * bs, Hkv, 1)
        return got.float()

    k = logical(k_pool, k_scale)
    v = logical(v_pool, v_scale)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k) * sm_scale
    live = (torch.arange(Bps * bs, device=q.device)[None, :]
            < seq_lens.long()[:, None])
    if valid_pool is not None:
        live = live & valid_pool[tables].reshape(B, Bps * bs)
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bthd->bhgd", p, v).to(q.dtype)


def paged_flash_decode(q, k_pool, v_pool, block_tables, seq_lens, *,
                       k_scale=None, v_scale=None, valid_pool=None,
                       sm_scale: float | None = None):
    """Decode attention straight off the paged pools (arguments as in
    :func:`paged_decode_reference`).  On CPU tensors this is the plain
    version; on CUDA tensors it launches the kernel on the current stream
    and raises on anything the kernel does not take."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k and v pools must agree on quantization")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_decode_reference(
            q, k_pool, v_pool, block_tables, seq_lens, k_scale=k_scale,
            v_scale=v_scale, valid_pool=valid_pool, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cpu or cuda tensors, "
                         f"got {q.device}")
    _check_kernel_args(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                       v_scale, valid_pool)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    B, Hkv, G, D = q.shape
    N, bs = k_pool.shape[:2]
    Bps = block_tables.shape[1]
    splits, per = decode_splits(B, Hkv, Bps, bs, sm_count(q.device))
    # per (slot, head, split): acc (G, D), then (m, l) per query head
    part = torch.empty(B * Hkv * splits * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            valid_pool.data_ptr() if valid_pool is not None else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(),
            B, Hkv, G, D, N, bs, Bps, splits, per, float(sm_scale),
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if rc != 0:
        msg = lib.paged_decode_error_string(rc).decode()
        raise RuntimeError(f"paged_decode kernel launch failed: {msg}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def _check_kernel_args(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                       v_scale, valid_pool) -> None:
    """Raise ValueError on anything the kernel does not take."""
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "block_tables": block_tables, "seq_lens": seq_lens,
             "k_scale": k_scale, "v_scale": v_scale,
             "valid_pool": valid_pool}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hkv, G, D), got {tuple(q.shape)}")
    B, Hkv, G, D = q.shape
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported by the kernel")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         "supported by the kernel")
    if D not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and group "
                         f"1..{MAX_GROUP}, got D={D} G={G}")
    if k_pool.dim() != 4 or k_pool.shape[2:] != (Hkv, D) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be (N, bs, {Hkv}, {D}), got "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    N, bs = k_pool.shape[:2]
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 ({B}, Bps)")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be int32 ({B},)")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("int8 pools need scales, and only int8 pools "
                         "take them")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s is not None and (s.dtype != torch.float32
                              or s.shape != (N, bs, Hkv, 1)):
            raise ValueError(f"{name} must be float32 ({N}, {bs}, {Hkv}, 1)")
    if valid_pool is not None and (valid_pool.dtype != torch.bool
                                   or valid_pool.shape != (N, bs)):
        raise ValueError(f"valid_pool must be bool ({N}, {bs})")


@functools.cache
def sm_count(device) -> int:
    """The card's SM count (a property query, no sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def build() -> tuple[Path, str]:
    """Compile the kernel library (see :func:`.build.build_library`)."""
    return build_library(_SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_launch.argtypes = (
        [ptr] * 10 + [i32] * 9 + [ctypes.c_float] + [i32] * 2 + [ptr])
    lib.paged_decode_launch.restype = i32
    lib.paged_decode_error_string.argtypes = [i32]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib
