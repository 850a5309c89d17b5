"""ctypes bindings for the host-data library, with NumPy fallbacks: the
port of ``distributed_deep_learning_tpu/native/__init__.py``.

``g++`` compiles ``ddl_native.cpp`` at first use into
``build/torch_native/`` at the repository root, named by a hash of the
source and the flags, so a changed source rebuilds and the JAX package's
library is never built or loaded here.  Every binding has a NumPy fallback
with identical semantics, taken when the build is impossible or
``DDL_DISABLE_NATIVE=1``; the tests run both paths against each other.
This is host code: the data it prepares is copied to the card by
:mod:`..data.loader`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ddl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libddl_native_{digest}.so"


def _build(lib: Path) -> bool:
    """Compile to a private temporary name and rename it into place, so
    processes building at once never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, building it if necessary; None: use the
    fallbacks."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DDL_DISABLE_NATIVE") == "1":
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.ddl_gather_rows.argtypes = [_f32p, _i64, _i64p, _i64, _f32p]
        lib.ddl_gather_rows.restype = None
        lib.ddl_window_gather.argtypes = [_f32p, _i64, _i64p, _i64, _i64,
                                          _f32p]
        lib.ddl_window_gather.restype = None
        lib.ddl_csv_dims.argtypes = [ctypes.c_char_p, _i32,
                                     ctypes.POINTER(_i64),
                                     ctypes.POINTER(_i64)]
        lib.ddl_csv_dims.restype = _i64
        lib.ddl_csv_parse.argtypes = [ctypes.c_char_p, _i32, _i32, _f32p,
                                      _i64, _i64]
        lib.ddl_csv_parse.restype = _i64
        lib.ddl_crop_resize_bilinear.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _f32p]
        lib.ddl_crop_resize_bilinear.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Bindings (native fast path + NumPy fallback, identical semantics)
# ---------------------------------------------------------------------------

def gather_rows(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``data[idx]`` for 2D float32 `data` — the loader's hot op."""
    lib = get_lib()
    if lib is None or data.dtype != np.float32 or data.ndim != 2 \
            or not data.flags.c_contiguous:
        return data[idx]
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(idx), data.shape[1]), np.float32)
    lib.ddl_gather_rows(data, data.shape[1], idx, len(idx), out)
    return out


def take(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``arr[idx]`` along axis 0 for ND arrays (images etc.): trailing dims
    are flattened into the native 2D row gather, then restored."""
    if arr.ndim == 2:
        return gather_rows(arr, idx)
    if arr.ndim < 2 or arr.dtype != np.float32 or not arr.flags.c_contiguous:
        return arr[idx]
    flat = arr.reshape(arr.shape[0], -1)
    return gather_rows(flat, idx).reshape((len(idx),) + arr.shape[1:])


def window_gather(data: np.ndarray, pos: np.ndarray, history: int
                  ) -> np.ndarray:
    """Windows ending at ``pos`` (inclusive): (B, history, d)."""
    lib = get_lib()
    if lib is None or data.dtype != np.float32 or data.ndim != 2 \
            or not data.flags.c_contiguous:
        offsets = np.arange(-(history - 1), 1)
        return data[np.asarray(pos)[:, None] + offsets]
    pos = np.ascontiguousarray(pos, np.int64)
    out = np.empty((len(pos), history, data.shape[1]), np.float32)
    lib.ddl_window_gather(data, data.shape[1], pos, len(pos), history, out)
    return out


def read_csv(path: str, *, skip_header: bool = True,
             drop_first_col: bool = False) -> np.ndarray:
    """Float CSV → (rows, cols) float32 array (pandas-free fast path)."""
    lib = get_lib()
    if lib is None:
        data = np.genfromtxt(path, delimiter=",",
                             skip_header=1 if skip_header else 0,
                             dtype=np.float32)
        data = np.atleast_2d(data)
        if drop_first_col:
            data = data[:, 1:]
        return np.ascontiguousarray(np.nan_to_num(data, nan=0.0))
    rows, cols = _i64(), _i64()
    rc = lib.ddl_csv_dims(os.fsencode(path), 1 if skip_header else 0,
                          ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise FileNotFoundError(f"cannot read CSV {path!r} (rc={rc})")
    keep = cols.value - (1 if drop_first_col else 0)
    out = np.empty((rows.value, keep), np.float32)
    n = lib.ddl_csv_parse(os.fsencode(path), 1 if skip_header else 0,
                          1 if drop_first_col else 0, out, rows.value,
                          cols.value)
    return out[:n]


def crop_resize_bilinear(img: np.ndarray, top: int, left: int, h: int,
                         w: int, out_h: int, out_w: int) -> np.ndarray:
    """torchvision ``resized_crop`` semantics on an (H, W, C) float32 image
    (align_corners=False bilinear)."""
    lib = get_lib()
    if lib is None or img.dtype != np.float32 or not img.flags.c_contiguous:
        return _crop_resize_numpy(np.asarray(img, np.float32), top, left, h,
                                  w, out_h, out_w)
    H, W, C = img.shape
    out = np.empty((out_h, out_w, C), np.float32)
    lib.ddl_crop_resize_bilinear(img, H, W, C, top, left, h, w, out_h,
                                 out_w, out)
    return out


def _crop_resize_numpy(img, top, left, h, w, out_h, out_w):
    fy = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    crop = img[top:top + h, left:left + w]
    v0 = crop[y0][:, x0] * (1 - wx) + crop[y0][:, x1] * wx
    v1 = crop[y1][:, x0] * (1 - wx) + crop[y1][:, x1] * wx
    return (v0 * (1 - wy) + v1 * wy).astype(np.float32)
