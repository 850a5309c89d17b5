"""Packed pre-decoded sample cache, memory-mapped: the port of
``distributed_deep_learning_tpu/data/packed.py``, writing and reading the
same artifact byte for byte, so a cache packed by either package trains
in the other (``--packed-cache``).

Decoding an image costs the same every epoch, so a packing pass does it
once: :func:`pack_dataset` walks any dataset with ``__len__``/``batch``
(images, tabular windows, token rows) through its own decode path and
writes one flat file; :class:`PackedDataset` memory-maps it and gathers a
batch with one fancy-index slab read per array.

Artifact layout (little-endian, version 1)::

    [0:8)    magic  b"DDLPACK" + version byte
    [8:16)   uint64 header length H
    [16:16+H) JSON header: shapes, dtypes, block offsets, source metadata
    features @ features_offset   (num_samples, *feature_shape) C-order
    targets  @ targets_offset    (num_samples, *target_shape)  C-order
    index    @ index_offset      int64 (num_samples,) per-sample byte
                                 offsets into the features block

Blocks start on 64-byte boundaries.  Floats that are exactly
uint8-representable (decoded images at their native size) may be stored
as ``uint8`` and are converted back on read, bit-identical either way.
The header carries the source's ``classes`` and ``vocab_size`` when it
has them, which the workloads size their models from.  A truncated,
foreign or other-version file raises :class:`PackedFormatError`.

The reader is a plain ``ArrayDataset``, so the seeded epoch permutation
and the splits apply unchanged: packed and eager runs of the same seed
see the same batches in the same order, bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np

from distributed_deep_learning_tpu_torch.data.datasets import \
    ArrayDataset

MAGIC = b"DDLPACK"
VERSION = 1
#: conventional artifact extension (any path works)
PACKED_EXTENSION = ".ddlpack"
_ALIGN = 64  # block alignment: slab reads start on a cache-line boundary


class PackedFormatError(ValueError):
    """The file is not a (complete, current-version) packed cache."""


def _align(offset: int) -> int:
    return (offset + _ALIGN - 1) // _ALIGN * _ALIGN


def _uint8_exact(arr: np.ndarray) -> bool:
    """True when ``arr`` round-trips through uint8 bit-exactly."""
    if arr.dtype == np.uint8:
        return True
    if not np.issubdtype(arr.dtype, np.floating):
        return False
    return bool(np.all((arr >= 0) & (arr <= 255) &
                       (arr == np.trunc(arr))))


def pack_dataset(dataset, path: str | os.PathLike, *,
                 dtype: str = "auto", chunk_size: int = 256,
                 indices: np.ndarray | None = None,
                 meta: dict | None = None) -> dict:
    """Pack ``dataset`` (anything with ``__len__``/``batch``) into ``path``.

    ``dtype`` controls the feature block: ``"auto"`` stores uint8 when the
    probe chunk is exactly uint8-representable (decoded images), source
    dtype otherwise; ``"uint8"`` forces it (and errors on any sample that
    would be quantised — lossy packing must be impossible to do by
    accident); ``"source"`` always keeps the source dtype.  ``indices``
    packs a subset (e.g. one split) in the given order.  Writes are
    atomic (tmp file + rename): a crash mid-pack leaves no artifact.

    Returns the header dict of the written artifact.
    """
    if dtype not in ("auto", "uint8", "source"):
        raise ValueError(f"dtype must be auto|uint8|source, got {dtype!r}")
    idx = np.arange(len(dataset), dtype=np.int64) if indices is None \
        else np.asarray(indices, np.int64)
    n = len(idx)
    if n == 0:
        raise ValueError("refusing to pack an empty dataset")
    chunk_size = max(1, int(chunk_size))

    x0, y0 = dataset.batch(idx[:min(chunk_size, n)])
    x0, y0 = np.asarray(x0), np.asarray(y0)
    store_u8 = (dtype == "uint8") or (dtype == "auto" and _uint8_exact(x0))
    f_store = np.dtype(np.uint8) if store_u8 else x0.dtype
    f_out = x0.dtype  # what batch() must yield back (bit-identity contract)

    f_stride = int(np.prod(x0.shape[1:], dtype=np.int64)) * f_store.itemsize
    t_stride = int(np.prod(y0.shape[1:], dtype=np.int64)) * y0.dtype.itemsize
    header = {
        "version": VERSION,
        "num_samples": n,
        "feature_shape": [int(d) for d in x0.shape[1:]],
        "feature_dtype": f_store.name,
        "feature_out_dtype": f_out.name,
        "target_shape": [int(d) for d in y0.shape[1:]],
        "target_dtype": y0.dtype.name,
        "meta": dict(meta or {}),
    }
    # source metadata the workloads key model geometry off
    classes = getattr(dataset, "classes", None)
    if classes is not None:
        header["classes"] = [str(c) for c in classes]
    vocab = getattr(dataset, "vocab_size", None)
    if vocab is not None:
        header["vocab_size"] = int(vocab)

    # block offsets depend on the header's own JSON length (offset digit
    # counts feed back into it) — iterate to the fixed point, which exists
    # because lengths only ever grow and alignment absorbs small changes
    header.update(features_offset=0, targets_offset=0, index_offset=0,
                  total_bytes=0)
    for _ in range(8):
        hdr = json.dumps(header).encode()
        f_off = _align(16 + len(hdr))
        t_off = _align(f_off + n * f_stride)
        i_off = _align(t_off + n * t_stride)
        total = i_off + n * 8
        if (header["features_offset"], header["targets_offset"],
                header["index_offset"], header["total_bytes"]) == \
                (f_off, t_off, i_off, total):
            break
        header.update(features_offset=f_off, targets_offset=t_off,
                      index_offset=i_off, total_bytes=total)
    else:  # pragma: no cover - lengths are monotone, cannot happen
        raise AssertionError("packed header layout did not converge")

    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"

    def write_chunk(f, start: int, x: np.ndarray, y: np.ndarray) -> None:
        if store_u8 and x.dtype != np.uint8:
            if not _uint8_exact(x):
                raise ValueError(
                    "samples are not exactly uint8-representable; pack "
                    "with dtype='source' (or fix the decode path) — "
                    "silent quantisation would break packed/eager parity")
            x = x.astype(np.uint8)
        f.seek(f_off + start * f_stride)
        f.write(np.ascontiguousarray(x).tobytes())
        f.seek(t_off + start * t_stride)
        f.write(np.ascontiguousarray(y).tobytes())

    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC + bytes([VERSION]))
            f.write(np.uint64(len(hdr)).tobytes())
            f.write(hdr)
            write_chunk(f, 0, x0, y0)
            for start in range(len(x0), n, chunk_size):
                x, y = dataset.batch(idx[start:start + chunk_size])
                x, y = np.asarray(x), np.asarray(y)
                if x.shape[1:] != x0.shape[1:] or y.shape[1:] != y0.shape[1:]:
                    raise ValueError(
                        f"ragged samples at {start}: {x.shape[1:]} vs "
                        f"{x0.shape[1:]} — version-1 packs fixed shapes")
                write_chunk(f, start, x, y)
            f.seek(i_off)
            f.write((np.arange(n, dtype=np.int64) * f_stride).tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers never see a partial pack
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return header


def read_header(path: str | os.PathLike) -> dict:
    """Validated header of a packed cache (magic, version, completeness)."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(16)
        if len(head) < 16 or head[:7] != MAGIC:
            raise PackedFormatError(f"{path}: not a packed sample cache "
                                    f"(bad magic)")
        version = head[7]
        if version != VERSION:
            raise PackedFormatError(
                f"{path}: packed-cache version {version} != supported "
                f"{VERSION}; re-pack it with this build's pack_dataset")
        hlen = int(np.frombuffer(head[8:16], np.uint64)[0])
        raw = f.read(hlen)
    if len(raw) < hlen:
        raise PackedFormatError(f"{path}: truncated header")
    try:
        header = json.loads(raw)
    except json.JSONDecodeError as exc:
        raise PackedFormatError(f"{path}: corrupt header ({exc})") from None
    if size != header.get("total_bytes"):
        raise PackedFormatError(
            f"{path}: {size} bytes on disk vs {header.get('total_bytes')} "
            "declared — truncated or partially-written cache (re-pack)")
    return header


class PackedDataset(ArrayDataset):
    """Memory-mapped reader over a :func:`pack_dataset` artifact.

    ``features``/``targets`` are live memmaps (no load-time copy; the OS
    page cache holds only what batches touch), and ``batch()`` is one
    fancy-index slab gather per array — the same ``native.take`` hot path
    every ArrayDataset uses, reading straight out of the mapping.  uint8-
    stored features convert back to their source dtype on the way out, so
    packed batches are bit-identical to the eager decode path's.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.header = h = read_header(self.path)
        n = int(h["num_samples"])
        feats = np.memmap(self.path, dtype=np.dtype(h["feature_dtype"]),
                          mode="r", offset=int(h["features_offset"]),
                          shape=(n, *map(int, h["feature_shape"])))
        tgts = np.memmap(self.path, dtype=np.dtype(h["target_dtype"]),
                         mode="r", offset=int(h["targets_offset"]),
                         shape=(n, *map(int, h["target_shape"])))
        self.index = np.memmap(self.path, dtype=np.int64, mode="r",
                               offset=int(h["index_offset"]), shape=(n,))
        stride = feats[0].nbytes
        if n and (int(self.index[0]) != 0
                  or int(self.index[-1]) != (n - 1) * stride):
            raise PackedFormatError(f"{self.path}: sample index disagrees "
                                    "with the feature block layout")
        self._out_dtype = np.dtype(h.get("feature_out_dtype",
                                         h["feature_dtype"]))
        if "classes" in h:
            self.classes = list(h["classes"])
            self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        if "vocab_size" in h:
            self.vocab_size = int(h["vocab_size"])
        super().__init__(feats, tgts)

    def batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        x, y = super().batch(indices)
        if x.dtype != self._out_dtype:
            x = x.astype(self._out_dtype)
        return x, y

    @property
    def nbytes(self) -> int:
        return int(self.header["total_bytes"])
