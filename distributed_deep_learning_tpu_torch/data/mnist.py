"""Real-file MNIST loader — BASELINE configs[0] ("MNIST CNN, single-process
CPU") on actual data when it is present: the port of
``distributed_deep_learning_tpu/data/mnist.py``.

Accepts either layout under ``root``:

* the canonical idx-ubyte files (``train-images-idx3-ubyte[.gz]`` +
  ``train-labels-idx1-ubyte[.gz]``, the torchvision raw format), or
* a NumPy pair (``images.npy`` (N, 28, 28[, 1]) + ``labels.npy`` (N,)).

Images normalise to float32 in [0, 1] with a trailing channel dim (NHWC);
labels one-hot to 10 classes — the ``ArrayDataset`` contract every loader
downstream expects.  The reference always loads real files
(``CNN/dataset.py:71-111``); the synthetic twin (``synthetic_mnist``) is
only the fallback when no files exist.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from distributed_deep_learning_tpu_torch.data.datasets import ArrayDataset

IDX_IMAGES = ("train-images-idx3-ubyte", "train-images.idx3-ubyte")
IDX_LABELS = ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte")


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(root: str, names: tuple[str, ...]) -> str | None:
    for name in names:
        for cand in (name, name + ".gz"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return p
    return None


def read_idx(path: str) -> np.ndarray:
    """Parse an idx-ubyte file (big-endian magic + dims + uint8 payload)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if (magic >> 8) != 0x08:  # 0x08 = unsigned byte payload
            raise ValueError(f"{path}: unsupported idx dtype "
                             f"0x{magic >> 8:x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist(root: str) -> ArrayDataset:
    """(images, one-hot labels) from idx-ubyte or .npy files under root."""
    root = os.fspath(root)
    npy_img = os.path.join(root, "images.npy")
    if os.path.exists(npy_img):
        images = np.load(npy_img)
        labels = np.load(os.path.join(root, "labels.npy"))
    else:
        img_path = _find(root, IDX_IMAGES)
        lbl_path = _find(root, IDX_LABELS)
        if img_path is None or lbl_path is None:
            raise FileNotFoundError(
                f"no MNIST files under {root!r} (expected idx-ubyte or "
                "images.npy/labels.npy)")
        images = read_idx(img_path)
        labels = read_idx(lbl_path)
    if images.ndim == 3:
        images = images[..., None]  # NHWC
    x = np.ascontiguousarray(images, np.float32)
    if x.max() > 1.0:
        x /= 255.0
    y = np.eye(10, dtype=np.float32)[np.asarray(labels, np.int64)]
    return ArrayDataset(x, y)
