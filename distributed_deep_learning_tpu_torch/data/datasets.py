"""In-memory array datasets and the synthetic twins of the workloads'
datasets: the port of the parts of
``distributed_deep_learning_tpu/data/datasets.py`` the ported workloads
use.  Datasets are NumPy on the host; :mod:`.loader` batches them and
copies each batch to the device once.  Each twin draws the same arrays
as the JAX package's from the same seed, images NHWC as there: those of
the reference's workloads and of the north-star zoo (CIFAR-10 and
ImageNet images, WMT pairs, C4 MLM rows).
"""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """(features, targets) arrays with uniform leading dimension."""

    def __init__(self, features: np.ndarray, targets: np.ndarray):
        if len(features) != len(targets):
            raise ValueError(f"length mismatch {len(features)} vs {len(targets)}")
        self.features = features
        self.targets = targets

    def __len__(self) -> int:
        return len(self.features)

    def batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Gather one batched (x, y) pair — the only hot-path data op —
        through the native row gather (:mod:`..native`), NumPy fancy
        indexing without it."""
        from distributed_deep_learning_tpu_torch import native

        indices = np.asarray(indices)
        return native.take(self.features, indices), \
            native.take(self.targets, indices)


def synthetic_mqtt(n: int = 4096, num_features: int = 48, num_classes: int = 5,
                   seed: int = 0) -> ArrayDataset:
    """MQTT-IDS shape twin: float feature rows + one-hot 5-class targets,
    with a planted linear signal so training visibly learns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, num_features)).astype(np.float32)
    w = rng.normal(size=(num_features, num_classes))
    labels = np.argmax(x @ w + 0.1 * rng.normal(size=(n, num_classes)), axis=-1)
    y = np.eye(num_classes, dtype=np.float32)[labels]
    return ArrayDataset(x, y)


def synthetic_pcb(n: int = 512, image_size: int = 64, num_classes: int = 6,
                  seed: int = 0) -> ArrayDataset:
    """PCB-defect shape twin: 64×64 RGB crops (NHWC) + one-hot targets,
    with a class-dependent mean so accuracy can rise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    x = rng.normal(size=(n, image_size, image_size, 3)).astype(np.float32)
    x += labels[:, None, None, None].astype(np.float32) * 0.1
    y = np.eye(num_classes, dtype=np.float32)[labels]
    return ArrayDataset(x, y)


def synthetic_pdm(n: int = 4096, history: int = 10, num_features: int = 32,
                  num_targets: int = 5, seed: int = 0) -> ArrayDataset:
    """Predictive-maintenance shape twin: windows of ``history`` timesteps
    × 32 features and a 5-wide regression target (L1-trained, quirk Q5)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, history, num_features)).astype(np.float32)
    w = rng.normal(size=(num_features, num_targets)) / np.sqrt(num_features)
    y = (x.mean(axis=1) @ w).astype(np.float32)
    return ArrayDataset(x, y)


def synthetic_mnist(n: int = 2048, seed: int = 0) -> ArrayDataset:
    """28×28×1 digits (NHWC), one-hot 10-class targets."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    x += labels[:, None, None, None].astype(np.float32) * 0.1
    return ArrayDataset(x, np.eye(10, dtype=np.float32)[labels])


def synthetic_cifar10(n: int = 2048, seed: int = 0) -> ArrayDataset:
    """32×32×3 images (NHWC), one-hot 10-class targets (the ``resnet``
    workload's default data)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    x += labels[:, None, None, None].astype(np.float32) * 0.1
    return ArrayDataset(x, np.eye(10, dtype=np.float32)[labels])


def synthetic_imagenet(n: int = 64, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0) -> ArrayDataset:
    """224×224×3 images (NHWC), one-hot 1000-class targets, with a
    class-dependent mean shift.  Default ``n`` is small: one sample is
    600 KB."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    x = rng.normal(size=(n, image_size, image_size, 3)).astype(np.float32)
    x += (labels[:, None, None, None].astype(np.float32) / num_classes) * 2.0
    return ArrayDataset(x, np.eye(num_classes, dtype=np.float32)[labels])


def synthetic_wmt(n: int = 1024, src_len: int = 32, tgt_len: int = 32,
                  vocab_size: int = 32000, seed: int = 0) -> ArrayDataset:
    """Token-id pairs shaped like a bucketed WMT batch: ``features`` are
    source ids, ``targets`` target ids, drawn from [1, vocab) with a
    ragged tail of pad id 0 in each row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, vocab_size, size=(n, src_len))
    tgt = rng.integers(1, vocab_size, size=(n, tgt_len))
    for row, (ls, lt) in enumerate(zip(
            rng.integers(src_len // 2, src_len + 1, size=n),
            rng.integers(tgt_len // 2, tgt_len + 1, size=n))):
        src[row, ls:] = 0
        tgt[row, lt:] = 0
    return ArrayDataset(src.astype(np.int32), tgt.astype(np.int32))


def synthetic_c4_mlm(n: int = 1024, seq_len: int = 64,
                     vocab_size: int = 30522, mask_id: int = 103,
                     mask_rate: float = 0.15, seed: int = 0) -> ArrayDataset:
    """BERT MLM twin: ``features`` are token ids with ``mask_rate`` of the
    positions replaced by ``mask_id``, ``targets`` the original ids (the
    loss sites are wherever features == mask_id)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab_size, size=(n, seq_len)).astype(np.int32)
    masked = tokens.copy()
    masked[rng.random(size=tokens.shape) < mask_rate] = mask_id
    return ArrayDataset(masked, tokens)


def synthetic_lm(n: int = 1024, seq_len: int = 64, vocab_size: int = 1024,
                 seed: int = 0) -> ArrayDataset:
    """Causal-LM twin: rows follow a cyclic +1 token rule from a random
    start (x[t+1] = x[t] + 1 over [1, vocab)), so next-token accuracy
    climbs within an epoch.  Features = rows[:, :-1], targets =
    rows[:, 1:]."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, vocab_size, size=(n, 1))
    ramp = np.arange(seq_len + 1)[None, :]
    rows = ((start - 1 + ramp) % (vocab_size - 1) + 1).astype(np.int32)
    return ArrayDataset(np.ascontiguousarray(rows[:, :-1]),
                        np.ascontiguousarray(rows[:, 1:]))
