"""Directory-per-class image dataset (ImageFolder semantics): the port of
``distributed_deep_learning_tpu/data/imagefolder.py``.

``root/<class>/<image>``, classes found as torchvision's ``ImageFolder``
finds them (sorted names → indices).  Images decode through PIL (imported
where an image is opened, so building the ``resnet`` workload on a card
without Pillow never needs it), resize through the host-data library's
bilinear kernel (:func:`..native.crop_resize_bilinear`) to
``image_size`` square, and decode in ``num_workers`` threads
(:class:`._threaded.ThreadedDecodeMixin`, the CLI's ``-w``).  Batches are
NHWC float32 with one-hot targets, the :class:`.datasets.ArrayDataset`
contract the loader takes.
"""

from __future__ import annotations

import os

import numpy as np

from distributed_deep_learning_tpu_torch.data._threaded import \
    ThreadedDecodeMixin

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def find_classes(root: str) -> tuple[list[str], dict[str, int]]:
    """Sorted class subdirectories → contiguous indices."""
    classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    return classes, {c: i for i, c in enumerate(classes)}


class ImageFolderDataset(ThreadedDecodeMixin):
    """``root/<class>/*.jpg`` → (image, one-hot) batches."""

    def __init__(self, root: str, image_size: int = 224, *,
                 num_workers: int = 8, max_cached_images: int = 1024):
        self.root = os.fspath(root)
        self.image_size = image_size
        self.classes, self.class_to_idx = find_classes(self.root)
        self.samples: list[tuple[str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(self.root, cls)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for name in sorted(files):
                    if name.lower().endswith(IMAGE_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, name),
                                             self.class_to_idx[cls]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")
        self._init_decode(num_workers, max_cached_images)

    def __len__(self) -> int:
        return len(self.samples)

    def _decode_resized(self, path: str) -> np.ndarray:
        from PIL import Image

        from distributed_deep_learning_tpu_torch import native

        with Image.open(path) as im:
            raw = np.asarray(im.convert("RGB"), dtype=np.float32)
        h, w = raw.shape[:2]
        return native.crop_resize_bilinear(np.ascontiguousarray(raw), 0, 0,
                                           h, w, self.image_size,
                                           self.image_size)

    def item(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        path, target = self.samples[index]
        y = np.zeros(len(self.classes), dtype=np.float32)
        y[target] = 1.0
        return self._cached(path, self._decode_resized), y
