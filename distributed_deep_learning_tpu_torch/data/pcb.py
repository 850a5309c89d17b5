"""PCB-defect bbox-crop dataset (reference ``CNN/dataset.py``): the port of
``distributed_deep_learning_tpu/data/pcb.py``.

Semantics reproduced (``CNN/dataset.py:32-111``):

* VOC-style tree: ``<root>/Annotations/<class>/*.xml`` bounding boxes paired
  with ``<root>/images/<class>/*.jpg``; one sample per (image, bbox);
* augmentation doubles the dataset: each bbox yields two virtual samples
  with independent random shifts ∈ [5, 10] applied to the crop origin
  (``:79, 91-96``);
* crop of the (shifted) bbox, padded with zeros where it leaves the image,
  resized to 64×64 bilinear (``:100``); one-hot class target.

Deliberate fixes over the reference (documented divergences):

* **Bbox coordinate order.** The reference's XML parser emits
  ``(xmin, xmax, ymin, ymax)`` (``CNN/dataset.py:38``) but the consumer
  unpacks ``(xmin, ymin, xmax, ymax)`` (``:94``) — so its "height" is
  ``ymin - xmax`` (often negative) and crops are scrambled.  We parse and
  consume ``(xmin, ymin, xmax, ymax)`` consistently.
* **Q7:** the empty-class error path referenced an undefined variable
  (``:66-67``); ours raises a well-formed error.
* XML via stdlib ``xml.etree`` (the reference used libxml2+XPath); output
  layout is NHWC float32.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from distributed_deep_learning_tpu_torch.data._threaded import ThreadedDecodeMixin

IMAGE_SIZE = 64


def bounding_boxes(path: str) -> list[tuple[int, int, int, int]]:
    """Parse ``/annotation/object/bndbox`` entries → (xmin, ymin, xmax, ymax)."""
    root = ET.parse(path).getroot()
    boxes = []
    for obj in root.findall("./object/bndbox"):
        vals = {k: int(float(obj.findtext(k))) for k in
                ("xmin", "ymin", "xmax", "ymax")}
        boxes.append((vals["xmin"], vals["ymin"], vals["xmax"], vals["ymax"]))
    return boxes


def find_classes(directory: str) -> tuple[list[str], dict[str, int]]:
    classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class directories under {directory}")
    return classes, {c: i for i, c in enumerate(classes)}


def make_dataset(image_root: str, annotation_root: str,
                 class_to_idx: dict[str, int]) -> list[tuple[str, tuple, int]]:
    """(image_path, bbox, class_index) per bounding box."""
    instances = []
    available = set()
    for target_class in sorted(class_to_idx):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(image_root, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root_dir, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                if not fname.endswith(".jpg"):
                    continue
                xml_path = os.path.join(annotation_root, target_class,
                                        os.path.splitext(fname)[0] + ".xml")
                for box in bounding_boxes(xml_path):
                    instances.append((os.path.join(root_dir, fname), box,
                                      class_index))
                    available.add(target_class)
    empty = set(class_to_idx) - available
    if empty:
        raise FileNotFoundError(
            f"found no valid .jpg files for classes: {', '.join(sorted(empty))}")
    return instances


class PCBDataset(ThreadedDecodeMixin):
    """ArrayDataset-API-compatible (``__len__``/``batch``) bbox-crop dataset."""

    def __init__(self, root: str = "/data/PCB_DATASET/", seed: int = 42,
                 image_size: int = IMAGE_SIZE, max_cached_images: int = 16,
                 workers: int | None = None):
        ann = os.path.join(root, "Annotations")
        if not os.path.isdir(ann):
            raise FileNotFoundError(
                f"{ann} not found — use data.datasets.synthetic_pcb for the "
                "shape-compatible synthetic twin")
        self.classes, self.class_to_idx = find_classes(ann)
        self.samples = make_dataset(os.path.join(root, "images"), ann,
                                    self.class_to_idx)
        self.image_size = image_size
        # augmentation doubling: one independent shift per VIRTUAL sample
        rng = np.random.default_rng(seed)
        self.shift = rng.integers(5, 11, size=len(self.samples) * 2)
        # Bounded LRU over decoded full-res images (PCB photos are ~14 MB
        # decoded; an unbounded cache would hold the whole corpus) plus
        # threaded batch decode (:class:`.._threaded.ThreadedDecodeMixin`):
        # a real epoch is JPEG-decode-bound, so the threads (-w) spread
        # the decodes over the host's cores.
        self._init_decode(min(8, os.cpu_count() or 1) if workers is None
                          else workers, max_cached_images)

    def __len__(self) -> int:
        return len(self.samples) * 2          # reference __len__ = 2·samples

    @staticmethod
    def _decode(path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def _load_image(self, path: str) -> np.ndarray:
        return self._cached(path, self._decode)

    def _crop_resize(self, img: np.ndarray, top: int, left: int,
                     height: int, width: int) -> np.ndarray:
        """Zero-padded crop then bilinear resize (reference ``resized_crop``
        semantics); the resize runs in the native C++ library
        (:func:`..native.crop_resize_bilinear`, align_corners=False) rather
        than PIL — same convention as torchvision's functional resize."""
        from distributed_deep_learning_tpu_torch import native

        h, w = img.shape[:2]
        height, width = max(height, 1), max(width, 1)
        out = np.zeros((height, width, 3), dtype=np.float32)
        y0, y1 = max(top, 0), min(top + height, h)
        x0, x1 = max(left, 0), min(left + width, w)
        if y1 > y0 and x1 > x0:
            out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
        return native.crop_resize_bilinear(out, 0, 0, height, width,
                                           self.image_size, self.image_size)

    def item(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        path, (xmin, ymin, xmax, ymax), target = self.samples[index >> 1]
        shift = int(self.shift[index])
        top, left = ymin + shift, xmin + shift
        height, width = ymax - ymin, xmax - xmin
        x = self._crop_resize(self._load_image(path), top, left, height, width)
        y = np.zeros(len(self.classes), dtype=np.float32)
        y[target] = 1.0
        return x, y

    # batch() comes from ThreadedDecodeMixin (threaded item decode)
