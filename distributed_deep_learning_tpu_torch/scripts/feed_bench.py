"""Feed-rate microbenchmark: the counterpart of ``scripts/feed_bench.py``.
Can the host form batches as fast as a train step consumes them?

Times HOST batch formation only (``DeviceLoader.iter_host_batches``: no
device transfer, no train step) three ways on the same image tree:

* **eager**: :class:`..data.imagefolder.ImageFolderDataset` with a cold
  LRU, PIL decode and resize on the measured path (the per-epoch cost the
  reference pays);
* **packed**: the same samples through a :mod:`..data.packed` memory-mapped
  cache, one fancy-index gather per batch;
* **pack**: the one-off packing cost, paid once for every epoch.

    python -m distributed_deep_learning_tpu_torch.scripts.feed_bench \
        [--data-dir TREE] [--image-size 64] [--batch 64] [--epochs 3]

Prints one JSON line: eager/packed images per second, the speedup, the
pack cost.  Without ``--data-dir`` a synthetic JPEG tree is generated (6
classes, the JAX script's fixture).  Host code only: nothing touches the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def make_jpeg_tree(root: str, *, classes: int = 6, per_class: int = 24,
                   size: int = 72, seed: int = 4) -> None:
    """The bench.py input-pipeline fixture: random JPEGs per class dir."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"im{i}.jpg"))


def _formation_rate(dataset, *, batch: int, epochs: int, seed: int = 0
                    ) -> float:
    """images/sec through the loader's host batch-formation path (seeded
    shuffled epochs — the exact gather training performs)."""
    import numpy as np

    from distributed_deep_learning_tpu_torch.data.loader import DeviceLoader

    n_use = (len(dataset) // batch) * batch
    # host batches only: the device is never reached
    loader = DeviceLoader(dataset, np.arange(n_use), batch, "cpu",
                          shuffle=True, seed=seed)
    done = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for x, y in loader.iter_host_batches():
            done += len(x)
    dt = time.perf_counter() - t0
    return done / dt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="host batch-formation rate: eager decode vs packed "
                    "mmap cache")
    p.add_argument("--data-dir", default=None,
                   help="ImageFolder tree (default: generated JPEG "
                        "fixture)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=3,
                   help="measured epochs per path (packed additionally "
                        "gets one unmeasured page-cache warmup epoch)")
    p.add_argument("--eager-epochs", type=int, default=1,
                   help="measured epochs for the eager path (it is slow; "
                        "its cost is identical every epoch)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    from distributed_deep_learning_tpu_torch.data.imagefolder import (
        ImageFolderDataset)
    from distributed_deep_learning_tpu_torch.data.packed import (PackedDataset,
                                                           pack_dataset)

    with tempfile.TemporaryDirectory() as tmp:
        root = args.data_dir
        if root is None:
            root = os.path.join(tmp, "images")
            make_jpeg_tree(root)
        # max_cached_images=1: the eager number must be the DECODE rate,
        # not the LRU hit rate (epoch 2+ of a small fixture would
        # otherwise measure the cache, which real corpora don't fit)
        eager = ImageFolderDataset(root, image_size=args.image_size,
                                   max_cached_images=1)
        batch = min(args.batch, len(eager))
        eager_ips = _formation_rate(eager, batch=batch,
                                    epochs=args.eager_epochs)

        cache = os.path.join(tmp, "cache.ddlpack")
        t0 = time.perf_counter()
        header = pack_dataset(eager, cache)
        pack_secs = time.perf_counter() - t0
        packed = PackedDataset(cache)
        _formation_rate(packed, batch=batch, epochs=1)  # page-cache warmup
        packed_ips = _formation_rate(packed, batch=batch,
                                     epochs=args.epochs)

    line = {
        "metric": "host batch formation images/sec",
        "image_size": args.image_size,
        "batch": batch,
        "num_samples": header["num_samples"],
        "eager_images_per_sec": round(eager_ips, 1),
        "packed_images_per_sec": round(packed_ips, 1),
        "speedup": round(packed_ips / eager_ips, 1) if eager_ips else None,
        "pack_seconds": round(pack_secs, 3),
        "packed_bytes": header["total_bytes"],
        "feature_dtype": header["feature_dtype"],
    }
    out = json.dumps(line)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
