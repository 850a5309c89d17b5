"""Offline packer: the counterpart of ``scripts/pack_dataset.py``.  Any
workload's dataset becomes one memory-mappable artifact
(:mod:`..data.packed`, the JAX package's format: for the same dataset and
flags the bytes are the JAX script's, and each package reads the other's
file).  Host work only; nothing touches the card.

Builds the dataset exactly as training would (ImageFolder / PCB decode
through the threaded decoder, PdM/MQTT CSV windows, token rows), streams
it through ``batch()`` in chunks and writes the cache; training then runs
with ``--packed-cache`` and gathers batches from the mapped file with no
per-sample Python work (``scripts.feed_bench`` measures it).

    python -m distributed_deep_learning_tpu_torch.scripts.pack_dataset \
        --workload resnet --data-dir /data/imagenet --image-size 224 \
        -w 16 --out /data/imagenet.ddlpack

Prints one JSON line describing the artifact (samples, shapes, dtypes,
bytes, pack rate).  Packing is atomic: a crash leaves no partial file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_source(args):
    """The SAME dataset object the workload would train on (so the packed
    batches are bit-identical to the eager run's)."""
    from distributed_deep_learning_tpu_torch.utils.config import Config
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    config = Config(data_dir=args.data_dir, image_size=args.image_size,
                    num_workers=args.workers, seed=args.seed)
    return get_spec(args.workload).build_dataset(config)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="pack a workload dataset into an mmap-able sample "
                    "cache (train with --packed-cache)")
    p.add_argument("--workload", default="resnet",
                   help="whose dataset builder to pack (resnet, cnn, "
                        "lstm, mlp, ... — must match the training run)")
    p.add_argument("--data-dir", default=None,
                   help="real-data root (ImageFolder tree, PCB tree, CSV "
                        "dir); omitted = the workload's synthetic twin")
    p.add_argument("--image-size", type=int, default=224,
                   help="square decode size for image sources")
    p.add_argument("-w", "--workers", type=int, default=0,
                   help="decode threads while packing (0 = workload "
                        "default)")
    p.add_argument("--out", required=True,
                   help="artifact path (convention: *.ddlpack)")
    p.add_argument("--dtype", choices=["auto", "uint8", "source"],
                   default="auto",
                   help="feature storage: auto stores uint8 when lossless "
                        "(4x smaller), source keeps the decode dtype, "
                        "uint8 forces it (errors if lossy)")
    p.add_argument("--chunk", type=int, default=256,
                   help="samples decoded/written per chunk")
    p.add_argument("--limit", type=int, default=0,
                   help="pack only the first N samples (CI smoke)")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from distributed_deep_learning_tpu_torch.data.packed import pack_dataset

    t0 = time.perf_counter()
    dataset = build_source(args)
    t_build = time.perf_counter() - t0

    import numpy as np

    indices = None
    if args.limit:
        indices = np.arange(min(args.limit, len(dataset)))
    t0 = time.perf_counter()
    header = pack_dataset(
        dataset, args.out, dtype=args.dtype, chunk_size=args.chunk,
        indices=indices,
        meta={"workload": args.workload, "data_dir": args.data_dir,
              "image_size": args.image_size, "seed": args.seed,
              "limit": args.limit or None})
    t_pack = time.perf_counter() - t0
    n = header["num_samples"]
    print(json.dumps({
        "out": os.path.abspath(args.out),
        "num_samples": n,
        "feature_shape": header["feature_shape"],
        "feature_dtype": header["feature_dtype"],
        "target_shape": header["target_shape"],
        "target_dtype": header["target_dtype"],
        "bytes": header["total_bytes"],
        "build_seconds": round(t_build, 2),
        "pack_seconds": round(t_pack, 2),
        "samples_per_sec": round(n / t_pack, 1) if t_pack else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
