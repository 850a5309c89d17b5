"""Reference-scale data soak: the counterpart of ``scripts/data_soak.py``.

Generates synthetic corpora at the reference's documented scale anchors:

* PdM:  100 machines x 8759 rows (``LSTM/dataset.py:28-30``)
* PCB:  ~2953 images -> 5906 virtual samples (``CNN/dataset.py:114-117``)
* MQTT: a one-million-row CSV (``MLP/dataset.py:43-45``)

then runs ONE full epoch of each through the port's loaders (the native
CSV parser, the window gather, the crop-resize, the PCB image cache) and
moves every batch to the device through
:class:`..data.loader.DeviceLoader` (``cuda`` unless ``--device cpu``),
printing one JSON line a corpus: the JAX script's keys (throughput, peak
RSS), plus the batches' ``device`` and the last batch's ``batch_shapes``.

    python -m distributed_deep_learning_tpu_torch.scripts.data_soak \
        [--small] [--only pdm|mqtt|pcb] [--device cpu] [--root DIR]

``--small`` shrinks the corpora ~10x.  The corpora go to a temporary
directory unless ``--root`` names one.
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def emit(**kv):
    print(json.dumps(kv), flush=True)


def gen_csv(path: str, rows: int, feat: int, targets: int = 5,
            chunk: int = 50_000) -> float:
    """Write a float CSV with header; returns file size in MB."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        f.write(",".join(f"c{i}" for i in range(feat + targets)) + "\n")
        for lo in range(0, rows, chunk):
            n = min(chunk, rows - lo)
            block = rng.normal(size=(n, feat + targets)).astype(np.float32)
            np.savetxt(f, block, fmt="%.5f", delimiter=",")
    return os.path.getsize(path) / 1e6


def soak_pdm(root: str, machines: int, ipm: int, batch: int = 512,
             device="cuda") -> None:
    from distributed_deep_learning_tpu_torch.data.loader import DeviceLoader
    from distributed_deep_learning_tpu_torch.data.pdm import load_pdm

    path = os.path.join(root, "pdm.csv")
    t0 = time.monotonic()
    mb = gen_csv(path, machines * ipm, feat=32)
    gen_s = time.monotonic() - t0

    t0 = time.monotonic()
    ds = load_pdm(path, history=10, instances_per_machine=ipm)
    load_s = time.monotonic() - t0

    loader = DeviceLoader(ds, np.arange(len(ds)), batch, device,
                          shuffle=True)
    loader.set_epoch(1)
    t0, n, shape = time.monotonic(), 0, None
    for x, y in loader:
        n += x.shape[0]
        shape = [list(x.shape), list(y.shape)]
    _sync(device)
    assert n, "corpus smaller than one batch — nothing soaked"
    epoch_s = time.monotonic() - t0
    emit(soak="pdm", rows=machines * ipm, csv_mb=round(mb, 1),
         gen_s=round(gen_s, 1), parse_s=round(load_s, 2),
         parse_mb_per_s=round(mb / load_s, 1), windows=len(ds),
         epoch_s=round(epoch_s, 2), windows_per_s=round(n / epoch_s),
         rss_mb=round(rss_mb()),
         device=str(x.device), batch_shapes=shape)


def soak_mqtt(root: str, rows: int, batch: int = 1024,
              device="cuda") -> None:
    from distributed_deep_learning_tpu_torch.data.loader import DeviceLoader
    from distributed_deep_learning_tpu_torch.data.mqtt import load_mqtt

    path = os.path.join(root, "mqtt.csv")
    t0 = time.monotonic()
    mb = gen_csv(path, rows, feat=29)  # index col dropped + 28 features
    gen_s = time.monotonic() - t0

    t0 = time.monotonic()
    ds = load_mqtt(path)
    load_s = time.monotonic() - t0  # reference anchor: pandas ~101 s

    loader = DeviceLoader(ds, np.arange(len(ds)), batch, device,
                          shuffle=True)
    loader.set_epoch(1)
    t0, n, shape = time.monotonic(), 0, None
    for x, y in loader:
        n += x.shape[0]
        shape = [list(x.shape), list(y.shape)]
    _sync(device)
    assert n, "corpus smaller than one batch — nothing soaked"
    epoch_s = time.monotonic() - t0
    emit(soak="mqtt", rows=rows, csv_mb=round(mb, 1), gen_s=round(gen_s, 1),
         parse_s=round(load_s, 2), parse_mb_per_s=round(mb / load_s, 1),
         epoch_s=round(epoch_s, 2), rows_per_s=round(n / epoch_s),
         rss_mb=round(rss_mb()),
         device=str(x.device), batch_shapes=shape)


def gen_pcb_tree(root: str, classes: int, per_class: int,
                 size: int = 600) -> int:
    """VOC-style tree with JPEG images + bbox XMLs; returns image count."""
    from PIL import Image

    rng = np.random.default_rng(1)
    n = 0
    for c in range(classes):
        cname = f"defect_{c}"
        img_dir = os.path.join(root, "images", cname)
        ann_dir = os.path.join(root, "Annotations", cname)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        for i in range(per_class):
            arr = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, f"{i:05d}.jpg"),
                                      quality=60)
            xmin, ymin = rng.integers(0, size - 120, size=2)
            w, h = rng.integers(40, 120, size=2)
            xml = ("<annotation><object><bndbox>"
                   f"<xmin>{xmin}</xmin><ymin>{ymin}</ymin>"
                   f"<xmax>{xmin + w}</xmax><ymax>{ymin + h}</ymax>"
                   "</bndbox></object></annotation>")
            with open(os.path.join(ann_dir, f"{i:05d}.xml"), "w") as f:
                f.write(xml)
            n += 1
    return n


def soak_pcb(root: str, classes: int, per_class: int,
             batch: int = 64, device="cuda") -> None:
    from distributed_deep_learning_tpu_torch.data.loader import DeviceLoader
    from distributed_deep_learning_tpu_torch.data.pcb import PCBDataset

    tree = os.path.join(root, "pcb")
    t0 = time.monotonic()
    n_img = gen_pcb_tree(tree, classes, per_class)
    gen_s = time.monotonic() - t0

    t0 = time.monotonic()
    ds = PCBDataset(tree)
    scan_s = time.monotonic() - t0

    loader = DeviceLoader(ds, np.arange(len(ds)), batch, device,
                          shuffle=True)
    loader.set_epoch(1)
    t0, n, shape = time.monotonic(), 0, None
    for x, y in loader:
        n += x.shape[0]
        shape = [list(x.shape), list(y.shape)]
    _sync(device)
    assert n, "corpus smaller than one batch — nothing soaked"
    epoch_s = time.monotonic() - t0
    emit(soak="pcb", images=n_img, virtual_samples=len(ds),
         gen_s=round(gen_s, 1), scan_s=round(scan_s, 2),
         epoch_s=round(epoch_s, 2), samples_per_s=round(n / epoch_s),
         rss_mb=round(rss_mb()),
         device=str(x.device), batch_shapes=shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one epoch of the reference-scale corpora through the "
                    "real loaders, onto the device")
    ap.add_argument("--small", action="store_true",
                    help="~10x smaller corpora (CI smoke)")
    ap.add_argument("--root", default=None,
                    help="where the corpora are written (default: a "
                         "temporary directory, removed after)")
    ap.add_argument("--only", choices=["pdm", "mqtt", "pcb"], default=None)
    ap.add_argument("--device", default="cuda",
                    help="where each batch goes (cuda unless cpu)")
    args = ap.parse_args(argv)

    from distributed_deep_learning_tpu_torch import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root or tmp
        os.makedirs(root, exist_ok=True)
        div = 10 if args.small else 1
        if args.only in (None, "pdm"):
            soak_pdm(root, machines=100 // div, ipm=8759, device=device)
        if args.only in (None, "mqtt"):
            soak_mqtt(root, rows=1_000_000 // div, device=device)
        if args.only in (None, "pcb"):
            soak_pcb(root, classes=6, per_class=492 // div, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
