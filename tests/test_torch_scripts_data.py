"""The port's data tools against the JAX package's scripts, on the CPU.

* ``scripts.pack_dataset`` writes the bytes of ``scripts/pack_dataset.py``
  for the same dataset and flags (an image tree, the ``mlp`` and ``lstm``
  workloads' MQTT and PdM rows), and each package reads the other's file
  back to the same batches.
* ``scripts.feed_bench`` on a tiny image tree: the JAX record's keys and
  its counts.
* ``scripts.data_soak --small --only X``, X each corpus: the JAX script's
  keys and counts for the same corpus, the corpus files the JAX
  generator's bytes, and the batch shapes of JAX's loader.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_deep_learning_tpu.data import packed as jpacked
from distributed_deep_learning_tpu_torch.data import packed as tpacked
from distributed_deep_learning_tpu_torch.scripts import (data_soak,
                                                         feed_bench,
                                                         pack_dataset)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree") / "images"
    _jax_script("feed_bench").make_jpeg_tree(str(root), classes=3,
                                             per_class=4, size=24)
    return root


@pytest.mark.parametrize("case", ["images", "mlp", "lstm"])
def test_pack_dataset_writes_jaxs_bytes(case, tree, tmp_path):
    argv = {"images": ["--workload", "resnet", "--data-dir", str(tree),
                       "--image-size", "16"],
            "mlp": ["--workload", "mlp", "--limit", "96"],
            "lstm": ["--workload", "lstm", "--limit", "64"]}[case]
    jax_out, port_out = tmp_path / "jax.ddlpack", tmp_path / "port.ddlpack"
    rc, (theirs,) = _lines(_jax_script("pack_dataset").main,
                           argv + ["--out", str(jax_out)])
    assert rc == 0
    rc, (mine,) = _lines(pack_dataset.main, argv + ["--out", str(port_out)])
    assert rc == 0
    assert jax_out.read_bytes() == port_out.read_bytes()
    for key in ("num_samples", "feature_shape", "feature_dtype",
                "target_shape", "target_dtype", "bytes"):
        assert mine[key] == theirs[key], key
    assert set(mine) == set(theirs)
    rows = np.arange(min(8, mine["num_samples"]))
    for a, b in zip(tpacked.PackedDataset(str(jax_out)).batch(rows),
                    jpacked.PackedDataset(str(port_out)).batch(rows)):
        np.testing.assert_array_equal(a, b)


def test_feed_bench_record_has_jaxs_keys_and_counts(tree):
    argv = ["--data-dir", str(tree), "--image-size", "16", "--batch", "4",
            "--epochs", "1"]
    _, (theirs,) = _lines(_jax_script("feed_bench").main, argv)
    rc, (mine,) = _lines(feed_bench.main, argv)
    assert rc == 0 and set(mine) == set(theirs)
    for key in ("metric", "image_size", "batch", "num_samples",
                "packed_bytes", "feature_dtype"):
        assert mine[key] == theirs[key], key
    assert mine["packed_images_per_sec"] > 0 < mine["eager_images_per_sec"]


#: the keys of each soak's record that do not depend on the clock or the
#: process's memory
COUNTS = {"pdm": ("soak", "rows", "csv_mb", "windows"),
          "mqtt": ("soak", "rows", "csv_mb"),
          "pcb": ("soak", "images", "virtual_samples")}


@pytest.mark.parametrize("corpus", sorted(COUNTS))
def test_data_soak_counts_equal_jaxs(corpus, tmp_path, monkeypatch):
    jsoak = _jax_script("data_soak")
    monkeypatch.setattr(sys, "argv", ["data_soak.py", "--small", "--only",
                                      corpus, "--root",
                                      str(tmp_path / "jax")])
    _, (theirs,) = _lines(jsoak.main)
    rc, (mine,) = _lines(data_soak.main, ["--small", "--only", corpus,
                                          "--root", str(tmp_path / "port"),
                                          "--device", "cpu"])
    assert rc == 0 and mine["device"] == "cpu"
    assert set(mine) - set(theirs) == {"device", "batch_shapes"}
    for key in COUNTS[corpus]:
        assert mine[key] == theirs[key], key
    # the corpus on disk is the JAX generator's, and JAX's loader makes
    # the batches of the shapes the port's made
    name = {"pdm": "pdm.csv", "mqtt": "mqtt.csv", "pcb": "pcb"}[corpus]
    if corpus != "pcb":
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    jx = _jax_batch(corpus, str(tmp_path / "jax" / name))
    assert mine["batch_shapes"] == jx


def _jax_batch(corpus, path):
    """The shapes of the last full batch of the JAX script's loader."""
    from distributed_deep_learning_tpu.data.loader import DeviceLoader
    from distributed_deep_learning_tpu.runtime.mesh import build_mesh

    if corpus == "pdm":
        from distributed_deep_learning_tpu.data.pdm import load_pdm

        ds, batch = load_pdm(path, history=10, instances_per_machine=8759), \
            512
    elif corpus == "mqtt":
        from distributed_deep_learning_tpu.data.mqtt import load_mqtt

        ds, batch = load_mqtt(path), 1024
    else:
        from distributed_deep_learning_tpu.data.pcb import PCBDataset

        ds, batch = PCBDataset(path), 64
    loader = DeviceLoader(ds, np.arange(len(ds)), batch,
                          build_mesh({"data": 8}), shuffle=True)
    loader.set_epoch(1)
    x, y = next(iter(loader.iter_host_batches()))
    return [list(x.shape), list(y.shape)]


def test_data_soak_removes_its_default_corpus(tmp_path, monkeypatch):
    """Without ``--root`` the corpus goes to a temporary directory that is
    gone after the run."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, (rec,) = _lines(data_soak.main, ["--small", "--only", "mqtt",
                                         "--device", "cpu"])
    assert rc == 0 and rec["rows"] == 100000 and rec["csv_mb"] > 0
    assert os.listdir(tmp_path) == []
