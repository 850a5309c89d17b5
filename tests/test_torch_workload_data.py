"""The reference workloads' data: the port's loaders against the JAX
package's, and its host-data library against its NumPy fallback.

Same seed, same arrays: the synthetic twins (images NHWC); the MQTT and
PdM fixture CSVs (PdM also cut into 5 machines, where windows must skip
the machine boundaries); a generated PCB tree (bbox crops with the ×2
shift augmentation); MNIST idx files, gzipped or not, and ``.npy``
pairs.  Batches are compared exactly.  The native library builds into
``build/torch_native/`` (never the JAX package's directory) and agrees
with the fallbacks exactly (the resize within 1e-5).
"""

import gzip
import os
import struct
from pathlib import Path

import numpy as np
import pytest

from distributed_deep_learning_tpu import native as jnative
from distributed_deep_learning_tpu.data import datasets as jds
from distributed_deep_learning_tpu.data import mnist as jmnist
from distributed_deep_learning_tpu.data import mqtt as jmqtt
from distributed_deep_learning_tpu.data import pcb as jpcb
from distributed_deep_learning_tpu.data import pdm as jpdm
from distributed_deep_learning_tpu_torch import native
from distributed_deep_learning_tpu_torch.data import datasets as tds
from distributed_deep_learning_tpu_torch.data import mnist as tmnist
from distributed_deep_learning_tpu_torch.data import mqtt as tmqtt
from distributed_deep_learning_tpu_torch.data import pcb as tpcb
from distributed_deep_learning_tpu_torch.data import pdm as tpdm
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
IDX = np.random.default_rng(3).permutation(40)[:16]


def _same_batches(mine, theirs, idx=IDX):
    assert len(mine) == len(theirs)
    for a, b in zip(mine.batch(idx), theirs.batch(idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", [
    ("synthetic_mqtt", {}), ("synthetic_pcb", {"n": 64}),
    ("synthetic_pdm", {}), ("synthetic_mnist", {"n": 64}),
    ("synthetic_pcb", {"n": 64, "num_classes": 4, "seed": 5}),
])
def test_synthetic_twins_match(name, kw):
    mine, theirs = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
    np.testing.assert_array_equal(mine.features, theirs.features)
    np.testing.assert_array_equal(mine.targets, theirs.targets)
    _same_batches(mine, theirs)


def test_mqtt_fixture_matches():
    path = str(FIXTURES / "mqtt" / "dataset.csv")
    _same_batches(tmqtt.load_mqtt(path), jmqtt.load_mqtt(path))


@pytest.mark.parametrize("machines", [1, 5])
def test_pdm_fixture_matches(machines):
    path = str(FIXTURES / "pdm" / "dataset.csv")
    rows = 265
    ipm = None if machines == 1 else rows // machines
    mine = tpdm.load_pdm(path, instances_per_machine=ipm)
    theirs = jpdm.load_pdm(path, instances_per_machine=ipm)
    idx = np.arange(len(mine))
    np.testing.assert_array_equal(mine.idx2pos(idx), theirs.idx2pos(idx))
    _same_batches(mine, theirs, idx)
    x, y = mine.batch(idx)
    # the windows never cross a machine boundary; the target is the
    # window's first row (quirk Q5)
    pos = mine.idx2pos(idx)
    assert ((pos % (rows // machines)) >= 9).all()
    np.testing.assert_array_equal(y, mine.targets[pos - 9])
    np.testing.assert_array_equal(x[:, 0], mine.features[pos - 9])


@pytest.fixture(scope="module")
def pcb_root(tmp_path_factory):
    """A VOC-style tree: Annotations/<class>/*.xml + images/<class>/*.jpg,
    two boxes an image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pcb")
    rng = np.random.default_rng(5)
    for ci in range(3):
        cls = f"defect_{ci}"
        (root / "Annotations" / cls).mkdir(parents=True)
        (root / "images" / cls).mkdir(parents=True)
        for i in range(2):
            arr = rng.integers(0, 255, (90, 100, 3)).astype(np.uint8)
            Image.fromarray(arr).save(root / "images" / cls / f"im{i}.jpg")
            boxes = "".join(
                f"<object><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
                f"<xmax>{x0 + 37}</xmax><ymax>{y0 + 29}</ymax>"
                "</bndbox></object>" for x0, y0 in ((5, 5), (55, 52)))
            (root / "Annotations" / cls / f"im{i}.xml").write_text(
                f"<annotation>{boxes}</annotation>")
    return str(root)


@pytest.mark.parametrize("workers", [1, 3])
def test_pcb_tree_matches(pcb_root, workers):
    mine = tpcb.PCBDataset(root=pcb_root, seed=7, workers=workers)
    theirs = jpcb.PCBDataset(root=pcb_root, seed=7, workers=workers)
    assert mine.classes == theirs.classes and len(mine) == 24
    np.testing.assert_array_equal(mine.shift, theirs.shift)
    _same_batches(mine, theirs, np.arange(24))
    x, y = mine.batch(np.arange(4))
    assert x.shape == (4, 64, 64, 3) and y.shape == (4, 3)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("layout", ["idx", "idx.gz", "npy"])
def test_mnist_files_match(tmp_path, layout):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 20).astype(np.uint8)
    if layout == "npy":
        np.save(tmp_path / "images.npy", images)
        np.save(tmp_path / "labels.npy", labels)
    else:
        gz = layout.endswith(".gz")
        suffix = ".gz" if gz else ""
        _write_idx(tmp_path / f"train-images-idx3-ubyte{suffix}", images, gz)
        _write_idx(tmp_path / f"train-labels-idx1-ubyte{suffix}", labels, gz)
        np.testing.assert_array_equal(
            tmnist.read_idx(str(tmp_path / f"train-images-idx3-ubyte"
                                           f"{suffix}")), images)
    mine, theirs = tmnist.load_mnist(tmp_path), jmnist.load_mnist(tmp_path)
    assert mine.features.shape == (20, 28, 28, 1)
    np.testing.assert_array_equal(mine.features, theirs.features)
    _same_batches(mine, theirs, np.arange(20))


# --- the host-data library ----------------------------------------------------

def test_native_builds_into_the_ports_own_directory():
    if os.environ.get("DDL_DISABLE_NATIVE") == "1":
        pytest.skip("DDL_DISABLE_NATIVE=1 disables the native library")
    assert native.available(), "g++ could not build ddl_native.cpp"
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "torch_native"
    jax_lib = Path(jnative._LIB).resolve()
    assert path.resolve() != jax_lib
    loaded = Path(native.get_lib()._name).resolve()
    assert loaded == path.resolve()


@pytest.fixture
def fallback(monkeypatch):
    """The NumPy fallbacks, as without a compiler."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _native_and_fallback(fn, monkeypatch):
    got = fn()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    want = fn()
    monkeypatch.undo()
    return got, want


def test_native_take_and_window_gather_match_fallback(monkeypatch):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(300, 7)).astype(np.float32)
    images = rng.normal(size=(50, 8, 8, 3)).astype(np.float32)
    idx = rng.integers(0, 50, 33)
    pos = rng.integers(9, 300, 40)
    for fn in (lambda: native.take(rows, idx),
               lambda: native.take(images, idx),
               lambda: native.window_gather(rows, pos, 10)):
        got, want = _native_and_fallback(fn, monkeypatch)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("drop_first", [False, True])
def test_native_read_csv_matches_fallback(monkeypatch, drop_first):
    path = str(FIXTURES / "mqtt" / "dataset.csv")
    got, want = _native_and_fallback(
        lambda: native.read_csv(path, drop_first_col=drop_first),
        monkeypatch)
    np.testing.assert_array_equal(got, want)


def test_native_crop_resize_matches_fallback(monkeypatch):
    img = np.random.default_rng(2).random((37, 41, 3)).astype(np.float32)
    got, want = _native_and_fallback(
        lambda: native.crop_resize_bilinear(img, 3, 5, 29, 31, 64, 64),
        monkeypatch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_loaders_take_the_fallback_without_the_library(fallback):
    path = str(FIXTURES / "pdm" / "dataset.csv")
    _same_batches(tpdm.load_pdm(path, instances_per_machine=None),
                  jpdm.load_pdm(path, instances_per_machine=None))
