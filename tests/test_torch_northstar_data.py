"""The north-star zoo's data: the port's datasets, ImageFolder reader and
packed sample cache against the JAX package's.

* The synthetic twins (CIFAR-10, ImageNet, WMT, C4 MLM), the workloads'
  datasets built from them (the WMT rows source ⊕ target, the MLM targets
  kept at the masked sites) and from a ``tokens.npy`` (``mlm_dataset``,
  ``seq2seq_dataset``) are bit-equal to JAX's for the same seed.
* ``ImageFolderDataset`` on a generated PNG tree at ``--image-size 40``
  gives JAX's classes and batches bit for bit, the host-data library's
  resize and its NumPy fallback alike.
* ``pack_dataset`` writes the JAX package's artifact byte for byte (float
  and uint8 storage, classes and vocabulary metadata), and each package
  reads the other's cache bit-identically.  Bad magic, a truncated file,
  another version and a broken JSON header are refused, and a lossy
  uint8 pack leaves no artifact.
"""

import json
import os

import numpy as np
import pytest

from distributed_deep_learning_tpu import native as jnative
from distributed_deep_learning_tpu.data import datasets as jds
from distributed_deep_learning_tpu.data import imagefolder as jif
from distributed_deep_learning_tpu.data import packed as jpk
from distributed_deep_learning_tpu.data import tokens as jtok
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch import native
from distributed_deep_learning_tpu_torch.data import datasets as tds
from distributed_deep_learning_tpu_torch.data import imagefolder as tif
from distributed_deep_learning_tpu_torch.data import packed as tpk
from distributed_deep_learning_tpu_torch.data import tokens as ttok
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

IDX = np.random.default_rng(3).permutation(32)[:12]


def _same(mine, theirs, idx=IDX):
    np.testing.assert_array_equal(mine.features, theirs.features)
    np.testing.assert_array_equal(mine.targets, theirs.targets)
    for a, b in zip(mine.batch(idx), theirs.batch(idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", [
    ("synthetic_cifar10", {"n": 64}),
    ("synthetic_imagenet", {"n": 40, "image_size": 48, "num_classes": 10,
                            "seed": 3}),
    ("synthetic_wmt", {"n": 64, "vocab_size": 500}),
    ("synthetic_c4_mlm", {"n": 64, "vocab_size": 1024, "seed": 5}),
])
def test_synthetic_twins_match(name, kw):
    _same(getattr(tds, name)(**kw), getattr(jds, name)(**kw))


@pytest.mark.parametrize("workload,builder", [
    ("transformer", "_wmt_dataset"), ("bert", "_mlm_dataset"),
    ("resnet", "_resnet_dataset")])
def test_workload_datasets_match(workload, builder):
    argv = ["--seed", "7"]
    mine = getattr(tns, builder)(tconfig.parse_args(argv, workload))
    theirs = getattr(jns, builder)(jconfig.parse_args(argv, workload))
    _same(mine, theirs)
    assert tns._vocab(mine) == jns._vocab(theirs)
    if workload == "bert":      # loss sites exactly at the masked ids
        assert bool(((mine.targets != 0) == (mine.features == 103)).all())


def _tokens():
    rng = np.random.default_rng(11)
    tok = rng.integers(1, 700, size=(32, 18)).astype(np.int32)
    for row, n in enumerate(rng.integers(5, 19, size=32)):
        tok[row, n:] = 0
    return tok


@pytest.mark.parametrize("kind", ["mlm", "seq2seq"])
def test_token_datasets_match(kind, tmp_path):
    tok = _tokens()
    np.save(tmp_path / "tokens.npy", tok)
    loaded = ttok.load_tokens(str(tmp_path))
    np.testing.assert_array_equal(loaded, jtok.load_tokens(str(tmp_path)))
    if kind == "mlm":
        mine = ttok.mlm_dataset(loaded, seed=4)
        theirs = jtok.mlm_dataset(loaded, seed=4)
        assert bool((mine.targets[tok == 0] == 0).all())
    else:
        mine = ttok.seq2seq_dataset(loaded)
        theirs = jtok.seq2seq_dataset(loaded)
        np.testing.assert_array_equal(mine.targets, tok[:, 9:])
    _same(mine, theirs)
    assert mine.vocab_size == theirs.vocab_size
    # and through the workloads' --data-dir branch
    builder = "_mlm_dataset" if kind == "mlm" else "_wmt_dataset"
    workload = "bert" if kind == "mlm" else "transformer"
    argv = ["--data-dir", str(tmp_path)]
    _same(getattr(tns, builder)(tconfig.parse_args(argv, workload)),
          getattr(jns, builder)(jconfig.parse_args(argv, workload)))


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for cls, shade in (("cat", 60), ("dog", 180), ("eel", 120)):
        d = root / cls
        (d / "sub").mkdir(parents=True)
        for i in range(4):
            arr = np.full((30 + 3 * i, 52 - 5 * i, 3), shade, np.uint8)
            arr += rng.integers(0, 40, arr.shape, dtype=np.uint8)
            where = d / "sub" if i == 3 else d
            Image.fromarray(arr).save(where / f"{i}.png")
        (d / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_imagefolder_batches_match(image_root, fallback, monkeypatch):
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert tif.find_classes(image_root) == jif.find_classes(image_root)
    mine = tif.ImageFolderDataset(image_root, image_size=40, num_workers=3)
    theirs = jif.ImageFolderDataset(image_root, image_size=40,
                                    num_workers=3)
    assert [p for p, _ in mine.samples] == [p for p, _ in theirs.samples]
    assert mine.classes == theirs.classes == ["cat", "dog", "eel"]
    idx = np.array([11, 0, 5, 3, 7, 10, 1])
    for a, b in zip(mine.batch(idx), theirs.batch(idx)):
        assert a.dtype == b.dtype and a.shape[0] == len(idx)
        np.testing.assert_array_equal(a, b)
    assert mine.batch(idx)[0].shape == (7, 40, 40, 3)


def test_imagefolder_sets_the_resnet_geometry(image_root):
    """``--data-dir`` at ``--image-size 40``: 3 classes, the small stem."""
    cfg = tconfig.parse_args(["--data-dir", image_root, "--image-size", "40",
                              "-w", "2"], "resnet")
    ds = tns._resnet_dataset(cfg)
    assert ds.image_size == 40 and ds._workers == 2
    assert tns._resnet_geometry(cfg, ds) == (18, 3, True)
    big = cfg.replace(image_size=96)
    assert tns._resnet_geometry(big, tns._resnet_dataset(big)) == \
        (18, 3, False)


# --- the packed cache ---------------------------------------------------------

def _pack_sources():
    """(name, port dataset, JAX dataset) pairs covering float storage,
    uint8 storage with classes, and token rows with a vocabulary."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(24, 6, 5, 3)).astype(np.float32)
    lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 24)]
    u8 = (tds.ArrayDataset(img, lab), jds.ArrayDataset(img, lab))
    for ds in u8:
        ds.classes = ["a", "b", "c", "d"]
    tok = _tokens()
    return {"float": (tds.synthetic_cifar10(n=40), jds.synthetic_cifar10(n=40)),
            "uint8": u8,
            "tokens": (ttok.seq2seq_dataset(tok), jtok.seq2seq_dataset(tok))}


@pytest.mark.parametrize("kind", ["float", "uint8", "tokens"])
def test_packed_caches_are_byte_compatible(kind, tmp_path):
    mine, theirs = _pack_sources()[kind]
    idx = np.arange(len(mine))[::-1] if kind == "tokens" else None
    h_mine = tpk.pack_dataset(mine, tmp_path / "mine.ddlpack", chunk_size=7,
                              indices=idx, meta={"source": kind})
    h_theirs = jpk.pack_dataset(theirs, tmp_path / "theirs.ddlpack",
                                chunk_size=7, indices=idx,
                                meta={"source": kind})
    assert h_mine == h_theirs
    assert (tmp_path / "mine.ddlpack").read_bytes() == \
        (tmp_path / "theirs.ddlpack").read_bytes()
    assert h_mine["feature_dtype"] == ("uint8" if kind == "uint8"
                                       else "float32" if kind == "float"
                                       else "int32")
    # each package reads the other's cache as the source reads
    for path, reader in ((tmp_path / "theirs.ddlpack", tpk.PackedDataset),
                         (tmp_path / "mine.ddlpack", jpk.PackedDataset)):
        ds = reader(path)
        rows = np.arange(len(ds)) if idx is None else idx
        want = mine.batch(rows)
        for a, b in zip(ds.batch(np.arange(len(ds))), want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert getattr(ds, "classes", None) == getattr(mine, "classes", None)
        assert getattr(ds, "vocab_size", None) == \
            getattr(mine, "vocab_size", None)


def _cache(tmp_path):
    path = tmp_path / "c.ddlpack"
    tpk.pack_dataset(tds.synthetic_cifar10(n=8), path)
    return path


@pytest.mark.parametrize("damage", ["magic", "truncated", "version",
                                    "header"])
def test_damaged_caches_are_refused(damage, tmp_path):
    path = _cache(tmp_path)
    raw = bytearray(path.read_bytes())
    if damage == "magic":
        raw[:7] = b"NOTPACK"
    elif damage == "truncated":
        raw = raw[:-100]
    elif damage == "version":
        raw[7] = tpk.VERSION + 1
    else:
        raw[16:17] = b"x"                 # the JSON header broken
    path.write_bytes(bytes(raw))
    with pytest.raises(tpk.PackedFormatError):
        tpk.PackedDataset(path)
    with pytest.raises(jpk.PackedFormatError):
        jpk.PackedDataset(path)


def test_pack_refuses_lossy_uint8_and_leaves_no_artifact(tmp_path):
    path = tmp_path / "x.ddlpack"
    with pytest.raises(ValueError, match="uint8"):
        tpk.pack_dataset(tds.synthetic_cifar10(n=8), path, dtype="uint8")
    assert not os.listdir(tmp_path)
    header = tpk.pack_dataset(tds.synthetic_cifar10(n=8), path)
    assert tpk.read_header(path) == header
    assert json.loads(json.dumps(header)) == header
