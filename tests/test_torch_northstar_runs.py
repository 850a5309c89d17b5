"""The north-star workloads' run modes on ``-d cpu``.

* ``resnet --packed-cache``: a cache of the CIFAR-10 twin's first 96 rows
  packed with the port's ``pack_dataset`` gives the eager run's history
  exactly, steps and phases alike.
* A cache packed by either package trains in the other (``mlp``, whose
  runs are cheap in both): the JAX CLI on the port's cache and the port's
  CLI on JAX's cache each give its own eager run's history exactly.
* ``resnet -m data --spawn -r 2`` on gloo: the first loss and the
  BatchNorm running statistics equal those of the sequential run over the
  same global batch (1e-6): the statistics span the global batch.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.data import datasets as jds
from distributed_deep_learning_tpu.data import packed as jpk
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.__main__ import main
from distributed_deep_learning_tpu_torch.data import datasets as tds
from distributed_deep_learning_tpu_torch.data import packed as tpk
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROWS = 96


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _history(hist):
    return [(h.phase, h.epoch, h.examples, h.loss, h.accuracy,
             tuple(h.step_losses)) for h in hist]


def test_resnet_packed_cache_gives_the_eager_history(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", str(ROWS))
    path = tmp_path / "cifar.ddlpack"
    header = tpk.pack_dataset(tds.synthetic_cifar10(seed=42), path,
                              indices=np.arange(ROWS))
    assert header["feature_shape"] == [32, 32, 3]
    argv = ["resnet", "-e", "1", "-b", "8", "-d", "cpu"]
    _, eager = main(argv)
    _, packed = main(argv + ["--packed-cache", str(path)])
    assert _history(packed) == _history(eager)


def test_caches_train_in_the_other_package(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "256")
    argv = ["-l", "2", "-s", "16", "-e", "1", "-b", "16", "-d", "cpu"]
    ours, theirs = tmp_path / "port.ddlpack", tmp_path / "jax.ddlpack"
    tpk.pack_dataset(tds.synthetic_mqtt(seed=42), ours,
                     indices=np.arange(256))
    jpk.pack_dataset(jds.synthetic_mqtt(seed=42), theirs,
                     indices=np.arange(256))

    def jax_run(*extra):
        cfg = jconfig.parse_args(argv + list(extra), workload="mlp")
        return jbase.run_workload(jget("mlp"), cfg)[1]

    def summary(hist):     # the JAX history's step losses are not kept
        return [(h.phase, h.epoch, h.examples, h.loss, h.accuracy)
                for h in hist]

    assert summary(jax_run("--packed-cache", str(ours))) == \
        summary(jax_run())
    _, eager = main(["mlp", *argv])
    _, packed = main(["mlp", *argv, "--packed-cache", str(theirs)])
    assert _history(packed) == _history(eager)


_END = re.compile(r'^"train epoch 1 ends at \S+ with accuracy \S+ and loss '
                  r'(\S+)"$', re.M)
DP_ARGS = ["-e", "1", "-b", "8", "-d", "cpu"]


def _running_stats(path):
    payload = torch.load(path, weights_only=True)
    return {k: v for k, v in payload["params"].items()
            if k.endswith(("running_mean", "running_var"))}


def test_resnet_data_parallel_equals_the_global_batch(tmp_path):
    """One train step (16 rows: one batch of 8, 4 a rank) on 2 spawned
    gloo ranks and sequentially, each saving a checkpoint."""
    env = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = "16"
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(["resnet", "-m", "data", "--spawn", "-r", "2", *DP_ARGS,
                  "--checkpoint-dir", str(tmp_path / "dp")])
            _, hist = main(["resnet", *DP_ARGS, "--checkpoint-dir",
                            str(tmp_path / "seq")])
    finally:
        if env is None:
            os.environ.pop("DDL_DATA_LIMIT")
        else:
            os.environ["DDL_DATA_LIMIT"] = env
    losses = [float(v) for v in _END.findall(out.getvalue())]
    assert len(losses) == 2                  # rank 0's, then sequential's
    np.testing.assert_allclose(losses[0], hist[0].loss, rtol=1e-6)
    dp = _running_stats(tmp_path / "dp" / "ckpt-1.pt")
    seq = _running_stats(tmp_path / "seq" / "ckpt-1.pt")
    assert sorted(dp) == sorted(seq) and len(seq) == 2 * 20
    for k in seq:
        torch.testing.assert_close(dp[k], seq[k], rtol=0, atol=1e-6, msg=k)
