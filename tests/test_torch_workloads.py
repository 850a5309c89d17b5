"""The ``mlp``, ``cnn``, ``lstm`` and ``mnist`` workloads: the port's CLI
and training recipes against the JAX package's, and against itself.

* Optimizer recipes: 10 steps of ``cnn``'s SGD-momentum whose staircase
  decay drops at step 7 (a 1-step epoch) and of Adam (``mlp``/``lstm``),
  fed the same batches from the same flax init: losses within 1e-5
  relative.
* The CLI end to end on ``-d cpu``: each workload's phase history (loss
  and accuracy per phase) against the JAX CLI's from the same initial
  weights (``init_state_dict``), within 1e-4 relative (``cnn``: 1e-3; a
  BatchNorm net at batch 8 amplifies f32 rounding over its steps, while
  the recipe test above holds its single steps to 1e-5), with and
  without ``--double-softmax`` for ``mlp`` and ``cnn``.
* ``cnn -m data`` on 2 gloo ranks (``--spawn``): the first loss and the
  BatchNorm running statistics equal the sequential run over the same
  global batch (1e-6); planted control: statistics of one rank's rows
  alone miss by more than 1e-3.
* ``cnn`` resumed from a checkpoint equals the uninterrupted run, BN
  buffers included.
* What item 9 used to refuse now runs one epoch at ``DDL_DATA_LIMIT``
  (``resnet``, small ``transformer`` and ``bert``, ``--image-size`` and
  ``--stem-s2d``, which ``cnn`` ignores as the JAX CLI does, and
  ``--packed-cache``) and ``moe`` (two narrow layers, one routed);
  and ``--remat-policy dots`` on a conv model (item 16); the four gpt and
  token-CE flags that the JAX runner refuses elsewhere raise its
  messages.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import densenet as jdn
from distributed_deep_learning_tpu.models import mlp as jmlp
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train import objectives as jobj
from distributed_deep_learning_tpu.train.state import \
    create_train_state as jcreate
from distributed_deep_learning_tpu.train.state import \
    reference_optimizer as jref
from distributed_deep_learning_tpu.train.step import make_step_fns as jsteps
from distributed_deep_learning_tpu.train.step import place_state
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.__main__ import main
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from distributed_deep_learning_tpu_torch.models import cnn_lstm as tlstm
from distributed_deep_learning_tpu_torch.models import densenet as tdn
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.models import resnet as tres
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from distributed_deep_learning_tpu_torch.train.state import (
    create_train_state, reference_optimizer)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

LOADERS = {"mlp": tmlp.load_flax_variables, "cnn": tdn.load_flax_variables,
           "lstm": tlstm.load_flax_variables,
           "mnist": tres.load_flax_variables}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two intra-op threads run them as fast as eight."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --- the optimizer recipes ---------------------------------------------------

RECIPES = {
    # cnn: SGD 0.01, momentum 0.9, x0.1 after 7 one-step epochs
    "cnn": (lambda: jdn.DenseNet(dense_blocks=1, dense_layers=2,
                                 growth_rate=8, bn_size=2),
            lambda: tdn.DenseNet(dense_blocks=1, dense_layers=2,
                                 growth_rate=8, bn_size=2,
                                 image_size=(32, 32)),
            tdn.load_flax_variables, (32, 32, 3), 6),
    # mlp and lstm: Adam 1e-3
    "mlp": (lambda: jmlp.MLP(hidden_size=16, num_hidden_layers=2),
            lambda: tmlp.MLP(48, hidden_size=16, num_hidden_layers=2),
            tmlp.load_flax_variables, (48,), 5),
}


@pytest.mark.parametrize("workload", list(RECIPES))
def test_optimizer_recipe_matches_optax(workload):
    jmodel, tmodel, load, shape, classes = RECIPES[workload]
    steps, batch = 10, 8
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(steps, batch) + shape).astype(np.float32)
    ys = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                        (steps, batch))]
    jstate = jcreate(jmodel(), jax.random.key(0), jnp.zeros((1,) + shape),
                     jref(workload, None, epoch_steps=1))
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          **jstate.model_state})
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jstep, _ = jsteps(mesh, jobj.cross_entropy_loss)
    jstate = place_state(jstate, mesh)
    state = create_train_state(
        tmodel(), 0, reference_optimizer(workload, None, epoch_steps=1),
        load(variables), device="cpu")
    tstep, _ = make_step_fns(tobj.RowMean())
    want, got = [], []
    for x, y in zip(xs, ys):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        want.append(float(m["loss"]))
        state, m = tstep(state, torch.from_numpy(x), torch.from_numpy(y))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if workload == "cnn":
        assert state.tx.lr_at(6) == pytest.approx(0.01)
        assert state.tx.lr_at(7) == pytest.approx(0.001)
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.001)


# --- the CLI against the JAX CLI ----------------------------------------------

CLI_CASES = {
    "mlp": ("mlp", 256, ["-l", "2", "-s", "16", "-e", "2", "-b", "16"]),
    "mlp-double-softmax": ("mlp", 256, ["-l", "2", "-s", "16", "-e", "2",
                                        "-b", "16", "--double-softmax"]),
    "lstm": ("lstm", 256, ["-l", "2", "-s", "16", "-e", "2", "-b", "16"]),
    "mnist": ("mnist", 256, ["-e", "1", "-b", "16"]),
    "cnn": ("cnn", 96, ["-l", "1", "-s", "2", "-e", "2", "-b", "8"]),
    "cnn-double-softmax": ("cnn", 96, ["-l", "1", "-s", "2", "-e", "1",
                                       "-b", "8", "--double-softmax"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_history_matches_jax(case, monkeypatch):
    workload, limit, argv = CLI_CASES[case]
    argv = argv + ["-d", "cpu"]
    monkeypatch.setenv("DDL_DATA_LIMIT", str(limit))
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    variables = jspec.build_model(jcfg, dataset).init(
        jax.random.key(jcfg.seed), jbase.example_from_dataset(jcfg, dataset))
    _, jhist = jbase.run_workload(jspec, jcfg)
    _, thist = tbase.run_workload(
        tget(workload), tconfig.parse_args(argv, workload=workload),
        init_state_dict=LOADERS[workload](
            jax.tree.map(np.asarray, dict(variables))))
    assert [(h.phase, h.epoch, h.examples) for h in thist] == \
        [(h.phase, h.epoch, h.examples) for h in jhist]
    assert all(h.examples for h in thist)
    rtol = 1e-3 if workload == "cnn" else 1e-4
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=rtol, err_msg=mine.phase)
    assert all(np.isfinite(thist[0].step_losses))


# --- cnn -m data on two gloo ranks --------------------------------------------

_END = re.compile(r'^"train epoch 1 ends at \S+ with accuracy \S+ and loss '
                  r'(\S+)"$', re.M)
DP_ARGS = ["-l", "1", "-s", "2", "-e", "1", "-b", "8", "-d", "cpu"]


def _running_stats(path):
    payload = torch.load(path, weights_only=True)
    return {k: v for k, v in payload["params"].items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def data_parallel_runs(tmp_path_factory):
    """One train step (16 rows: 11 train rows, one batch of 8) of ``cnn``
    on 2 spawned gloo ranks and sequentially, each saving a checkpoint:
    ``(rank 0's log, sequential history, dp dir, sequential dir)``."""
    tmp = tmp_path_factory.mktemp("cnn_dp")
    env = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = "16"
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(["cnn", "-m", "data", "--spawn", "-r", "2", *DP_ARGS,
                  "--checkpoint-dir", str(tmp / "dp")])
            _, hist = main(["cnn", *DP_ARGS, "--checkpoint-dir",
                            str(tmp / "seq")])
    finally:
        if env is None:
            os.environ.pop("DDL_DATA_LIMIT")
        else:
            os.environ["DDL_DATA_LIMIT"] = env
    return out.getvalue(), hist, tmp / "dp", tmp / "seq"


def test_cnn_data_parallel_first_loss_equals_sequential(data_parallel_runs):
    log, hist, _, _ = data_parallel_runs
    losses = [float(v) for v in _END.findall(log)]
    assert len(losses) == 2                  # rank 0's, then sequential's
    np.testing.assert_allclose(losses[0], hist[0].loss, rtol=1e-6)


def test_cnn_data_parallel_batch_stats_span_the_global_batch(
        data_parallel_runs):
    _, _, dp_dir, seq_dir = data_parallel_runs
    dp = _running_stats(dp_dir / "ckpt-1.pt")
    seq = _running_stats(seq_dir / "ckpt-1.pt")
    assert sorted(dp) == sorted(seq) and dp
    for k in seq:
        torch.testing.assert_close(dp[k], seq[k], rtol=0, atol=1e-6,
                                   msg=k)
    # planted control: BatchNorm statistics of rank 0's rows alone
    dataset = tget("cnn").build_dataset(tconfig.parse_args(DP_ARGS, "cnn"))
    train, _, _ = make_loaders(dataset, train_val_test_split(16, seed=42),
                               8, "cpu", seed=42)
    train.set_epoch(1)
    x, _ = next(iter(train))
    model = tdn.DenseNet(dense_blocks=1, bn_size=2).reset_parameters(
        torch.Generator().manual_seed(42)).train()
    with torch.no_grad():
        model(x[:4])
    local = {k: v for k, v in model.state_dict().items() if k in seq}
    miss = max(float((local[k] - seq[k]).abs().max()) for k in seq)
    assert miss > 1e-3, miss


# --- resume -------------------------------------------------------------------

def test_cnn_resume_restores_batch_norm_buffers(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "48")
    args = ["cnn", "-l", "1", "-s", "2", "-b", "8", "-d", "cpu"]
    whole, hist = main(args + ["-e", "2", "--checkpoint-dir",
                               str(tmp_path / "a")])
    main(args + ["-e", "1", "--checkpoint-dir", str(tmp_path / "b")])
    saved = _running_stats(tmp_path / "b" / "ckpt-1.pt")
    assert any(float((v - 1).abs().max()) > 1e-3 for k, v in saved.items()
               if k.endswith("running_var"))
    resumed, rhist = main(args + ["-e", "2", "--checkpoint-dir",
                                  str(tmp_path / "b"), "--resume"])
    assert [(h.phase, h.epoch) for h in rhist] == \
        [("train", 2), ("validation", 2), ("test", None)]
    for mine, theirs in zip(rhist, hist[2:]):
        assert (mine.loss, mine.accuracy) == (theirs.loss, theirs.accuracy)
    for (k, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


# --- refusals, and what item 9 used to refuse ----------------------------------

@pytest.mark.parametrize("argv,error,match", [
    (["resnet"], None, None),
    (["transformer", "-l", "1", "-s", "64"], None, None),
    (["bert", "-l", "1", "-s", "64"], None, None),
    (["moe", "-l", "2", "-s", "64"], None, None),
    (["moe", "-l", "2", "-s", "64", "--label-smoothing", "0.1"], None,
     None),
    (["mlp", "--label-smoothing", "0.1"], ValueError,
     "applies to the token-CE workloads"),
    (["bert", "-l", "1", "-s", "64", "--window", "8"], ValueError,
     "needs a causal decoder-only model"),
    (["resnet", "--kv-heads", "2"], ValueError,
     r"--kv-heads \(grouped-query attention\) is a gpt option"),
    (["bert", "-l", "1", "-s", "64", "--pos", "rope"], ValueError,
     "is a gpt option; workload 'bert' uses its own position scheme"),
    (["cnn", "--image-size", "32"], None, None),
    (["cnn", "--stem-s2d"], None, None),
    (["mlp", "--packed-cache", "{packed}"], None, None),
    (["cnn", "--remat", "--remat-policy", "dots"], None, None),
    (["lstm", "--double-softmax"], ValueError, "mlp and cnn only"),
    (["mnist", "--double-softmax"], ValueError, "mlp and cnn only"),
])
def test_unported_workloads_and_flags_raise(argv, error, match,
                                            monkeypatch, tmp_path):
    """The refusals name their ROADMAP item; the rest runs one epoch with
    finite losses (``transformer``/``bert`` at one narrow layer: their CLI
    defaults are the base models)."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    if "{packed}" in argv:
        from distributed_deep_learning_tpu_torch.data.datasets import \
            synthetic_mqtt
        from distributed_deep_learning_tpu_torch.data.packed import \
            pack_dataset

        path = tmp_path / "mqtt.ddlpack"
        pack_dataset(synthetic_mqtt(seed=42), path, indices=np.arange(64))
        argv = [str(path) if a == "{packed}" else a for a in argv]
    if error is None:
        _, hist = main(argv + ["-e", "1", "-d", "cpu"])
        assert [h.phase for h in hist] == ["train", "validation", "test"]
        assert all(np.isfinite([h.loss for h in hist]))
        return
    with pytest.raises(error, match=match):
        main(argv + ["-e", "1", "-d", "cpu"])


@pytest.mark.parametrize("workload", ["mlp", "lstm", "cnn", "mnist"])
def test_explicit_data_dir_never_falls_back(workload, tmp_path):
    with pytest.raises(FileNotFoundError):
        main([workload, "-e", "1", "-d", "cpu", "--data-dir",
              str(tmp_path)])
