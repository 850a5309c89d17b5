"""``-m data --grad-compress bf16|int8`` through the port's CLI on two
spawned gloo ranks (the DDP communication hook of
``train/compress.py``), against the JAX CLI's ``-m data -r 2`` (its
``make_compressed_step_fns``) from the JAX init: the MLP of
``tests/test_compress.py`` (hidden 16, SGD at 0.05) over 3 steps, its
parameters and, for int8, each rank's error-feedback residual; a padded
token workload, whose loss each rank takes over its own rows; a
mid-epoch resume with a residual, bit-identical; and at one rank the
hook's absence: the history of plain ``-m data``, no residual."""

import contextlib
import io
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec
from test_torch_zero import check_history, jax_init, run_cli_ranks
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

#: test_compress.py's MLP: hidden 16, SGD at 0.05; 48 train rows = 3
#: steps of 16
MLP = ["-m", "data", "-r", "2", "-d", "cpu", "-l", "1", "-s", "16", "-e",
       "1", "-b", "16", "--optimizer", "sgd", "--lr", "0.05"]
LIMIT = "96"
#: seq2seq pads its rows: the ranks' token counts differ
SEQ = ["-m", "data", "-r", "2", "-d", "cpu", "-l", "1", "-s", "32", "-e",
       "1", "-b", "8", "--grad-compress", "int8"]


def jax_run(workload: str, argv: list, limit: str):
    """The JAX CLI's final state and phase history."""
    before = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = limit
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state, hist = jbase.run_workload(
                jget(workload), jconfig.parse_args(argv, workload=workload))
    finally:
        if before is None:
            del os.environ["DDL_DATA_LIMIT"]
        else:
            os.environ["DDL_DATA_LIMIT"] = before
    return state, [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist]


def mlp_tree(tree) -> dict:
    """A flax MLP params-shaped tree as the port's state dict."""
    return tmlp.load_flax_variables(
        {"params": jax.tree.map(np.asarray, tree)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    init = jax_init("mlp", MLP)
    cases = {f"mlp_{m}": {"workload": "mlp", "init": init,
                          "argv": MLP + ["--grad-compress", m]}
             for m in ("bf16", "int8")}
    ck = str(tmp / "ckpt")
    resume = MLP + ["--grad-compress", "int8", "--checkpoint-dir", ck,
                    "--checkpoint-every", "1"]
    cases["whole"] = {"workload": "mlp", "init": init, "argv": resume}
    cases["resumed"] = {"workload": "mlp", "init": init,
                        "argv": resume + ["--resume"], "prune": (ck, 2)}
    cases["seq"] = {"workload": "transformer", "argv": SEQ,
                    "init": jax_init("transformer", SEQ)}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 2, cases, tmp, LIMIT)
        want = {m: jax_run("mlp", cases[f"mlp_{m}"]["argv"], LIMIT)
                for m in ("bf16", "int8")}
        want["seq"] = jax_run("transformer", SEQ, LIMIT)
        return ranks.result(), want


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_hook_matches_jax_compressed_step(method, runs):
    ranks, want = runs
    state, hist = want[method]
    name = f"mlp_{method}"
    check_history(ranks[0][name]["hist"], hist, name)
    jparams = mlp_tree(state.params)
    for r in ranks:
        for k, v in jparams.items():
            torch.testing.assert_close(r[name]["params"][k],
                                       torch.as_tensor(v), rtol=1e-5,
                                       atol=1e-6, msg=k)
    if method == "bf16":
        assert all(not r[name]["residual"] for r in ranks)
        return
    # each rank's residual is its row of JAX's (n, ...) buffer
    for rank, r in enumerate(ranks):
        jres = mlp_tree(jax.tree.map(lambda a: np.asarray(a)[rank],
                                     state.comm_residual))
        assert set(r[name]["residual"]) == set(jres)
        for k, v in jres.items():
            torch.testing.assert_close(r[name]["residual"][k],
                                       torch.as_tensor(v), rtol=1e-5,
                                       atol=1e-6, msg=k)


def test_padded_tokens_take_each_ranks_own_mean(runs):
    """seq2seq's pad tokens differ between the ranks' rows: the history
    is JAX's mean of the ranks' means, not the global token mean."""
    ranks, want = runs
    check_history(ranks[0]["seq"]["hist"], want["seq"][1], "seq", rtol=1e-4)
    assert ranks[1]["seq"]["hist"] == ranks[0]["seq"]["hist"]


def test_mid_epoch_resume_with_a_residual_is_bit_identical(runs):
    ranks, _ = runs
    for r in ranks:
        whole, resumed = r["whole"], r["resumed"]
        assert resumed["hist"] == whole["hist"]
        for part in ("params", "residual"):
            assert set(resumed[part]) == set(whole[part])
            for k, v in whole[part].items():
                torch.testing.assert_close(resumed[part][k], v, rtol=0,
                                           atol=0, msg=k)
    # the residuals are the ranks' own
    assert any(not torch.equal(ranks[0]["whole"]["residual"][k],
                               ranks[1]["whole"]["residual"][k])
               for k in ranks[0]["whole"]["residual"])


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_one_rank_compresses_nothing(method, monkeypatch):
    """JAX reduces nothing over one shard: no hook, no residual, plain
    ``-m data``'s history."""
    monkeypatch.setenv("DDL_DATA_LIMIT", LIMIT)
    argv = [a for a in MLP if a not in ("-r", "2")]
    runs = {}
    for flags in ([], ["--grad-compress", method]):
        with contextlib.redirect_stdout(io.StringIO()):
            state, hist = tbase.run_workload(
                get_spec("mlp"), tconfig.parse_args(argv + flags, "mlp"))
        runs[bool(flags)] = state, [(h.phase, h.epoch, h.accuracy, h.loss)
                                    for h in hist]
    state, hist = runs[True]
    assert state.comm is None and state.comm_residual is None
    assert hist == runs[False][1]


@pytest.mark.parametrize("workload,argv", [
    ("mlp", ["-m", "data", "--grad-compress", "int8", "--zero", "1"]),
    ("mlp", ["-m", "data", "--grad-compress", "bf16", "--grad-accum", "2"]),
    ("gpt", ["-m", "pipeline", "--nstages", "2", "-l", "2", "-s", "32",
             "--grad-compress", "bf16"]),
    ("mlp", ["-m", "model", "--nstages", "2", "--grad-compress", "bf16"]),
])
def test_runner_refusals_are_jax_messages(workload, argv, monkeypatch):
    """The JAX runner's ``ValueError`` s, with its messages."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    argv = argv + ["-e", "1", "-b", "8", "-d", "cpu"]
    with pytest.raises(ValueError) as theirs, \
            contextlib.redirect_stdout(io.StringIO()):
        jbase.run_workload(jget(workload),
                           jconfig.parse_args(argv, workload=workload))
    with pytest.raises(ValueError) as mine, \
            contextlib.redirect_stdout(io.StringIO()):
        tbase.run_workload(get_spec(workload),
                           tconfig.parse_args(argv, workload))
    assert str(mine.value) == str(theirs.value)


def test_comm_at_one_rank_raises_jax_error(monkeypatch):
    """One batch rank has nothing to gather or scatter."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    argv = ["-m", "data", "-e", "1", "-b", "8", "-d", "cpu", "--zero",
            "fsdp", "--comm", "int8"]
    with pytest.raises(ValueError, match="explicit FSDP collectives need "
                       "a >1 'data' mesh axis"), \
            contextlib.redirect_stdout(io.StringIO()):
        tbase.run_workload(get_spec("mlp"), tconfig.parse_args(argv, "mlp"))
