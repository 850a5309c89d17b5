"""``-m pipeline`` over a data x stage grid of ranks through the port's
CLI, against the JAX CLI on the same ``{"data": 2, "stage": 2}`` shape
(its runner given four CPU devices), from JAX's initial weights.

One set of four gloo ranks runs every case on one process group: ``gpt``
under 1F1B and ``bert`` under GPipe (rank 0's history within 1e-5
relative of JAX's), ``gpt`` interleaved with LAMB and ``--clip-norm``
(the trust ratios and the clip's norm are those of the whole stacked
leaves, gathered over the stage group, as JAX's optimizers see them;
per-slice statistics would train, but away from JAX), ``-p 3`` snapped
to 2 with JAX's log line, a run with step checkpoints cut after step 4
and resumed bit-identically, ``--elastic`` with a failure injected after
step 3 on every rank (bit-identical to the clean run), a grid resuming
a one-process checkpoint and, after the ranks, one process resuming the
grid's, each within 1e-5 of the grid's uninterrupted epoch 2.  The stage
counts JAX refuses are refused with its messages; the flags it drops
(``--zero``/``--mesh`` under ``-m pipeline``) are refused saying why."""

import contextlib
import io
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from test_torch_pipeline_cli import pipelined_init
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
LIMIT = "96"
GRID = ["-m", "pipeline", "--nstages", "2", "-r", "4", "-d", "cpu", "-s",
        "32", "-l", "4", "-b", "8", "-p", "4", "-e", "1"]
ONE = GRID[:4] + GRID[6:]              # the same run as one process
JAX_CASES = {
    "gpt_1f1b": ("gpt", ["--pipeline-schedule", "1f1b"]),
    "bert_gpipe": ("bert", []),
    "gpt_interleaved_lamb_clip": ("gpt", [
        "--pipeline-schedule", "interleaved", "--virtual-stages", "2",
        "--optimizer", "lamb", "--lr", "1e-2", "--clip-norm", "0.05"]),
    "gpt_snap": ("gpt", ["--pipeline-schedule", "1f1b", "-p", "3"]),
}
REFUSED = {
    "nstages_3": ["--nstages", "3"],
    "nstages_8": ["--nstages", "8"],
}

#: one rank running every case on one gloo process group
CLI_RANK = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils import failures
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    whole_state_dict
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec

rank, world, port, blob = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
out = {}
for name, case in torch.load(blob).items():
    prune = case.get("prune")
    if prune and rank == 0:
        directory, last = prune
        for f in os.listdir(directory):
            stem = f.split(".")[0]
            if "-" in stem and stem.split("-")[-1].isdigit() and \
                    int(stem.split("-")[-1]) > last:
                os.remove(os.path.join(directory, f))
    os.environ.pop("DDL_INJECT_STEP_FAILURE", None)
    os.environ.update(case.get("env", {}))
    failures._step_injected = False
    dist.barrier()
    log = io.StringIO()
    try:
        cfg = tconfig.parse_args(case["argv"], case["workload"])
        with contextlib.redirect_stdout(log):
            state, hist = tbase.run_workload(get_spec(case["workload"]),
                                             cfg,
                                             init_state_dict=case.get("init"))
    except ValueError as e:
        out[name] = {"error": str(e)}
        continue
    out[name] = {
        "hist": [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist],
        "log": log.getvalue(),
        "params": whole_state_dict(state.model)}
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def run_cli_ranks(world: int, cases: dict, tmp: Path) -> list:
    blob = tmp / "cases.pt"
    torch.save(cases, blob)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DDL_DATA_LIMIT=LIMIT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_RANK, str(r), str(world), port,
         str(blob)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(world)], outs


@contextlib.contextmanager
def _jax_on_four_devices():
    """The JAX runner's devices cut to four, so its ``-m pipeline --nstages
    2`` is the 2 x 2 grid."""
    real, before = jbase._devices, os.environ.get("DDL_DATA_LIMIT")
    jbase._devices = lambda config: jax.devices("cpu")[:4]
    os.environ["DDL_DATA_LIMIT"] = LIMIT
    try:
        yield
    finally:
        jbase._devices = real
        if before is None:
            del os.environ["DDL_DATA_LIMIT"]
        else:
            os.environ["DDL_DATA_LIMIT"] = before


def _jax_cli(workload, argv):
    log = io.StringIO()
    with _jax_on_four_devices():
        try:
            with contextlib.redirect_stdout(log):
                _, hist = jbase.run_workload(
                    jget(workload), jconfig.parse_args(argv, workload))
        except ValueError as e:
            return {"error": str(e)}
    return {"hist": [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist],
            "log": log.getvalue()}


def _one_process(argv, workload="gpt", init=None):
    """The port's one-process ``-m pipeline`` run of ``argv``."""
    log = io.StringIO()
    before = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = LIMIT
    try:
        with contextlib.redirect_stdout(log):
            state, hist = tbase.run_workload(
                tget(workload), tconfig.parse_args(argv, workload),
                init_state_dict=init)
    finally:
        if before is None:
            del os.environ["DDL_DATA_LIMIT"]
        else:
            os.environ["DDL_DATA_LIMIT"] = before
    return [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist], \
        log.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    cases, jax_args = {}, {}
    for name, (workload, flags) in JAX_CASES.items():
        argv = GRID + flags
        jax_args[name] = (workload, argv)
        cases[name] = {"workload": workload, "argv": argv,
                       "init": pipelined_init(workload, argv)}
    init = cases["gpt_1f1b"]["init"]
    ck = GRID + ["--pipeline-schedule", "1f1b", "--checkpoint-every", "2"]
    cases["ckpt_whole"] = {"workload": "gpt", "init": init,
                           "argv": ck + ["--checkpoint-dir",
                                         str(tmp / "whole")]}
    shutil.rmtree(tmp / "cut", ignore_errors=True)
    cases["ckpt_run"] = {"workload": "gpt", "init": init,
                         "argv": ck + ["--checkpoint-dir", str(tmp / "cut")]}
    # eight steps: saves at 2, 4, 6 and 8, the newest three kept
    cases["ckpt_resumed"] = {"workload": "gpt", "prune": (str(tmp / "cut"),
                                                          4),
                             "argv": ck + ["--checkpoint-dir",
                                           str(tmp / "cut"), "--resume"]}
    cases["elastic"] = {"workload": "gpt", "init": init,
                        "env": {"DDL_INJECT_STEP_FAILURE": "all:3"},
                        "argv": ck + ["--checkpoint-dir", str(tmp / "el"),
                                      "--elastic"]}
    two = GRID[:-1] + ["2", "--pipeline-schedule", "1f1b"]
    cases["grid_e2"] = {"workload": "gpt", "init": init, "argv": two}
    cases["grid_e1_save"] = {"workload": "gpt", "init": init,
                             "argv": GRID + ["--pipeline-schedule", "1f1b",
                                             "--checkpoint-dir",
                                             str(tmp / "g1")]}
    # a one-process checkpoint of epoch 1, resumed by the grid
    one = ONE + ["--pipeline-schedule", "1f1b", "--checkpoint-dir",
                 str(tmp / "w1")]
    _one_process(one, init=init)
    cases["grid_from_one"] = {"workload": "gpt", "argv": two + [
        "--checkpoint-dir", str(tmp / "w1"), "--resume"]}
    for name, flags in REFUSED.items():
        cases[name] = {"workload": "gpt", "argv": GRID + flags}
        jax_args[name] = ("gpt", GRID + flags)
    cases["zero"] = {"workload": "gpt", "argv": GRID + ["--zero", "1"]}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 4, cases, tmp)
        want = {name: _jax_cli(*args) for name, args in jax_args.items()}
        ranks, outs = ranks.result()
    # the grid's epoch-1 checkpoint, resumed by one process
    shutil.copytree(tmp / "g1", tmp / "g1_one")
    from_grid = _one_process(ONE[:-1] + ["2", "--pipeline-schedule", "1f1b",
                                         "--checkpoint-dir",
                                         str(tmp / "g1_one"), "--resume"])
    return ranks, want, from_grid, outs


def _check(got, want, name, rtol=1e-5):
    assert [(p, e) for p, e, _, _ in got] == [(p, e) for p, e, _, _ in want]
    for (phase, _, acc, loss), (_, _, jacc, jloss) in zip(got, want):
        np.testing.assert_allclose(loss, jloss, rtol=rtol, atol=1e-9,
                                   err_msg=f"{name} {phase}")
        assert abs(acc - jacc) <= 1e-6, (name, phase, acc, jacc)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_grid_history_matches_jax(runs, name):
    ranks, want, _, _ = runs
    _check(ranks[0][name]["hist"], want[name]["hist"], name)
    assert "SPMD pipeline: 2 stages x 2-way data parallel" in \
        want[name]["log"]
    assert "SPMD pipeline: 2 stages x 2-way data parallel" in \
        ranks[0][name]["log"]
    for r in ranks[1:]:
        assert r[name]["hist"] == ranks[0][name]["hist"]
        for k, v in r[name]["params"].items():
            torch.testing.assert_close(v, ranks[0][name]["params"][k],
                                       rtol=0, atol=0)


def test_snapped_microbatch_logs_as_jax(runs):
    ranks, want, _, _ = runs
    line = "microbatch 3 incompatible with batch 8 / dp 2; using 2"
    assert line in want["gpt_snap"]["log"]
    assert line in ranks[0]["gpt_snap"]["log"]
    assert tbase.snap_microbatch(8, 3, 2) == 2
    assert tbase.snap_microbatch(8, 5, 2) == 4
    assert tbase.snap_microbatch(8, None, 2) == 2


def test_resume_and_elastic_are_bit_identical(runs):
    ranks, _, _, outs = runs
    whole = ranks[0]["ckpt_whole"]
    for name in ("ckpt_resumed", "elastic"):
        got = ranks[0][name]
        assert got["hist"][-2:] == whole["hist"][-2:], name
        for k, v in whole["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=0, atol=0,
                                       msg=f"{name} {k}")
    assert "resumed mid-epoch 1 at step 4" in ranks[0]["ckpt_resumed"]["log"]
    log = ranks[0]["elastic"]["log"]
    assert "recovering from failure (RuntimeError: injected failure" in log
    assert "restart 1/2 from epoch 1 step 2" in log
    assert all(o.count("CHAOS: injected failure") == 1 for o in outs)


def test_checkpoints_cross_between_grid_and_one_process(runs):
    ranks, _, from_grid, _ = runs
    want = ranks[0]["grid_e2"]["hist"]
    got = ranks[0]["grid_from_one"]
    assert "resumed from epoch 1" in got["log"]
    _check(got["hist"], want[2:], "grid from one process")
    hist, log = from_grid
    assert "resumed from epoch 1" in log
    _check(hist, want[2:], "one process from the grid")


def test_refusals(runs):
    ranks, want, _, _ = runs
    for name in REFUSED:
        assert all(r[name] == want[name] for r in ranks), name
        assert want[name]["error"].startswith("--nstages")
    msg = ranks[0]["zero"]["error"]
    assert msg.startswith("--zero under -m pipeline: the SPMD pipeline")
    with pytest.raises(ValueError, match="--mesh under -m model"):
        tbase.run_workload(tget("mlp"), tconfig.parse_args(
            ["-m", "model", "--mesh", "data=1", "-d", "cpu"], "mlp"))
