"""``--zero 1`` and ``--zero fsdp`` through the port's CLI on two spawned
gloo ranks, against the JAX CLI's ``-m data -r 2`` with the same flags on
its 8-device CPU mesh, from the JAX init: rank 0's phase history within
1e-5 relative (losses) with AdamW, LAMB and Adafactor, with and without
``--clip-norm``, on ``gpt`` and ``mlp``.  The same ranks show what a rank
holds (about half of ``-m data``'s optimizer state under ZeRO-1, and half
of the parameters too under FSDP) and that a ``--zero 1`` or ``--zero
fsdp`` checkpoint resumes mid-epoch bit-identically.  Every case runs in one spawn, each
rank running the cases one after another on one process group
(:func:`run_cli_ranks`)."""

import contextlib
import io
import json
import os
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
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240.0
GPT = ["-l", "2", "-s", "64", "-e", "1", "-b", "8", "-d", "cpu"]
#: wide enough that Adafactor factors the MLP kernels (128 x 512)
GPT_WIDE = ["-l", "1", "-s", "128", "-e", "1", "-b", "8", "-d", "cpu"]
MLP = ["-l", "2", "-s", "16", "-e", "1", "-b", "16", "-d", "cpu"]
LIMIT = "64"

#: one rank running a list of CLI cases on one gloo process group: each
#: case's history and log, the bytes of optimizer state and of parameters
#: this rank holds, and the whole final parameters; a case may first drop
#: the checkpoints of a directory after a step (an interrupted run)
CLI_RANK = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.parallel.shards import local
from distributed_deep_learning_tpu_torch.parallel.zero import (
    optimizer_state_bytes, param_bytes)
from distributed_deep_learning_tpu_torch.utils import config as tconfig
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
    dist.barrier()
    cfg = tconfig.parse_args(case["argv"], case["workload"])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        state, hist = tbase.run_workload(get_spec(case["workload"]), cfg,
                                         init_state_dict=case.get("init"))
    sys.stdout.write(log.getvalue())
    out[name] = {
        "hist": [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist],
        "log": log.getvalue(),
        "opt_bytes": optimizer_state_bytes(state.optimizer),
        "param_bytes": param_bytes(state.model),
        "params": whole_state_dict(state.model),
        "local": {k: local(v).detach().clone()
                  for k, v in state.model.state_dict().items()},
        "residual": {k: v.detach().clone() for k, v in
                     (state.comm_residual or {}).items()}}
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def run_cli_ranks(world: int, cases: dict, tmp: Path, limit: str = LIMIT):
    """Run ``cases`` (name -> {"workload", "argv", "init"?, "prune"?}) on
    ``world`` spawned gloo ranks; returns each rank's results."""
    blob = tmp / "cases.pt"
    torch.save(cases, blob)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               DDL_DATA_LIMIT=limit)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_RANK, str(r), str(world), port,
         str(blob)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(world)]


def jax_init(workload: str, argv: list) -> dict:
    """The JAX CLI's initial parameters as the port's state dict."""
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    variables = jspec.build_model(jcfg, dataset).init(
        jax.random.key(jcfg.seed), jspec.example_input(jcfg, dataset))
    variables = jax.tree.map(np.asarray, dict(variables))
    if workload == "mlp":
        return tmlp.load_flax_variables(variables)
    return load_flax_params(variables)


def jax_history(workload: str, argv: list, limit: str = LIMIT):
    """The JAX CLI's phase history of ``argv`` and its log."""
    before = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = limit
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            _, hist = jbase.run_workload(
                jget(workload), jconfig.parse_args(argv, workload=workload))
    finally:
        if before is None:
            del os.environ["DDL_DATA_LIMIT"]
        else:
            os.environ["DDL_DATA_LIMIT"] = before
    return [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist], \
        log.getvalue()


def check_history(got: list, want: list, name: str, rtol: float = 1e-5):
    assert [(p, e) for p, e, _, _ in got] == [(p, e) for p, e, _, _ in want]
    for (phase, _, acc, loss), (_, _, jacc, jloss) in zip(got, want):
        np.testing.assert_allclose(loss, jloss, rtol=rtol, atol=1e-9,
                                   err_msg=f"{name} {phase}")
        assert abs(acc - jacc) <= 1e-6, (name, phase, acc, jacc)


#: case -> (workload, flags); each against the JAX CLI's -m data -r 2
JAX_CASES = {
    "gpt_zero1": ("gpt", GPT, ["--zero", "1"]),
    "gpt_fsdp": ("gpt", GPT, ["--zero", "fsdp"]),
    "gpt_fsdp_lamb": ("gpt", GPT, ["--zero", "fsdp", "--optimizer", "lamb",
                                   "--lr", "1e-2"]),
    "gpt_fsdp_adafactor": ("gpt", GPT_WIDE, ["--zero", "fsdp", "--optimizer",
                                        "adafactor", "--lr", "1e-2"]),
    "gpt_fsdp_clip": ("gpt", GPT, ["--zero", "fsdp", "--clip-norm",
                                   "0.05"]),
    "gpt_zero1_clip": ("gpt", GPT, ["--zero", "1", "--clip-norm", "0.05"]),
    "mlp_zero1": ("mlp", MLP, ["--zero", "1"]),
    "mlp_fsdp": ("mlp", MLP, ["--zero", "fsdp"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks, beside the JAX CLI's histories."""
    tmp = tmp_path_factory.mktemp("zero")
    cases = {}
    for name, (workload, base, flags) in JAX_CASES.items():
        argv = ["-m", "data", "-r", "2", *base, *flags]
        cases[name] = {"workload": workload, "argv": argv,
                       "init": jax_init(workload, argv)}
    plain = ["-m", "data", "-r", "2", *GPT]
    cases["gpt_data"] = {"workload": "gpt", "argv": plain,
                         "init": cases["gpt_fsdp"]["init"]}
    cases["data_ckpt"] = {"workload": "gpt", "argv": plain + [
        "--dropout", "0.1", "--checkpoint-dir", str(tmp / "resume-none"),
        "--checkpoint-every", "1"]}
    # a mid-epoch resume: the run, then again from its step-2 checkpoint
    for zero in ("1", "fsdp"):
        ckdir = str(tmp / f"resume-{zero}")
        resume = plain + ["--zero", zero, "--dropout", "0.1",
                          "--checkpoint-dir", ckdir, "--checkpoint-every",
                          "1"]
        cases[f"{zero}_whole"] = {"workload": "gpt", "argv": resume}
        cases[f"{zero}_resumed"] = {"workload": "gpt",
                                    "argv": resume + ["--resume"],
                                    "prune": (ckdir, 2)}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 2, cases, tmp)
        want = {name: jax_history(workload, cases[name]["argv"])[0]
                for name, (workload, _, _) in JAX_CASES.items()}
        return ranks.result(), want, tmp


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_history_matches_jax_cli(name, runs):
    ranks, want, _ = runs
    check_history(ranks[0][name]["hist"], want[name], name)
    # every rank ends with the same whole parameters
    for k, v in ranks[0][name]["params"].items():
        torch.testing.assert_close(ranks[1][name]["params"][k], v, rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("zero", ["1", "fsdp"])
def test_a_rank_holds_half_of_the_state(zero, runs):
    ranks, _, _ = runs
    full = ranks[0]["gpt_data"]
    for r in ranks:
        mine = r[f"gpt_{'zero1' if zero == '1' else 'fsdp'}"]
        # ZeRO-1 splits whole parameters, FSDP dim 0 (uneven at the
        # biases): within a few percent of half either way
        assert abs(mine["opt_bytes"] / full["opt_bytes"] - 0.5) < 0.05, \
            (mine["opt_bytes"], full["opt_bytes"])
        share = mine["param_bytes"] / full["param_bytes"]
        assert (abs(share - 0.5) < 0.05) if zero == "fsdp" else share == 1
    # the same model either way
    for k, v in full["params"].items():
        torch.testing.assert_close(ranks[0]["gpt_fsdp"]["params"][k], v,
                                   rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("zero", ["1", "fsdp"])
def test_mid_epoch_resume_is_bit_identical(zero, runs):
    ranks, _, _ = runs
    for r in ranks:
        whole, resumed = r[f"{zero}_whole"], r[f"{zero}_resumed"]
        assert resumed["hist"] == whole["hist"]
        for k, v in whole["params"].items():
            torch.testing.assert_close(resumed["params"][k], v, rtol=0,
                                       atol=0, msg=k)


def test_sharded_checkpoints_hold_the_leaves_of_data_parallel(runs):
    """A ``--zero 1`` or ``--zero fsdp`` checkpoint is saved whole: the
    manifest lists the leaves, shapes and dtypes of a ``-m data`` one,
    and records the run's topology: the mesh, the rank count and each
    leaf's split (``reshard.manifest``)."""
    _, _, tmp = runs

    def manifest(zero):
        last = max(tmp.glob(f"resume-{zero}/manifest-*.json"),
                   key=lambda p: int(p.stem.split("-")[1]))
        return json.loads(last.read_text())

    plain = manifest("none")
    for zero in ("1", "fsdp"):
        mine = manifest(zero)
        assert {k: (v.get("shape"), v.get("dtype")) for k, v in
                mine["leaves"].items()} == \
            {k: (v.get("shape"), v.get("dtype"))
             for k, v in plain["leaves"].items()}
        topo = mine["topology"]          # reshard.manifest.Topology's
        assert (topo["format"], topo["n_devices"]) == (1, 2)
        assert topo["mesh"]["data"] == 2
        specs = topo["leaf_specs"]
        params = [k for k in specs if k.startswith("/params/")]
        if zero == "1":                  # each leaf's moments on one rank
            assert specs["/optimizer/state/0"] == ["@data"]
            assert all(specs[k] == [] for k in params)
        else:                            # FSDP2's Shard(0) over data
            assert specs["/optimizer/state/0"] == specs[params[0]]
            assert {tuple(specs[k]) for k in params} == {("data",)}
