"""``--autotune`` and ``--plan`` through the port's runner, on the CPU.

* ``mlp -m data --autotune --plan P`` at world 1, then ``--plan P``: the
  replay trains the searched plan, so the final loss and accuracy are
  bit-identical, and the artifact's hash round-trips (JAX's
  ``tests/test_tune.py:360-377``).
* The same search over two gloo ranks in lockstep: both ranks take the
  same decisions (their deterministic records, rank 0's rates, are
  equal), and through the CLI rank 0 writes the artifact and the replay
  applies it on both ranks.
* Out-of-memory errors on rank 1 only, raised by an ``oom_hook``, by the
  model's build, and by the model's forward in the trial's first step:
  both ranks mark those plans infeasible with rank 1's error and go on,
  with no hang (each rank runs under a timeout).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_deep_learning_tpu_torch import tune as ttune
from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from distributed_deep_learning_tpu_torch.utils.config import parse_args
from distributed_deep_learning_tpu_torch.workloads import get_spec
from distributed_deep_learning_tpu_torch.workloads.base import run_workload
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
ARGV = ["-e", "1", "-b", "32", "-m", "data", "-d", "cpu"]
RANK_TIMEOUT = 240

#: one gloo rank of a lockstep search: argv rank world port out
RANK = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from distributed_deep_learning_tpu_torch.models.mlp import MLP
from distributed_deep_learning_tpu_torch.tune import plan_hash, run_search
from distributed_deep_learning_tpu_torch.utils.config import parse_args
from distributed_deep_learning_tpu_torch.workloads import get_spec

# rank 1 runs out of memory: in the hook under remat dots, in the
# model's build under dots_no_batch, in the forward under nothing
def oom_hook(plan):
    if rank == 1 and plan.remat_policy == "dots":
        raise RuntimeError("RESOURCE_EXHAUSTED: rank 1 only")

spec = get_spec("mlp")

def build_model(config, dataset):
    if rank == 1 and config.remat and config.remat_policy == "dots_no_batch":
        raise torch.cuda.OutOfMemoryError("CUDA out of memory: rank 1 "
                                          "only, building")
    return spec.build_model(config, dataset)

forward = MLP.forward

def oom_forward(self, x, generator=None, remat=None):
    if rank == 1 and remat == "nothing":
        raise torch.cuda.OutOfMemoryError("CUDA out of memory: rank 1 "
                                          "only, forward")
    return forward(self, x, generator, remat)

MLP.forward = oom_forward
cfg = parse_args(["-b", "32", "-m", "data", "-d", "cpu"], "mlp")
result = run_search(dataclasses.replace(spec, build_model=build_model), cfg,
                    trial_steps=2, warmup=1, max_trials=None,
                    oom_hook=oom_hook,
                    space_options=dict(grad_accum_options=(1,),
                                       zero_options=("none",),
                                       compress_options=("none",)))
json.dump({"best": plan_hash(result.best), "groups": len(
    dist.distributed_c10d._world.pg_map),
           "record": result.record(deterministic_only=True)},
          open(f"{out}.{rank}", "w"))
dist.destroy_process_group()
"""


def test_autotune_then_plan_replay_bit_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "512")
    path = str(tmp_path / "mlp.plan.json")
    spec = get_spec("mlp")
    cfg1 = parse_args(ARGV + ["--autotune", "--plan", path], "mlp")
    _, hist1 = run_workload(spec, cfg1)
    assert os.path.exists(path)
    cfg2 = parse_args(ARGV + ["--plan", path], "mlp")
    _, hist2 = run_workload(spec, cfg2)
    # the replayed run IS the searched plan's run: bit-identical training
    assert hist1[-1].loss == hist2[-1].loss
    assert hist1[-1].accuracy == hist2[-1].accuracy
    plan, record = ttune.load_plan(path)
    assert record["plan_hash"] == ttune.plan_hash(plan)
    assert ttune.plan_from_config(ttune.apply_plan(cfg2, plan), 1) == plan
    assert record["search"]["n_devices"] == 1 and record["search"]["trials"]


def test_two_rank_search_in_lockstep_survives_a_one_rank_oom(tmp_path):
    port, out = str(free_port()), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", port, out], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    a, b = (json.load(open(f"{out}.{r}")) for r in range(2))
    assert a["best"] == b["best"] and a["record"] == b["record"]
    trials = a["record"]["trials"]

    def fault(plan):
        if plan["remat"] and plan["remat_policy"] == "dots_no_batch":
            return "OutOfMemoryError: CUDA out of memory: rank 1 only, " \
                "building"
        if plan["remat"] and plan["remat_policy"] == "nothing":
            return "OutOfMemoryError: CUDA out of memory: rank 1 only, " \
                "forward"
        if plan["remat"] and plan["remat_policy"] == "dots":
            return "RuntimeError: RESOURCE_EXHAUSTED: rank 1 only"
        return None

    faults = {fault(t["plan"]) for t in trials}
    assert len(faults) == 4      # each fault was met, and a feasible plan
    for t in trials:
        assert t["infeasible"] == t["oom"] == (fault(t["plan"]) is not None)
        assert t["error"] == fault(t["plan"]), t
    # the trials' DeviceMesh groups went with them: the default group
    # is all that is left
    assert a["groups"] == b["groups"] == 1


def test_two_rank_autotune_cli_writes_one_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "256")
    path = str(tmp_path / "two.plan.json")
    argv = ["mlp", "-r", "2"] + ARGV + ["--autotune", "--plan", path]
    searched = launch_local(2, argv, device="cpu", timeout=RANK_TIMEOUT)
    plan, record = ttune.load_plan(path)
    line = f"autotune: best plan {record['plan_hash']}"
    assert line in searched[0].stdout and line not in searched[1].stdout
    assert record["topology"]["n_devices"] == 2
    replay = launch_local(2, ["mlp", "-r", "2"] + ARGV + ["--plan", path],
                          device="cpu", timeout=RANK_TIMEOUT)
    assert f"plan {record['plan_hash']} [{plan.describe()}] applied" in \
        replay[0].stdout
    loss = [ln for ln in searched[0].stdout.splitlines()
            if "train epoch 1 ends" in ln]
    again = [ln for ln in replay[0].stdout.splitlines()
             if "train epoch 1 ends" in ln]
    assert [ln.split(" with ")[1] for ln in loss] == \
        [ln.split(" with ")[1] for ln in again]
