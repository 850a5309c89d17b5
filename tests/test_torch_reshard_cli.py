"""``--reshard`` and ``--target-mesh`` through the port's CLI, on gloo
ranks, against the JAX CLI; and the shrink drill.

* ``mlp -m data --zero 1`` on 4 ranks (from the JAX init) saves epoch 1;
  ``-r 3 --reshard --resume -e 2`` re-plans onto a ``data=3`` mesh and
  continues: its epoch-2 loss equals the JAX CLI's for the same 4 → 3
  sequence (JAX on 4, then 3 CPU devices) within 1e-5, and both re-plan
  lines name the same plan hash.
* ``-r 2 --reshard --resume --target-mesh fsdp=2 --zero fsdp`` restores
  the same checkpoint onto FSDP2 without re-planning; the same global
  batches give the same epoch-2 loss.
* The step-down: ``-r 3`` at a batch that only 2 ranks divide re-plans
  onto 2; rank 2 sits out and exits 0.
* JAX's five parse refusals, with its messages.
* ``run_shrink_drill(n_devices=4, kill=1)`` at a small size passes, with
  JAX's killed ranks, survivors and plan hash.
"""

import contextlib
import io
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from distributed_deep_learning_tpu.reshard import replan as jreplan
from distributed_deep_learning_tpu.tune import plan_hash as jplan_hash
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.reshard.drill import \
    run_shrink_drill
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import Checkpointer
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

LIMIT = "256"
BASE = ["-m", "data", "--zero", "1", "-b", "48", "-d", "cpu"]
TIMEOUT = 300
_PLAN = re.compile(r"reshard: re-planned for (\d+) device\(s\): (.*) "
                   r"\(([0-9a-f]{16})\)")
_EPOCH = re.compile(r'"train epoch (\d+) ends at \S+ with accuracy \S+ and '
                    r'loss (\S+)"')


def _loss(out: str, epoch: int) -> float:
    return next(float(m.group(2)) for m in _EPOCH.finditer(out)
                if int(m.group(1)) == epoch)


def _jax_init(argv):
    cfg = jconfig.parse_args(argv, workload="mlp")
    spec = jget("mlp")
    dataset = spec.build_dataset(cfg)
    variables = spec.build_model(cfg, dataset).init(
        jax.random.key(cfg.seed), spec.example_input(cfg, dataset))
    return tmlp.load_flax_variables(jax.tree.map(np.asarray,
                                                 dict(variables)))


def _seed_checkpoint(directory, argv, state_dict):
    """The JAX init as the port's step-0 checkpoint (no topology: it
    restores onto any layout), so spawned ranks start from it."""
    cfg = tconfig.parse_args(argv + ["-d", "cpu"], workload="mlp")
    spec = tget("mlp")
    state = create_train_state(spec.build_model(cfg, spec.build_dataset(cfg)),
                               cfg.seed, tbase.build_optimizer(spec, cfg, 1),
                               state_dict, device="cpu")
    Checkpointer(directory).save(0, state, extra={
        "epoch": 0, "batch": 0, "epoch_complete": True})


def _jax_run(argv, n_devices, monkeypatch):
    """The JAX CLI on the first ``n_devices`` CPU devices; its log."""
    monkeypatch.setattr(jbase, "_devices",
                        lambda config: jax.devices()[:n_devices])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        jbase.run_workload(jget("mlp"), jconfig.parse_args(argv, "mlp"))
    return log.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4-rank epoch 1, then its three continuations at once;
    the JAX CLI's 4 → 3 sequence meanwhile."""
    tmp = tmp_path_factory.mktemp("reshard")
    before = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = LIMIT
    mp = pytest.MonkeyPatch()
    try:
        seed = str(tmp / "seed")
        _seed_checkpoint(seed, BASE[:-2], _jax_init(BASE[:-2]))
        first = BASE + ["-r", "4", "-e", "1", "--checkpoint-dir", seed,
                        "--resume"]
        launch_local(4, ["mlp", *first], device="cpu", timeout=TIMEOUT)
        legs = {
            "3": ["-r", "3"],
            "fsdp": ["-r", "2", "--target-mesh", "fsdp=2", "--zero",
                     "fsdp"],
            "down": ["-r", "3", "-b", "32"]}
        ranks = {"3": 3, "fsdp": 2, "down": 3}
        with ThreadPoolExecutor(len(legs)) as pool:
            futures = {}
            for name, flags in legs.items():
                d = str(tmp / name)
                shutil.copytree(seed, d)
                futures[name] = pool.submit(
                    launch_local, ranks[name],
                    ["mlp", *BASE, "-e", "2", "--checkpoint-dir", d,
                     "--reshard", "--resume", *flags],
                    device="cpu", timeout=TIMEOUT)
            jdir = str(tmp / "jax")
            jfirst = _jax_run(BASE[:-2] + ["-r", "4", "-e", "1",
                                           "--checkpoint-dir", jdir], 4, mp)
            jsecond = _jax_run(BASE[:-2] + ["-r", "3", "-e", "2",
                                            "--checkpoint-dir", jdir,
                                            "--reshard", "--resume"], 3, mp)
            port = {name: f.result() for name, f in futures.items()}
        return port, jfirst, jsecond
    finally:
        mp.undo()
        if before is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
        else:
            os.environ["DDL_DATA_LIMIT"] = before


def test_four_to_three_matches_the_jax_cli(runs):
    port, _, jsecond = runs
    out = port["3"][0].stdout
    mine, theirs = _PLAN.search(out), _PLAN.search(jsecond)
    assert mine and theirs
    assert mine.groups() == theirs.groups() == \
        ("3", "mesh[data=3] zero=1 float32", mine.group(3))
    assert "via chunked" in out
    np.testing.assert_allclose(_loss(out, 2), _loss(jsecond, 2), rtol=1e-5)


def test_target_mesh_restores_onto_fsdp(runs):
    port, _, jsecond = runs
    out = port["fsdp"][0].stdout
    assert "explicit --target-mesh {'fsdp': 2}; skipping re-plan" in out
    assert "mesh[data=4]x4dev -> mesh[fsdp=2]x2dev] via chunked" in out
    np.testing.assert_allclose(_loss(out, 2), _loss(jsecond, 2), rtol=1e-5)


def test_step_down_leaves_a_rank_out(runs):
    port, _, _ = runs
    outs = [r.stdout for r in port["down"]]
    assert "re-planned for 3 device(s): mesh[data=2] zero=1" in outs[0]
    assert "takes 2 of the 3 launched ranks; ranks 2-2 sit out" in outs[0]
    assert "rank 2 sits out" in outs[2] and "train epoch" not in outs[2]
    assert all(r.returncode == 0 for r in port["down"])
    assert _loss(outs[0], 2) > 0


@pytest.mark.parametrize("argv", [
    ["--reshard", "--checkpoint-dir", "d"],
    ["--reshard", "--resume"],
    ["--target-mesh", "data=4"],
    ["--reshard", "--resume", "--checkpoint-dir", "d", "--target-mesh",
     "bogus=4"],
    ["--plan", "no-such.plan.json"]])
def test_parse_refusals_are_jaxs(argv):
    with pytest.raises(SystemExit) as theirs:
        jconfig.parse_args(argv, "mlp")
    with pytest.raises(SystemExit) as mine:
        tconfig.parse_args(argv, "mlp")
    assert str(mine.value) == str(theirs.value)


def test_shrink_drill_passes_with_jaxs_choices():
    record = run_shrink_drill(n_devices=4, kill=1, rows=256, hidden=64)
    assert record["drill_passed"], record
    survivors, dead = jchaos.ChaosPlan.shrink_topology(range(4), kill=1,
                                                       seed=0)
    plan = jreplan.choose_plan(
        len(survivors), 96, space_options={
            "dtypes": ("float32",), "grad_accum_options": (1,),
            "attention_options": ("auto",), "zero_options": ("1",),
            "compress_options": ("none",)})
    assert record["killed"] == dead
    assert record["survivors"] == len(survivors)
    assert record["plan_hash"] == jplan_hash(plan)
    assert record["non_power_of_two"] and record["restore_mode"] == \
        "chunked"
