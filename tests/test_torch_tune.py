"""The port's tuner (``tune/``) against the JAX package's, on the CPU.

For the same inputs each of these equals JAX's: the plan lattice (counts
and plans) for several ``(devices, batch)`` pairs, each plan's
``to_dict`` and ``plan_hash``, ``estimate_memory`` and ``prune_plans``,
``model_geometry`` of ``mlp`` and a small ``gpt`` (the port's from the
model on the ``meta`` device), ``plan_key`` on the CPU, an artifact's
round trip and its refusals (messages included), ``run_search`` under an
injected ``measure`` (its deterministic record; a fake OOM through
``oom_hook``; the all-pruned and all-infeasible errors) and
``run_calibration`` under an injected runner (its record).  One real
``TrialHarness`` trial of ``mlp`` runs at world 1 and records its cost.
"""

import dataclasses
import json

import jax
import pytest
import torch
import torch.distributed as dist

from distributed_deep_learning_tpu import tune as jtune
from distributed_deep_learning_tpu.tune import calibrate as jcal
from distributed_deep_learning_tpu.tune import search as jsearch
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import get_spec as jspec
from distributed_deep_learning_tpu_torch import tune as ttune
from distributed_deep_learning_tpu_torch.tune import calibrate as tcal
from distributed_deep_learning_tpu_torch.tune import search as tsearch
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import get_spec as tspec
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

GEOM = dict(param_count=1_000_000, num_layers=4,
            layer_act_elems_per_example=4096,
            extra_act_elems_per_example=1024)
PAIRS = [(1, 32), (2, 32), (4, 96), (6, 64), (8, 96), (8, 64)]
CPU8 = [torch.device("cpu")] * 8


def _plans(mod, n, b, **kw):
    return [p.to_dict() for p in mod.enumerate_plans(n, b, **kw)]


@pytest.mark.parametrize("n,batch", PAIRS)
def test_lattice_equals_jax(n, batch):
    mine, theirs = _plans(ttune, n, batch), _plans(jtune, n, batch)
    assert len(mine) == len(theirs) and mine == theirs
    opts = dict(dtypes=("float32", "bfloat16"), grad_accum_options=(1,),
                paged_options=(False, True),
                kv_dtype_options=("none", "int8"))
    assert _plans(ttune, n, batch, **opts) == _plans(jtune, n, batch, **opts)


def test_plan_dicts_hashes_and_overrides_equal_jax():
    jplans, tplans = jtune.enumerate_plans(8, 96), \
        ttune.enumerate_plans(8, 96)
    assert [jtune.plan_hash(p) for p in jplans] == \
        [ttune.plan_hash(p) for p in tplans]
    assert [p.describe() for p in jplans] == [p.describe() for p in tplans]
    for jp, tp in zip(jplans[::17], tplans[::17]):
        assert ttune.Plan.from_dict(jp.to_dict()) == tp
        mine = {k: str(v) for k, v in tp.to_overrides().items()}
        assert mine == {k: str(v) for k, v in jp.to_overrides().items()}
    argv = ["-b", "32", "-m", "data", "--zero", "1", "--remat"]
    assert ttune.plan_from_config(tconfig.parse_args(argv, "mlp"), 4) \
        .to_dict() == jtune.plan_from_config(
            jconfig.parse_args(argv, "mlp"), 4).to_dict()


@pytest.mark.parametrize("budget", [None, 2 ** 22, 2 ** 24, 1])
def test_memory_estimates_and_pruning_equal_jax(budget):
    jg, tg = jtune.ModelGeometry(**GEOM), ttune.ModelGeometry(**GEOM)
    for jp, tp in zip(jtune.enumerate_plans(4, 64),
                      ttune.enumerate_plans(4, 64)):
        assert ttune.estimate_memory(tp, tg, 64).to_dict() == \
            jtune.estimate_memory(jp, jg, 64).to_dict()
    jf, jr = jtune.prune_plans(jtune.enumerate_plans(4, 64), jg, 64, budget)
    tf, tr = ttune.prune_plans(ttune.enumerate_plans(4, 64), tg, 64, budget)
    assert [p.to_dict() for p in tf] == [p.to_dict() for p in jf]
    assert [(p.to_dict(), e.to_dict()) for p, e in tr] == \
        [(p.to_dict(), e.to_dict()) for p, e in jr]
    assert ttune.hbm_budget([torch.device("cpu")]) is None
    assert ttune.hbm_budget([torch.device("cpu")], override=7) == 7


@pytest.mark.parametrize("workload,argv", [
    ("mlp", ["-b", "32"]),
    ("gpt", ["-b", "8", "-l", "2", "-s", "64", "--optimizer", "lamb"])])
def test_model_geometry_equals_jax(workload, argv):
    jcfg, tcfg = jconfig.parse_args(argv, workload), \
        tconfig.parse_args(argv + ["-d", "cpu"], workload)
    js, ts = jspec(workload), tspec(workload)
    mine = tsearch.model_geometry(ts, tcfg, ts.build_dataset(tcfg))
    theirs = jsearch.model_geometry(js, jcfg, js.build_dataset(jcfg))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_plan_key_equals_jax_on_the_cpu():
    from distributed_deep_learning_tpu_torch.tune.trial import \
        device_identity

    argv = ["-b", "32", "-l", "2", "-s", "16"]
    d = jax.devices()[0]
    assert device_identity([torch.device("cpu")]) == (d.platform,
                                                       d.device_kind)
    for n in (1, 4):
        assert ttune.plan_key("mlp", tconfig.parse_args(argv, "mlp"), n,
                              "cpu", "cpu") == \
            jtune.plan_key("mlp", jconfig.parse_args(argv, "mlp"), n,
                           d.platform, d.device_kind)


def _refusal(load, path, key=None):
    with pytest.raises(ValueError) as e:
        load(path, expected_key=key)
    return type(e.value).__name__, str(e.value)


def test_artifact_round_trip_and_refusals_equal_jax(tmp_path):
    plan = ttune.Plan(mesh=(("data", 2), ("fsdp", 2)), zero="fsdp",
                      remat=True, remat_policy="dots")
    path = str(tmp_path / "p.json")
    rec = ttune.save_plan(path, plan, key="abc", workload="mlp")
    jpath = str(tmp_path / "j.json")
    jrec = jtune.save_plan(jpath, jtune.Plan.from_dict(plan.to_dict()),
                           key="abc", workload="mlp")
    assert rec == jrec and open(path).read() == open(jpath).read()
    got, record = ttune.load_plan(path, expected_key="abc")
    assert got == plan and record["plan_hash"] == ttune.plan_hash(plan)
    cases = {"key": (lambda r: r, "other")}
    cases["version"] = (lambda r: {**r, "version": 99}, None)
    cases["v2"] = (lambda r: {**r, "version": 2}, None)
    cases["edited"] = (lambda r: {**r, "plan": {**r["plan"], "zero": "1"}},
                       None)
    for name, (edit, key) in cases.items():
        bad = str(tmp_path / f"{name}.json")
        json.dump(edit(rec), open(bad, "w"))
        assert _refusal(ttune.load_plan, bad, key) == \
            _refusal(jtune.load_plan, bad, key), name


def _fake_measure(plan, steps):
    """Deterministic pure function of the plan: hash → pseudo steps/sec
    (JAX's test's)."""
    return 100.0 + int(ttune.plan_hash(plan), 16) % 997


def _search(port: bool, **kw):
    argv = ["-b", "32", "-m", "data"]
    cfg = tconfig.parse_args(argv + ["-d", "cpu"], "mlp") if port \
        else jconfig.parse_args(argv, "mlp")
    spec = (tspec if port else jspec)("mlp")
    run = tsearch.run_search if port else jsearch.run_search
    return run(spec, cfg, devices=CPU8 if port else jax.devices()[:8],
               dataset=spec.build_dataset(cfg), measure=_fake_measure, **kw)


def _searches(**kw):
    return _search(True, **kw), _search(False, **kw)


def _det(result):
    return json.dumps(result.record(deterministic_only=True),
                      sort_keys=True)


def test_search_record_equals_jax():
    mine, theirs = _searches(max_trials=8)
    assert _det(mine) == _det(theirs)
    assert mine.n_candidates == 156 and mine.n_capped == 156 - 8
    assert mine.best_sps >= mine.baseline_sps


def test_fake_oom_is_infeasible_as_in_jax():
    def oom_hook(plan):
        if plan.remat:                   # every remat plan "OOMs"
            raise RuntimeError("RESOURCE_EXHAUSTED: fake out of memory")

    mine, theirs = _searches(
        oom_hook=oom_hook, max_trials=None,
        space_options=dict(zero_options=("none",),
                           compress_options=("none",),
                           grad_accum_options=(1,)))
    assert _det(mine) == _det(theirs)
    oomed = [t for t in mine.trials if t.infeasible]
    assert mine.n_infeasible == len(oomed) > 0
    assert all(t.oom and "RESOURCE_EXHAUSTED" in t.error for t in oomed)
    assert not mine.best.remat


def _oom(plan):
    raise RuntimeError("RESOURCE_EXHAUSTED: fake")


@pytest.mark.parametrize("kw,err", [
    ({"budget_bytes": 1}, ValueError),
    ({"oom_hook": _oom, "max_trials": 4}, RuntimeError)])
def test_all_pruned_and_all_infeasible_raise_as_in_jax(kw, err):
    with pytest.raises(err) as mine:
        _search(True, **kw)
    with pytest.raises(err) as theirs:
        _search(False, **kw)
    assert str(mine.value) == str(theirs.value)


class _FakeResult:
    """A TrialResult-shaped outcome of a deterministic fake corner."""

    def __init__(self, plan):
        h = int(ttune.plan_hash(plan), 16)
        self.infeasible = plan.remat_policy == "dots_no_batch"
        self.error = "RESOURCE_EXHAUSTED: fake" if self.infeasible else None
        self.steps_per_sec = 50.0 + h % 89
        self.memory = {"temp_size_in_bytes": 10_000 + h % 50_000,
                       "argument_size_in_bytes": 4096}


def test_calibration_record_equals_jax():
    argv = ["-b", "32", "-m", "data"]
    mine = tcal.run_calibration(
        tspec("mlp"), tconfig.parse_args(argv + ["-d", "cpu"], "mlp"),
        devices=CPU8[:4],
        runner=lambda plan, steps: _FakeResult(plan))
    theirs = jcal.run_calibration(
        jspec("mlp"), jconfig.parse_args(argv, "mlp"),
        devices=jax.devices()[:4],
        runner=lambda plan, steps: _FakeResult(ttune.Plan.from_dict(
            plan.to_dict())))
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert mine["constants"]["act_fraction"]


def test_real_trial_records_cost_and_leaves_no_group():
    cfg = tconfig.parse_args(["-b", "32", "-m", "data", "-d", "cpu"], "mlp")
    spec = tspec("mlp")
    harness = ttune.TrialHarness(spec, cfg, spec.build_dataset(cfg),
                                 [torch.device("cpu")], warmup=1)
    result = harness.run(ttune.Plan(), steps=2)
    assert not result.infeasible, result.error
    assert result.cost["flops"] > 0 and result.steps_per_sec > 0
    assert result.measured_steps == 2 and result.step_calls == 5
    assert set(result.memory["memory_fields_missing"]) == \
        set(tcal_fields())
    assert not dist.is_initialized()
    assert harness.run(ttune.Plan(mesh=(("data", 2),)), 1).infeasible


def tcal_fields():
    from distributed_deep_learning_tpu_torch.tune.trial import \
        MEMORY_FIELDS

    return MEMORY_FIELDS
