"""``scripts.chaos_drill`` against ``scripts/chaos_drill.py``, on the CPU:
the ``resilience``, ``serve`` and ``shrink`` scenarios (``fleet`` and
``rebalance``: ``test_torch_scripts_chaos_fleet.py``).

Each scenario runs with ``--device cpu`` and exits 0 with
``drill_passed``; its record's fields that do not depend on the clock
equal the JAX script's (faults fired, detection ticks, requests lost,
restarts, swaps); JAX's compile counts and the port's graph captures
differ by design and are left out.  ``shrink`` launches gloo ranks as the library does, at its
smallest size (4 ranks, one killed): the killed ranks, the survivors and
the plan's hash are JAX's choices for that topology.
"""

import functools

import pytest

from distributed_deep_learning_tpu.reshard import replan as jreplan
from distributed_deep_learning_tpu.tune.artifact import plan_hash
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu_torch.reshard import drill as tdrill
from _chaos_records import comparable, jax_record, port_record
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("scenario", ["resilience", "serve"])
def test_record_equals_jaxs_script(scenario, monkeypatch):
    rc, mine = port_record(scenario)
    assert rc == 0 and mine["drill_passed"]
    jrc, theirs = jax_record(scenario, monkeypatch)
    assert jrc == 0
    assert comparable(mine) == comparable(theirs)


def test_shrink_kills_and_replans_as_jax(monkeypatch):
    monkeypatch.setattr(tdrill, "run_shrink_drill", functools.partial(
        tdrill.run_shrink_drill, n_devices=4, kill=1, rows=256, hidden=64))
    rc, rec = port_record("shrink")
    assert rc == 0 and rec["drill_passed"], rec
    survivors, dead = jchaos.ChaosPlan.shrink_topology(range(4), kill=1,
                                                       seed=0)
    plan = jreplan.choose_plan(
        len(survivors), 96, space_options={
            "dtypes": ("float32",), "grad_accum_options": (1,),
            "attention_options": ("auto",), "zero_options": ("1",),
            "compress_options": ("none",)})
    assert rec["killed"] == dead
    assert rec["survivors"] == len(survivors)
    assert rec["plan_hash"] == plan_hash(plan)
