"""``scripts.chaos_drill``'s ``fleet`` and ``rebalance`` scenarios
against ``scripts/chaos_drill.py``, on the CPU (the JAX script's 8-device
CPU host; the port's rebalance drill gets the CPU four times for its
disaggregated pools).

Each exits 0 with ``drill_passed``, and its record's fields that do not
depend on the clock equal the JAX script's: replicas, requests, requests
lost, faults fired, health, preempted requests, evacuations, scale
events, the pool reassignment.
"""

import pytest

from _chaos_records import comparable, jax_record, port_record
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("scenario", ["fleet", "rebalance"])
def test_record_equals_jaxs_script(scenario, monkeypatch):
    rc, mine = port_record(scenario)
    assert rc == 0 and mine["drill_passed"]
    assert mine["requests_lost_total"] == 0
    jrc, theirs = jax_record(scenario, monkeypatch)
    assert jrc == 0
    assert comparable(mine) == comparable(theirs)
