"""The port's multi-rank examples (02, 03, 05, 07) run green with
``--cpu`` over two gloo ranks (``--ranks 2``, launched by
``runtime.launch.launch_local``) and print their pass lines; each asserts
the JAX example's condition itself (ring attention within 1e-4 of dense
at T 4096, and its gradients within 1e-3; falling losses under FSDP,
tensor and expert parallelism)."""

import re

import pytest

from _examples_run import run_all
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

PASS_LINES = {
    "02_long_context_ring_attention": r"ranks=2 on cpu  T=4096  "
                                      r"max\|ring - dense\| = ",
    "03_fsdp_sharded_training": r"loss: [\d.]+ -> [\d.]+",
    "05_tensor_parallel_gpt_cli": r"tensor-parallel \(data=1,model=2\)",
    "07_moe_expert_parallel_cli": r"expert-parallel \(data=1,expert=2\)",
}


@pytest.fixture(scope="module")
def runs():
    return run_all(PASS_LINES, ["--ranks", "2"])


@pytest.mark.parametrize("name", sorted(PASS_LINES))
def test_example_runs_green_on_two_gloo_ranks(runs, name):
    rc, out, _ = runs[name]
    assert rc == 0, out[-3000:]
    assert re.search(PASS_LINES[name], out), out[-3000:]


def test_ring_example_meets_the_jax_threshold(runs):
    _, out, _ = runs["02_long_context_ring_attention"]
    err = float(re.search(r"max\|ring - dense\| = (\S+);", out).group(1))
    assert err < 1e-4


def test_fsdp_example_shards_the_largest_parameter(runs):
    _, out, _ = runs["03_fsdp_sharded_training"]
    assert "placements (Shard(dim=0),), this rank holds (512, 1024)" in out
