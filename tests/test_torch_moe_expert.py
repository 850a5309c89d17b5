"""``moe --mesh expert=2`` and ``--mesh model=2`` through the port's CLI on
two spawned gloo ranks, against the JAX CLI on the same mesh of its
8-device CPU mesh, from the JAX init: rank 0's phase history within 1e-5
relative (losses).  Under ``expert=2`` each rank holds 4 of the 8
experts' kernels and sees the whole batch (the batch axes have one rank),
and the ranks sum their experts' outputs; under ``model=2`` gpt runs
Megatron-split, the flash kernels' plain versions on one head a rank;
its checkpoint is saved whole, and the model it trained, gathered whole
on every rank, continues the dataset's prompts as JAX's does
(``--generate``)."""

import json
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from test_torch_zero import (check_history, jax_history, jax_init,
                             run_cli_ranks)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

CASES = {
    "moe_expert": ("moe", ["-l", "2", "-s", "64", "-e", "1", "-b", "8",
                           "--mesh", "expert=2"]),
    "gpt_model": ("gpt", ["-l", "2", "-s", "128", "-e", "1", "-b", "8",
                          "--mesh", "model=2", "--attention", "flash",
                          "--generate", "4"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    cases, argvs = {}, {}
    for name, (workload, flags) in CASES.items():
        argvs[name] = ["-m", "data", "-r", "2", "-d", "cpu", *flags]
        cases[name] = {"workload": workload, "argv": argvs[name],
                       "init": jax_init(workload, argvs[name])}
    # the split run also saves its (whole) state
    cases["gpt_model"]["argv"] = argvs["gpt_model"] + [
        "--checkpoint-dir", str(tmp / "tp")]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 2, cases, tmp)
        want = {name: jax_history(workload, argvs[name])
                for name, (workload, _) in CASES.items()}
        return ranks.result(), want, tmp


@pytest.mark.parametrize("name", list(CASES))
def test_history_matches_jax_cli(name, runs):
    ranks, want, _ = runs
    check_history(ranks[0][name]["hist"], want[name][0], name)
    # the ranks of one group compute the same replicated values
    assert ranks[1][name]["hist"] == ranks[0][name]["hist"]


def _generated(log):
    return [line for line in log.splitlines() if "generate prompt=" in line]


def test_split_model_generates_as_jax_does(runs):
    """``--generate`` after ``--mesh model=2``: the post-train hook runs
    on the whole model (``workloads.base.whole_state``)."""
    ranks, want, _ = runs
    mine = _generated(ranks[0]["gpt_model"]["log"])
    assert len(mine) == 2 and mine == _generated(want["gpt_model"][1])


def test_each_rank_holds_half_of_the_experts(runs):
    ranks, _, _ = runs
    for r, out in enumerate(ranks):
        local, whole = out["moe_expert"]["local"], out["moe_expert"]["params"]
        for k in ("layers.1.moe.w_in", "layers.1.moe.w_out"):
            assert local[k].shape[0] == 4 and whole[k].shape[0] == 8
            torch.testing.assert_close(local[k], whole[k][4 * r:4 * r + 4],
                                       rtol=0, atol=0)
        router = "layers.1.moe.router.weight"
        torch.testing.assert_close(local[router], whole[router], rtol=0,
                                   atol=0)


def test_split_checkpoint_is_saved_whole(runs):
    """The ``--mesh model=2`` checkpoint holds every parameter and AdamW
    moment whole (shaped as the replicated model's), with its mesh."""
    ranks, _, tmp = runs
    whole = ranks[0]["gpt_model"]["params"]
    manifest = json.loads(max((tmp / "tp").glob("manifest-*.json"))
                          .read_text())
    leaves = manifest["leaves"]
    assert {k: leaves[f"/params/{k}"]["shape"] for k in whole} == \
        {k: list(v.shape) for k, v in whole.items()}
    moments = sorted(v["shape"] for k, v in leaves.items()
                     if k.endswith("/exp_avg"))
    assert moments == sorted(list(v.shape) for v in whole.values())
    assert manifest["topology"]["mesh"]["model"] == 2
