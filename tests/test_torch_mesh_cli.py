"""A 4-rank ``--mesh data=2,model=2`` run of ``gpt`` through the port's
CLI against the JAX CLI on the same mesh, from the JAX init (rank 0's
history within 1e-5 relative): the loaders split the batch by a rank's
data coordinate, not its rank.  With dropout, the same mesh against
``--mesh data=2,expert=2`` (gpt has no expert rules: the state is
replicated there, each data coordinate drawing its own masks as ``-m
data`` ranks do): the masks follow the data coordinate, so the two ranks
of a model group draw the same ones, and the split run trains as the
replicated one does."""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from test_torch_zero import (check_history, jax_history, jax_init,
                             run_cli_ranks)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

GPT = ["-m", "data", "-r", "4", "-d", "cpu", "-l", "2", "-s", "128", "-e",
       "1", "-b", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    argv = GPT + ["--mesh", "data=2,model=2"]
    init = jax_init("gpt", argv)
    drop = ["--dropout", "0.1"]
    cases = {
        "tp": {"workload": "gpt", "argv": argv, "init": init},
        "tp_dropout": {"workload": "gpt", "argv": argv + drop,
                       "init": init},
        "replicated_dropout": {
            "workload": "gpt", "init": init,
            "argv": GPT + ["--mesh", "data=2,expert=2", *drop]},
    }
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 4, cases, tmp)
        want, _ = jax_history("gpt", argv)
        return ranks.result(), want


def test_data_model_mesh_matches_jax_cli(runs):
    ranks, want = runs
    check_history(ranks[0]["tp"]["hist"], want, "data=2,model=2")
    for r in ranks[1:]:
        assert r["tp"]["hist"] == ranks[0]["tp"]["hist"]


def test_dropout_masks_follow_the_data_coordinate(runs):
    ranks, _ = runs
    split, repl = ranks[0]["tp_dropout"], ranks[0]["replicated_dropout"]
    # (the losses, not the weights: Adam's first step lr * g / (|g| + eps)
    # turns a gradient's last bits into a sign where it is near 0)
    check_history(split["hist"], repl["hist"], "dropout")
    # ranks 0 and 1 (one model group) keep identical replicated copies
    local0, local1 = ranks[0]["tp_dropout"]["local"], \
        ranks[1]["tp_dropout"]["local"]
    for k in ("final_norm.weight", "layers.0.ln_attn.weight",
              "layers.1.self_attn.out.bias"):
        torch.testing.assert_close(local1[k], local0[k], rtol=0, atol=0)
