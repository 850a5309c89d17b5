"""``--grad-compress int8`` on the models where a rank's own shard
changes more than the loss: ``cnn``'s BatchNorm takes
each rank's batch statistics and averages the running ones after the
update, and ``moe`` routes each rank's tokens on their own; both on two
spawned gloo ranks through the port's CLI against the JAX CLI's ``-m
data -r 2`` (its ``shard_map`` step), from the JAX init: the history,
and ``cnn``'s final running statistics.  The plain ``-m data`` run of
``cnn`` (global statistics, as JAX's jit takes them) is the control: its
history differs."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import densenet as tdn
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from test_torch_compress import jax_run
from test_torch_zero import check_history, run_cli_ranks
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

CNN = ["-m", "data", "-r", "2", "-d", "cpu", "-l", "1", "-s", "2", "-e",
       "1", "-b", "8"]
MOE = ["-m", "data", "-r", "2", "-d", "cpu", "-l", "2", "-s", "32", "-e",
       "1", "-b", "8"]
INT8 = ["--grad-compress", "int8"]
LIMIT = "64"


def jax_variables(workload: str, argv: list) -> dict:
    """The JAX CLI's initial variables (params and BatchNorm statistics)."""
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    variables = jspec.build_model(jcfg, dataset).init(
        jax.random.key(jcfg.seed), jspec.example_input(jcfg, dataset))
    return jax.tree.map(np.asarray, dict(variables))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress_models")
    for sub in ("cnn", "moe"):
        (tmp / sub).mkdir()
    with ThreadPoolExecutor(2) as pool:
        # each workload's ranks start as soon as its JAX init is made
        init = tdn.load_flax_variables(jax_variables("cnn", CNN))
        cnn = pool.submit(run_cli_ranks, 2, {
            "cnn_int8": {"workload": "cnn", "argv": CNN + INT8,
                         "init": init},
            "cnn_plain": {"workload": "cnn", "argv": CNN, "init": init}},
            tmp / "cnn", LIMIT)
        init = load_flax_params(jax_variables("moe", MOE)["params"])
        moe = pool.submit(run_cli_ranks, 2, {
            "moe_int8": {"workload": "moe", "argv": MOE + INT8,
                         "init": init}}, tmp / "moe", LIMIT)
        want = {"cnn_int8": jax_run("cnn", CNN + INT8, LIMIT),
                "moe_int8": jax_run("moe", MOE + INT8, LIMIT)}
        ranks = [{**a, **b} for a, b in zip(cnn.result(), moe.result())]
        return ranks, want


@pytest.mark.parametrize("name", ["cnn_int8", "moe_int8"])
def test_local_statistics_and_routing_match_jax(name, runs):
    ranks, want = runs
    check_history(ranks[0][name]["hist"], want[name][1], name, rtol=1e-4)
    assert ranks[1][name]["hist"] == ranks[0][name]["hist"]


def test_running_statistics_are_the_ranks_mean(runs):
    ranks, want = runs
    state = want["cnn_int8"][0]
    jvars = tdn.load_flax_variables(jax.tree.map(np.asarray, {
        "params": state.params, **state.model_state}))
    stats = [k for k in jvars if k.endswith(("running_mean", "running_var"))]
    assert stats
    # the statistics of parameters that int8 steps moved: a flipped
    # rounding between the packages moves a batch mean by ~1e-5
    for r in ranks:
        for k in stats:
            np.testing.assert_allclose(
                r["cnn_int8"]["params"][k].numpy(),
                torch.as_tensor(jvars[k]).numpy(), rtol=1e-3, atol=1e-4,
                err_msg=k)


def test_global_statistics_are_another_run(runs):
    ranks, _ = runs
    plain = [loss for _, _, _, loss in ranks[0]["cnn_plain"]["hist"]]
    local = [loss for _, _, _, loss in ranks[0]["cnn_int8"]["hist"]]
    assert plain != local
