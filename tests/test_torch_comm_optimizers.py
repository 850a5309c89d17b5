"""``--zero fsdp --comm`` with the optimizers whose statistics are
shard-local (``parallel/collectives.ExplicitFSDP``), on two spawned gloo
ranks through the port's CLI.  ``gpt`` at width 128 splits its square
q/k/v/out kernels, where JAX's rule picks a dim of the flax layout: LAMB's
trust ratios and ``--clip-norm``'s norm over each rank's shard follow the
JAX CLI's history and final parameters.  Adafactor factors each rank's
shard (the JAX package's ``make_fsdp_step_fns`` cannot run it on a
factored split leaf): a checkpoint saves every rank's factored moments on
a leading rank axis, and a mid-epoch resume restores each rank's own and
trains on bit for bit.  The layouts themselves give JAX's leaves, value
for value."""

import contextlib
import io
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from test_torch_zero import LIMIT, check_history, jax_init, run_cli_ranks
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

FSDP = ["-m", "data", "-r", "2", "-d", "cpu", "-e", "1", "--zero", "fsdp"]
#: wide enough that the square attention kernels are split (128 x 128)
GPT = FSDP + ["-l", "1", "-s", "128", "-b", "8", "--comm", "bf16",
              "--optimizer", "lamb", "--lr", "1e-2", "--clip-norm", "0.05"]
#: the hidden kernel (512 x 512) is split and factored
MLP = FSDP + ["-l", "2", "-s", "512", "-b", "16", "--comm", "int8",
              "--optimizer", "adafactor", "--lr", "1e-2"]


def jax_run(workload: str, argv: list):
    """The JAX CLI's final parameters (as the port's) and history."""
    os.environ["DDL_DATA_LIMIT"] = LIMIT
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state, hist = jbase.run_workload(
                jget(workload), jconfig.parse_args(argv, workload=workload))
    finally:
        del os.environ["DDL_DATA_LIMIT"]
    params = load_flax_params(jax.tree.map(np.asarray, state.params))
    return params, [(h.phase, h.epoch, h.accuracy, h.loss) for h in hist]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm_opt")
    ck = ["--checkpoint-dir", str(tmp / "ada"), "--checkpoint-every", "1"]
    cases = {"gpt_lamb_clip": {"workload": "gpt", "argv": GPT,
                               "init": jax_init("gpt", GPT)},
             "ada_whole": {"workload": "mlp", "argv": MLP + ck},
             "ada_resumed": {"workload": "mlp", "argv": MLP + ck
                             + ["--resume"], "prune": (str(tmp / "ada"), 1)}}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_cli_ranks, 2, cases, tmp)
        want = jax_run("gpt", GPT)
        return ranks.result(), want, tmp


def test_shard_local_lamb_and_clip_follow_jax_cli(runs):
    """The history, and the final parameters: a whole leaf moves by the
    clip scale of the rank's shards (within 2e-5 of JAX's; the torch
    layout's split gives 1.7e-4 to 3.9e-4 on the LayerNorm weights), a
    split leaf by its shard's trust ratio too (within 1.5e-4; the torch
    layout's split gives 3.2e-4 to 3.4e-4 on q, k and v)."""
    ranks, want, _ = runs
    params, hist = want
    got = ranks[0]["gpt_lamb_clip"]
    check_history(got["hist"], hist, "lamb clip", rtol=1e-4)
    for k, v in params.items():
        v = torch.as_tensor(v)
        tol = 2e-5 if v.numel() < 2 ** 14 else 1.5e-4     # whole, split
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=tol,
                                   msg=k)
    assert ranks[1]["gpt_lamb_clip"]["hist"] == got["hist"]


def test_adafactor_resume_restores_each_ranks_factors(runs):
    ranks, _, tmp = runs
    for r in ranks:
        whole, resumed = r["ada_whole"], r["ada_resumed"]
        assert resumed["hist"] == whole["hist"]
        for part in ("params", "residual"):
            for k, v in whole[part].items():
                torch.testing.assert_close(resumed[part][k], v, rtol=0,
                                           atol=0, msg=k)
    payload = torch.load(max((tmp / "ada").glob("ckpt-*.pt"),
                             key=lambda p: int(p.stem.split("-")[1])),
                         weights_only=False)
    opt = payload["optimizer"]
    # every split leaf's factored moments: one a rank, and they differ
    keys = [(i, k) for i, ks in opt["shard_local"].items() for k in ks]
    assert {k for _, k in keys} == {"v_row", "v_col"}
    for i, k in keys:
        v = opt["state"][i][k]
        assert v.shape[0] == 2 and not torch.equal(v[0], v[1]), (i, k)


def _port_model(workload: str, argv: list):
    from distributed_deep_learning_tpu_torch.utils import config as tconfig
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    cfg = tconfig.parse_args(argv, workload)
    spec = get_spec(workload)
    return spec.build_model(cfg, spec.build_dataset(cfg))


@pytest.mark.parametrize("workload,argv", [
    ("mlp", ["-l", "2", "-s", "16"]), ("mnist", []),
    ("gpt", ["-l", "1", "-s", "64"])])
def test_flax_layouts_give_jax_leaves(workload, argv, monkeypatch):
    """Each parameter in the layout ``--comm`` splits is a JAX leaf, value
    for value (Dense kernels transposed, convolutions ``(*k, in, out)``,
    the transformer's attention kernels by head)."""
    monkeypatch.setenv("DDL_DATA_LIMIT", LIMIT)     # a small dataset
    from distributed_deep_learning_tpu_torch.models import mlp, resnet
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        flax_layouts
    from test_torch_compress_models import jax_variables

    argv = ["-d", "cpu", *argv]
    variables = jax_variables(workload, argv)
    load = {"mlp": mlp.load_flax_variables,
            "mnist": resnet.load_flax_variables,
            "gpt": lambda v: load_flax_params(v["params"])}[workload]
    model = _port_model(workload, argv)
    model.load_state_dict(load(variables))
    leaves = {}
    for leaf in jax.tree.leaves(variables["params"]):
        leaves.setdefault(tuple(leaf.shape), []).append(np.asarray(leaf))
    layout = flax_layouts(model)
    for name, p in model.named_parameters():
        got = layout(name)[0](p.detach()).numpy()
        assert any(np.array_equal(got, w)
                   for w in leaves.get(got.shape, [])), name
        back = layout(name)[1](torch.from_numpy(got))
        assert torch.equal(back, p.detach()), name
