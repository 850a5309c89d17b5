"""The LMs through the port's CLI under ``-m pipeline`` (and ``gpt`` under
``-m model``) on ``-d cpu``, against the JAX CLI from the same initial
weights: each phase's loss and accuracy within 1e-4 (relative).  The JAX
CLI forms a data axis from the devices its stages leave, and its 1F1B
loss is a mean over data shards too, so it runs ``--nstages 8`` on its
eight CPU devices (``dp = 1``), as the port does on one."""

import jax
import numpy as np
import pytest

from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from test_torch_staged_cli import (_two_threads, check_history,  # noqa: F401
                                   staged_init)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SMALL = ["-s", "32", "-e", "1", "-b", "8", "-p", "2"]
CASES = {
    "gpt 1f1b": ("gpt", ["-m", "pipeline", "--pipeline-schedule", "1f1b",
                         "--nstages", "8", "-l", "8"]),
    "bert gpipe": ("bert", ["-m", "pipeline", "--nstages", "8", "-l", "8"]),
    "transformer interleaved": ("transformer", [
        "-m", "pipeline", "--pipeline-schedule", "interleaved",
        "--virtual-stages", "2", "--nstages", "8", "-l", "16"]),
}


def pipelined_init(workload, argv):
    """JAX's initial ``PipelinedLM`` params of a ``-m pipeline`` CLI run
    (built on a ``{"data": 1, "stage": S}`` mesh), as the port's state
    dict."""
    cfg = jconfig.parse_args(argv, workload=workload)
    spec = jget(workload)
    dataset = spec.build_dataset(cfg)
    n = cfg.num_stages
    mesh = build_mesh({"data": 1, "stage": n}, jax.devices()[:n])
    model = spec.build_pipelined(cfg, dataset, mesh)
    params = model.init(jax.random.key(cfg.seed),
                        spec.example_input(cfg, dataset))
    return load_flax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_cli_history_matches_jax(case, monkeypatch):
    workload, argv = CASES[case]
    check_history(workload, 96, argv + SMALL, monkeypatch, pipelined_init,
                  1e-4)


def test_gpt_model_cli_history_matches_jax(monkeypatch):
    """``gpt -m model``: embedding, dense causal blocks, head, staged."""
    check_history("gpt", 96, ["-m", "model", "--nstages", "2", "-l", "2",
                              "-s", "32", "-e", "1", "-b", "8"],
                  monkeypatch, staged_init, 1e-4)
