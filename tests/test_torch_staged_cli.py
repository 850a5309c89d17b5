"""The reference's workloads and ResNet-18 through the port's CLI under
``-m model`` and ``-m pipeline`` on ``-d cpu``, against the JAX CLI from
the same initial weights (JAX's ``StagedModel.init`` carried over with
``load_flax_stages``): each phase's loss and accuracy at
``test_cli_history_matches_jax``'s tolerances (1e-4 relative; 1e-3 for
the BatchNorm nets, whose f32 rounding grows over their steps).  JAX
places stage ``i`` on CPU device ``i``; the port runs every stage on the
CPU.  (A ragged last chunk: ``test_torch_staged``; DenseNet-BC's and
ResNet-18's CLI: ``test_torch_staged_cli_cnn`` and
``test_torch_staged_cli_resnet``.)"""

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.parallel.partition import \
    validate_assignment
from distributed_deep_learning_tpu.parallel.staging import \
    StagedModel as JStagedModel
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.parallel.staging import (
    StagedModel, load_flax_stages)
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

#: name -> (workload, DDL_DATA_LIMIT, argv)
CASES = {
    "mlp model": ("mlp", 256, ["-m", "model", "--nstages", "2", "-l", "2",
                               "-s", "16", "-e", "2", "-b", "16"]),
    "lstm pipeline": ("lstm", 256, ["-m", "pipeline", "--nstages", "3",
                                    "-p", "6", "-l", "2", "-s", "16", "-e",
                                    "1", "-b", "16"]),
    "mnist model": ("mnist", 256, ["-m", "model", "--nstages", "3", "-e",
                                   "1", "-b", "16"]),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def staged_init(workload, argv):
    """JAX's initial per-stage variables of a staged CLI run (its
    ``StagedTrainer.init``), as the port's state dict."""
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    layers = list(jspec.build_layers(jcfg, dataset))
    n = jcfg.num_stages
    assignment = validate_assignment(jspec.partitioner(len(layers), n), n)
    variables = JStagedModel.from_layers(layers, assignment, n).init(
        jax.random.key(jcfg.seed), jspec.example_input(jcfg, dataset))
    tcfg = tconfig.parse_args(argv, workload=workload)
    tspec = tget(workload)
    tlayers = tspec.build_layers(tcfg, tspec.build_dataset(tcfg))
    staged = StagedModel.from_layers(tlayers, assignment, n)
    return load_flax_stages(jax.tree.map(np.asarray, variables), staged)


def check_history(workload, limit, argv, monkeypatch, init, rtol):
    argv = argv + ["-d", "cpu"]
    monkeypatch.setenv("DDL_DATA_LIMIT", str(limit))
    _, jhist = jbase.run_workload(jget(workload),
                                  jconfig.parse_args(argv, workload=workload))
    _, thist = tbase.run_workload(
        tget(workload), tconfig.parse_args(argv, workload=workload),
        init_state_dict=init(workload, argv))
    assert [(h.phase, h.epoch, h.examples) for h in thist] == \
        [(h.phase, h.epoch, h.examples) for h in jhist]
    assert all(h.examples for h in thist)
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=rtol, err_msg=mine.phase)
    assert all(np.isfinite(thist[0].step_losses))


@pytest.mark.parametrize("case", list(CASES))
def test_staged_cli_history_matches_jax(case, monkeypatch):
    workload, limit, argv = CASES[case]
    check_history(workload, limit, argv, monkeypatch, staged_init, 1e-4)

