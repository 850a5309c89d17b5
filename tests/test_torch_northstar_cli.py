"""The ``resnet``, ``transformer`` and ``bert`` workloads through the
port's CLI on ``-d cpu`` against the JAX CLI from the same initial weights
(``init_state_dict``): each phase's loss and accuracy per epoch, at
``DDL_DATA_LIMIT`` 96 and ``-b 8`` for one epoch, within 1e-4 (relative)
for ``transformer -l 2 -s 64`` and ``bert -l 2 -s 64`` and within 1e-3
for ``resnet`` (ResNet-18 on the CIFAR-10 twin: a BatchNorm net at batch 8
amplifies f32 rounding over its steps, as ``cnn``'s does).  Both CLIs run
dense attention on the CPU (``--attention auto``).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import resnet as tres
from distributed_deep_learning_tpu_torch.models import transformer as ttf
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

CASES = {
    "resnet": (["-e", "1", "-b", "8"], tres.load_flax_variables, 1e-3),
    "transformer": (["-l", "2", "-s", "64", "-e", "1", "-b", "8"],
                    ttf.load_flax_params, 1e-4),
    "bert": (["-l", "2", "-s", "64", "-e", "1", "-b", "8"],
             ttf.load_flax_params, 1e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("workload", list(CASES))
def test_cli_history_matches_jax(workload, monkeypatch):
    argv, load, rtol = CASES[workload]
    argv = argv + ["-d", "cpu"]
    monkeypatch.setenv("DDL_DATA_LIMIT", "96")
    jcfg = jconfig.parse_args(argv, workload=workload)
    jspec = jget(workload)
    dataset = jspec.build_dataset(jcfg)
    variables = jax.jit(jspec.build_model(jcfg, dataset).init)(
        jax.random.key(jcfg.seed), jspec.example_input(jcfg, dataset))
    _, jhist = jbase.run_workload(jspec, jcfg)
    tcfg = tconfig.parse_args(argv, workload=workload)
    _, thist = tbase.run_workload(
        tget(workload), tcfg,
        init_state_dict=load(jax.tree.map(np.asarray, dict(variables))))
    assert [(h.phase, h.epoch, h.examples) for h in thist] == \
        [(h.phase, h.epoch, h.examples) for h in jhist]
    assert all(h.examples for h in thist)
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=rtol, err_msg=mine.phase)
    assert all(np.isfinite(thist[0].step_losses))


@pytest.mark.parametrize("workload", ["resnet", "transformer", "bert"])
def test_zoo_flags_and_defaults_parse_as_jax(workload):
    """The zoo's flags, no longer refused, and each workload's ``-l/-s``
    defaults, as the JAX CLI parses them."""
    for argv in ([], ["--packed-cache", "c.ddlpack", "--image-size", "40",
                      "--stem-s2d", "-w", "3"]):
        mine = tconfig.parse_args(argv, workload)
        theirs = jconfig.parse_args(argv, workload)
        for field in ("num_layers", "size", "learning_rate", "packed_cache",
                      "image_size", "stem_s2d", "num_workers"):
            assert getattr(mine, field) == getattr(theirs, field), field
