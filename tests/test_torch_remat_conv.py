"""``--remat --remat-policy dots|dots_no_batch`` on the conv and BatchNorm
workloads (``mlp``, ``lstm`` and ``mnist`` here; ``cnn`` and a small
``resnet``, whose JAX compiles under remat take longest, in
``test_torch_remat_cnn.py`` and ``test_torch_remat_resnet.py`` with
:func:`check`) through the port's CLI, against the JAX CLI and against
the port's run without remat.

For each workload and policy, from the JAX init (``init_state_dict``) at
a data depth of a few steps: the port's phase losses equal the JAX CLI's
under the same ``--remat --remat-policy`` within 1e-5 (relative), and
equal the port's own run without remat bit for bit, BatchNorm running
statistics included (the recompute updates none a second time).
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import cnn_lstm as tlstm
from distributed_deep_learning_tpu_torch.models import densenet as tdn
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.models import resnet as tres
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

#: workload -> (DDL_DATA_LIMIT, argv, flax-variables loader)
CASES = {
    "mlp": (96, ["-l", "2", "-s", "16", "-b", "16"],
            tmlp.load_flax_variables),
    "lstm": (96, ["-l", "2", "-s", "16", "-b", "16"],
             tlstm.load_flax_variables),
    "mnist": (48, ["-b", "16"], tres.load_flax_variables),
    "cnn": (40, ["-l", "1", "-s", "2", "-b", "8"], tdn.load_flax_variables),
    "resnet": (24, ["-b", "8"], tres.load_flax_variables),
}
POLICIES = ("dots", "dots_no_batch")
TOL = 1e-5


def _argv(workload, policy=None):
    argv = CASES[workload][1] + ["-e", "1", "-d", "cpu"]
    return argv + (["--remat", "--remat-policy", policy] if policy else [])


@functools.lru_cache(maxsize=None)
def _init(workload):
    """The JAX CLI's initial variables (numpy)."""
    jcfg = jconfig.parse_args(_argv(workload), workload=workload)
    spec = jget(workload)
    dataset = spec.build_dataset(jcfg)
    variables = jax.jit(spec.build_model(jcfg, dataset).init)(
        jax.random.key(jcfg.seed), spec.example_input(jcfg, dataset))
    return jax.tree.map(np.asarray, dict(variables))


def _port(workload, policy=None):
    state, hist = tbase.run_workload(
        tget(workload), tconfig.parse_args(_argv(workload, policy),
                                           workload=workload),
        init_state_dict=CASES[workload][2](_init(workload)))
    assert hist[0].phase == "train" and hist[0].examples
    return [h.loss for h in hist], [b.clone() for b in state.model.buffers()]


def _jax(workload, policy):
    _, hist = jbase.run_workload(
        jget(workload), jconfig.parse_args(_argv(workload, policy),
                                           workload=workload))
    return [(h.phase, h.epoch, h.examples, h.loss) for h in hist]


@functools.lru_cache(maxsize=None)
def _runs(workload):
    """The JAX CLI under each policy (its compiles run in threads, beside
    the port's runs) and the port's runs without remat and under each."""
    os.environ["DDL_DATA_LIMIT"] = str(CASES[workload][0])
    try:
        _init(workload)
        with ThreadPoolExecutor(len(POLICIES)) as pool:
            jax_runs = {p: pool.submit(_jax, workload, p) for p in POLICIES}
            port = {p: _port(workload, p) for p in (None, *POLICIES)}
            return port, {p: f.result() for p, f in jax_runs.items()}
    finally:
        os.environ.pop("DDL_DATA_LIMIT", None)


def check(workload: str, policy: str) -> None:
    port, jax_runs = _runs(workload)
    losses, buffers = port[policy]
    jhist = jax_runs[policy]
    assert len(losses) == len(jhist)
    np.testing.assert_allclose(losses, [h[-1] for h in jhist], rtol=TOL,
                               atol=0)
    plain_losses, plain_buffers = port[None]
    assert losses == plain_losses
    assert len(buffers) == len(plain_buffers)
    for a, b in zip(plain_buffers, buffers):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workload", ["mlp", "lstm", "mnist"])
def test_remat_policy_matches_jax_and_the_run_without_remat(
        workload, policy):
    check(workload, policy)
