"""``moe -m data`` through the port's CLI on two spawned gloo ranks
(``--spawn``'s launcher) against the JAX CLI's ``-m data`` over the same
global batches, from the JAX init (written as the port's step-0
checkpoint, which the ranks ``--resume``), with and without
``--grad-accum 2``: rank 0's phase log within 1e-4 (losses, relative)
and the printed rounding (accuracies).  The runner routes each rank's
rows over the global batch (``models.moe.global_routing``); the default
capacity binds, so routing each rank's rows alone would log another
history (``tests/test_torch_moe_cli.py`` shows the routing itself)."""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SMALL = ["-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu"]
RANK_TIMEOUT = 120.0
_END = re.compile(r'^"(train|validation|test)(?: epoch (\d+))? ends at '
                  r'\S+ with accuracy (\S+) and loss (\S+)"$')


def _seed_checkpoint(directory, argv):
    """The JAX init as the port's step-0 checkpoint."""
    jcfg = jconfig.parse_args(argv, workload="moe")
    dataset = jget("moe").build_dataset(jcfg)
    params = jax.jit(jget("moe").build_model(jcfg, dataset).init)(
        jax.random.key(jcfg.seed),
        jnp.zeros((1, dataset.features.shape[1]), jnp.int32))["params"]
    cfg = tconfig.parse_args(argv, workload="moe")
    spec = tget("moe")
    state = create_train_state(
        spec.build_model(cfg, dataset), cfg.seed,
        tbase.build_optimizer(spec, cfg, 1),
        load_flax_params(jax.tree.map(np.asarray, params)), device="cpu")
    Checkpointer(directory).save(0, state, extra={
        "epoch": 0, "batch": 0, "epoch_complete": True})


def _phase_ends(stdout):
    return [(m.group(1), int(m.group(2)) if m.group(2) else None,
             float(m.group(3)), float(m.group(4)))
            for m in map(_END.match, stdout.splitlines()) if m]


@pytest.mark.parametrize("flags", [[], ["--grad-accum", "2"]])
def test_spawned_global_routing_matches_jax_cli(flags, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = SMALL + flags
    ckdir = str(tmp_path / "ckpt")
    _seed_checkpoint(ckdir, argv)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            launch_local, 2, ["moe", "-m", "data", "-r", "2", *argv,
                              "--checkpoint-dir", ckdir, "--resume"],
            device="cpu", timeout=RANK_TIMEOUT)
        _, jhist = jbase.run_workload(jget("moe"), jconfig.parse_args(
            ["-m", "data", "-r", "2", *argv], workload="moe"))
        results = ranks.result()
    assert "resumed from epoch 0" in results[0].stdout
    assert _phase_ends(results[1].stdout) == []         # rank 0 logs
    got = _phase_ends(results[0].stdout)
    assert [(p, e) for p, e, _, _ in got] == \
        [(h.phase, h.epoch) for h in jhist]
    for (phase, _, acc, loss), h in zip(got, jhist):
        np.testing.assert_allclose(loss, h.loss, rtol=1e-4, atol=1e-9,
                                   err_msg=phase)
        assert abs(acc - h.accuracy) <= 1.5e-3, (phase, acc, h.accuracy)
