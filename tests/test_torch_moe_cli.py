"""``moe`` end to end on the CPU against the JAX package:

* Global routing under ``-m data``: two spawned gloo ranks each take
  their rows of a seeded global batch (``local_rows``) and run one step
  (SGD) through DDP with ``global_routing``, with and without
  ``--grad-accum 2``; JAX runs one program over the global batch.  The
  default capacity binds (tokens are dropped), so routing each rank's
  rows alone computes another function: the ranks' globally routed eval
  logits equal JAX's within 1e-5, their locally routed ones (the planted
  control) miss by more than 1e-3 of max|logit|; the logged loss within
  1e-6 and each parameter's update within 2e-5 of JAX's.
* The CLI: ``moe -d cpu -l 2 -s 64 -e 1`` under ``-m sequential`` and
  ``-m data`` (one rank in this process) gives the JAX CLI's history from
  the same initial weights within 1e-4 relative.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.models import moe as jmoe
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train.accumulate import \
    make_accum_step_fns
from distributed_deep_learning_tpu.train.objectives import \
    token_cross_entropy as jtoken_ce
from distributed_deep_learning_tpu.train.state import \
    create_train_state as jcreate
from distributed_deep_learning_tpu.train.step import \
    make_step_fns as jmake_step_fns
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.data.loader import local_rows
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
LM = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
          num_experts=8)
B, T, WORLD, LR = 8, 12, 2, 0.5
RANK_TIMEOUT = 120.0

#: one rank of the spawned step: its rows, global routing, DDP, one SGD
#: step; saves its eval logits (routed globally, then locally) and, on
#: rank 0, the loss and the updated parameters
RANK = r"""
import sys
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from distributed_deep_learning_tpu_torch.data.loader import local_rows
from distributed_deep_learning_tpu_torch.models import moe
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns

rank, world, port, blob, accum = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], int(sys.argv[5]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
d = torch.load(blob)
state = create_train_state(moe.MoELM(**d["lm"]), 0, Optimizer("sgd", d["lr"]),
                           d["init"], device="cpu")
ddp = DistributedDataParallel(state.model)
moe.global_routing(state.model)
rows = torch.from_numpy(local_rows(d["x"].shape[0], rank, world))
out = {}
with torch.no_grad():
    state.model.eval()
    out["global"] = state.model(d["x"][rows])
    layers = [m for m in state.model.modules() if isinstance(m, moe.MoEMLP)]
    group = layers[0].group
    for m in layers:
        m.group = None
    out["local"] = state.model(d["x"][rows])
    for m in layers:
        m.group = group
rows = torch.from_numpy(local_rows(d["x"].shape[0], rank, world, accum))
step, _ = make_step_fns(TokenCrossEntropy(), ddp=ddp, accum_steps=accum)
state, metrics = step(state, d["x"][rows], d["y"][rows])
out["loss"] = float(metrics["loss"])
out["params"] = state.model.state_dict()
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _global_batch(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, LM["vocab_size"], (B, T)).astype(np.int32)
    for r, n in enumerate(rng.integers(0, T // 3, B)):
        if n:
            x[r, T - n:] = 0
    y = np.where((rng.random((B, T)) < 0.3) & (x != 0),
                 rng.integers(1, LM["vocab_size"], (B, T)), 0)
    return x, y.astype(np.int32)


def _spawn_ranks(blob: Path, accum: int):
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), port, str(blob),
         str(accum)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(WORLD)]


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_global_routing_matches_jax(accum, tmp_path):
    x, y = _global_batch()
    jm = jmoe.MoELM(**LM)
    jp = _np(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    init = load_flax_params(jp)
    blob = tmp_path / "blob.pt"
    torch.save({"lm": LM, "lr": LR, "init": init, "x": torch.from_numpy(x),
                "y": torch.from_numpy(y)}, blob)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn_ranks, blob, accum)
        jlogits = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
        state = jcreate(jm, jax.random.key(0), jnp.asarray(x[:1]),
                        optax.sgd(LR))
        state = state.replace(params=jax.tree.map(jnp.array, jp))
        mesh = build_mesh({"data": 1}, jax.devices()[:1])
        step = (jmake_step_fns(mesh, jtoken_ce)[0] if accum == 1 else
                make_accum_step_fns(mesh, jtoken_ce, accum_steps=accum)[0])
        new, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        want = load_flax_params(_np(new.params))
        outs = ranks.result()
    scale = np.abs(jlogits).max()
    for r, out in enumerate(outs):
        ref = jlogits[local_rows(B, r, WORLD)]
        np.testing.assert_allclose(out["global"].numpy(), ref, rtol=0,
                                   atol=1e-5 * scale)
        miss = np.abs(out["local"].numpy() - ref).max()
        assert miss > 1e-3 * scale, (r, miss)       # capacity binds
    np.testing.assert_allclose(outs[0]["loss"], float(metrics["loss"]),
                               rtol=1e-6)
    for k, w in want.items():
        for out in outs:
            upd = (init[k] - out["params"][k]).numpy()
            ref = (init[k] - w).numpy()
            np.testing.assert_allclose(upd, ref, rtol=0,
                                       atol=2e-5 * max(LR, np.abs(ref).max()),
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["sequential", "data"])
def test_cli_history_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "96")
    argv = ["-l", "2", "-s", "64", "-e", "1", "-b", "8", "-d", "cpu",
            "-m", mode]
    jcfg = jconfig.parse_args(argv, workload="moe")
    jspec = jget("moe")
    dataset = jspec.build_dataset(jcfg)
    variables = jax.jit(jspec.build_model(jcfg, dataset).init)(
        jax.random.key(jcfg.seed), jspec.example_input(jcfg, dataset))
    _, jhist = jbase.run_workload(jspec, jcfg)
    _, thist = tbase.run_workload(
        tget("moe"), tconfig.parse_args(argv, workload="moe"),
        init_state_dict=load_flax_params(_np(dict(variables))))
    assert [(h.phase, h.epoch, h.examples) for h in thist] == \
        [(h.phase, h.epoch, h.examples) for h in jhist]
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=1e-4, err_msg=mine.phase)
    assert all(np.isfinite(thist[0].step_losses))
