"""The pipeline executor over a data x stage grid of ranks
(``parallel/spmd_pipeline.py`` with a ``runtime.mesh.PipelineGrid``)
against the JAX package's schedules on ``build_mesh({"stage": S, "data":
dp})``, as ``tests/test_spmd_pipeline_1f1b.py`` builds it.

Spawned gloo ranks, one a stage: 2 ranks (``S 2``) and 4 ranks (``dp 2 x
S 2``).  Each holds its stage's slice of the pipelined gpt trunk from
JAX's weights (``load_flax_params`` plus seeded noise, sliced by
``stage_state_dict``) and its data
coordinate's rows of each microbatch, and runs GPipe, 1F1B and
interleaved (``V 2``) on the embedded tokens.  Against JAX's
``spmd_pipeline`` (under ``jax.value_and_grad`` of the global batch's
token mean), ``spmd_pipeline_1f1b`` and ``spmd_pipeline_interleaved``:
the loss within 1e-5 relative, the trunk gradients (the ranks' slices
gathered) and the head's within 1e-5 of each leaf's largest, ``dx``
within 1e-5 of its largest.  The key projection's bias has a zero
gradient in exact arithmetic, so both sides' are held below 1e-6 of the
model's largest gradient instead.  With dropout on the 4-rank grid: the
two data coordinates fed the same rows get different ``dx`` (their masks
differ, as JAX folds the data index into its keys), and 1F1B's
recomputed backward equals GPipe's kept graph (the recompute replays each
(stage, microbatch, data coordinate)'s masks)."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models.pipelined_lm import \
    PipelinedLM as JPipelinedLM
from distributed_deep_learning_tpu.parallel.spmd_pipeline import (
    spmd_pipeline, spmd_pipeline_1f1b, spmd_pipeline_interleaved)
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train.objectives import \
    token_cross_entropy
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.runtime.bootstrap import (
    host_store, hosted_env)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
LAYERS, D, HEADS, MLP, VOCAB, T, B, MB = 4, 32, 4, 64, 64, 8, 8, 4
TOL = 1e-5
SCHEDULES = {"gpipe": 1, "1f1b": 1, "interleaved": 2}

#: one rank of the grid: every case of the spec, this rank's results
RANK = r"""
import sys
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.runtime.bootstrap import join
from torch.func import functional_call
from distributed_deep_learning_tpu_torch.models.pipelined_lm import (
    PipelinedLM, stage_state_dict)
from distributed_deep_learning_tpu_torch.parallel import spmd_pipeline as sp
from distributed_deep_learning_tpu_torch.runtime.mesh import PipelineGrid
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy

rank, world, blob = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
join("gloo", rank, world)  # the launcher's store
spec = torch.load(blob, weights_only=False)
S = spec["stages"]
grid = PipelineGrid.build(world // S, S)
loss_fn = TokenCrossEntropy()
out = {}
for name, case in spec["cases"].items():
    model = PipelinedLM(n_stages=S, n_chunks=case["chunks"], causal=True,
                        microbatch_size=spec["mb"],
                        dropout_rate=case["dropout"], **spec["model"])
    model.trunk.keep_stage(grid)
    model.load_state_dict(stage_state_dict(case["weights"], grid.stage,
                                           case["chunks"]))
    mbl = spec["mb"] // grid.dp
    rows = [m * spec["mb"] + grid.data * mbl + j
            for m in range(len(case["tokens"]) // spec["mb"])
            for j in range(mbl)]
    tokens = torch.as_tensor(case["tokens"][rows])
    targets = torch.as_tensor(case["targets"][rows])
    h = model.embed(tokens).detach()
    head = dict(model.head.named_parameters())
    seed = case["seed"]
    if case["schedule"] == "gpipe":
        def head_loss(hp, y, t):
            # this coordinate's share of the global batch's token mean
            sites = loss_fn.sites(t).double()
            total = sites.clone()
            if grid.data_group is not None:
                dist.all_reduce(total, group=grid.data_group)
            logits = functional_call(model.head, hp, (y,))
            return loss_fn(logits, t) * (sites / total).float()
        res = sp.spmd_pipeline_gpipe(model.trunk.stage_fn, head_loss,
                                     model.trunk.stacked(), head, h,
                                     targets, grid=grid, microbatch_size=mbl,
                                     seed=seed)
    else:
        def head_loss(hp, y, t):
            return loss_fn(functional_call(model.head, hp, (y,)), t)
        fn = sp.spmd_pipeline_1f1b if case["schedule"] == "1f1b" \
            else sp.spmd_pipeline_interleaved
        res = fn(model.trunk.stage_fn, head_loss, model.trunk.stacked(),
                 head, h, targets, microbatch_size=mbl, seed=seed, grid=grid)
    loss, tg, hg, dx = res
    out[name] = {"loss": float(loss), "tg": tg, "hg": hg, "dx": dx,
                 "rows": rows}
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def run_ranks(spec: dict, world: int, tmp: Path) -> list:
    blob = tmp / f"spec{world}.pt"
    torch.save(spec, blob)
    store = host_store()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **hosted_env(store))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), str(blob)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(f"{blob}.{r}") for r in range(world)]


def _data(seed=0, pads=True, same_shards=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
    targets = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
    if pads:
        targets[:, ::3] = 0                 # pad targets, left out
    if same_shards:                         # every microbatch's two halves
        for m in range(B // MB):
            for a, b in ((m * MB, m * MB + MB // 2),):
                tokens[b:b + MB // 2] = tokens[a:a + MB // 2]
                targets[b:b + MB // 2] = targets[a:a + MB // 2]
    return tokens, targets


def _jax(schedule: str, dp: int, S: int, chunks: int, tokens, targets):
    """JAX's loss and gradients (trunk, head, dx) on the data x stage
    mesh, and the port's weights of the same parameters."""
    mesh = build_mesh({"stage": S, "data": dp}, jax.devices()[:dp * S])
    model = JPipelinedLM(vocab_size=VOCAB, num_layers=LAYERS, d_model=D,
                         num_heads=HEADS, mlp_dim=MLP, mesh=mesh,
                         microbatch_size=MB, n_chunks=chunks, max_len=T,
                         causal=True)
    params = model.init(jax.random.key(3), tokens[:1])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    h = model.embed.apply({"params": params["embed"]}, tokens)
    stage_fn = model.trunk.stage_fn()

    def head_loss(hp, y, t):
        return token_cross_entropy(model.head.apply({"params": hp}, y), t)

    with mesh:
        if schedule == "gpipe":
            def loss_of(tp, hp, x):
                y = spmd_pipeline(stage_fn, tp, x, mesh=mesh,
                                  microbatch_size=MB)
                return head_loss(hp, y, targets)
            loss, (tg, hg, dx) = jax.jit(jax.value_and_grad(
                loss_of, argnums=(0, 1, 2)))(params["trunk"],
                                             params["head"], h)
        else:
            fn = spmd_pipeline_1f1b if schedule == "1f1b" \
                else spmd_pipeline_interleaved
            loss, tg, hg, dx = jax.jit(lambda tp, hp, x, y: fn(
                stage_fn, head_loss, tp, hp, x, y, mesh=mesh,
                microbatch_size=MB))(params["trunk"], params["head"], h,
                                     jnp.asarray(targets))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    grads = load_flax_params({"embed": as_np(params["embed"]),
                              "trunk": as_np(tg), "head": as_np(hg)})
    return {"loss": float(loss), "dx": np.asarray(dx), "grads": grads,
            "weights": load_flax_params(as_np(params))}


def _cases(dp: int, S: int):
    cases, want = {}, {}
    tokens, targets = _data()
    for schedule, chunks in SCHEDULES.items():
        ref = _jax(schedule, dp, S, chunks, tokens, targets)
        want[schedule] = ref
        cases[schedule] = {"schedule": schedule, "chunks": chunks,
                           "dropout": 0.0, "seed": None,
                           "weights": ref["weights"], "tokens": tokens,
                           "targets": targets}
    if dp > 1:                  # dropout: same rows on both coordinates
        tokens, targets = _data(seed=5, pads=False, same_shards=True)
        weights = want["1f1b"]["weights"]
        for schedule in ("gpipe", "1f1b"):
            for rate in (0.0, 0.3):
                cases[f"same_{schedule}_{rate}"] = {
                    "schedule": schedule, "chunks": 1, "dropout": rate,
                    "seed": 11 if rate else None, "weights": weights,
                    "tokens": tokens, "targets": targets}
    return cases, want


def _gathered(ranks, name, key, S, chunks):
    """The whole stacked gradient from data coordinate 0's stage ranks."""
    dim = 1 if chunks > 1 else 0
    return torch.cat([ranks[s][name]["tg"][key] for s in range(S)], dim)


def _check(ranks, want, name, S, chunks):
    dp = len(ranks) // S
    w = want[name]
    last = ranks[S - 1][name]
    np.testing.assert_allclose(last["loss"], w["loss"], rtol=TOL)
    grads = w["grads"]
    top = max(float(torch.as_tensor(v).abs().max())
              for v in grads.values())
    for k, p in ranks[0][name]["tg"].items():
        got = _gathered(ranks, name, k, S, chunks).numpy()
        ref = np.asarray(grads[f"trunk.stack.{k}"])
        if k.endswith("self_attn.k.bias"):
            assert np.abs(got).max() < 1e-6 * top
            assert np.abs(ref).max() < 1e-6 * top
            continue
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(), err_msg=k)
    for k, g in last["hg"].items():
        ref = np.asarray(grads[f"head.{k}"])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(), err_msg=k)
    for d in range(dp):
        first = ranks[d * S][name]
        assert all(ranks[d * S + s][name]["dx"] is None
                   for s in range(1, S))
        ref = w["dx"][first["rows"]]
        np.testing.assert_allclose(first["dx"].numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(w["dx"]).max())
        # every rank of the grid holds the same loss and head gradients
        for s in range(S):
            r = ranks[d * S + s][name]
            assert r["loss"] == last["loss"]
            for k, g in r["hg"].items():
                torch.testing.assert_close(g, last["hg"][k], rtol=0, atol=0)


@pytest.mark.parametrize("dp,S", [(1, 2), (2, 2)])
def test_grid_matches_jax(dp, S, tmp_path):
    cases, want = _cases(dp, S)
    spec = {"stages": S, "mb": MB, "cases": cases,
            "model": dict(vocab_size=VOCAB, num_layers=LAYERS, d_model=D,
                          num_heads=HEADS, mlp_dim=MLP, max_len=T)}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, dp * S, tmp_path).result()
    for name, chunks in SCHEDULES.items():
        _check(ranks, want, name, S, chunks)
    if dp == 1:
        return
    # dropout: the coordinates' masks differ (same rows, different dx),
    # without dropout they agree; 1F1B's recompute replays GPipe's masks
    for rate, differ in ((0.0, False), (0.3, True)):
        for schedule in ("gpipe", "1f1b"):
            name = f"same_{schedule}_{rate}"
            a, b = ranks[0][name]["dx"], ranks[S][name]["dx"]
            assert (not torch.equal(a, b)) is differ, name
    for rate in (0.0, 0.3):
        g, f = f"same_gpipe_{rate}", f"same_1f1b_{rate}"
        np.testing.assert_allclose(ranks[S - 1][f]["loss"],
                                   ranks[S - 1][g]["loss"], rtol=1e-5)
        for k in ranks[0][g]["tg"]:
            want_g = _gathered(ranks, g, k, S, 1)
            got = _gathered(ranks, f, k, S, 1)
            torch.testing.assert_close(
                got, want_g, rtol=0,
                atol=1e-5 * float(want_g.abs().max()) + 1e-7)
        for d in range(2):
            torch.testing.assert_close(
                ranks[d * S][f]["dx"], ranks[d * S][g]["dx"], rtol=0,
                atol=1e-5 * float(ranks[d * S][g]["dx"].abs().max()))
