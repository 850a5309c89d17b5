"""Ring attention (``parallel/ring_attention.py``) against the JAX
package's on a ``{"data": 2, "seq": 2}`` mesh: four spawned gloo ranks,
each running the model adapter on its data coordinate's rows over its
``seq`` group (the plain recurrence on the CPU), against JAX's
``ring_attention`` under ``shard_map`` from the same seeded inputs:
causal, a sliding window, ``key_valid`` with a fully padded row (exactly
0 and finite, zero gradient), causal with padding, cross attention (Tk !=
Tq), GQA K/V (JAX's on the expanded heads, the gradients summed over each
group), and the gradients of each; the same cases again through the
card's fold (one flash forward a visible hop, merged by LSE, through the
kernels' plain versions) on the seq groups of 2 and on one of all 4
ranks.  Then ``TransformerSeq2Seq``'s padded
forward and one train step's loss and gradients through the adapter,
from JAX's weights, against ``tests/test_wmt_sequence_parallel.py``'s
JAX model on the same mesh (its tolerances).  A dense mask is refused."""

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

from distributed_deep_learning_tpu.data.datasets import synthetic_wmt
from distributed_deep_learning_tpu.models import transformer as jtf
from distributed_deep_learning_tpu.parallel import ring_attention as jring
from distributed_deep_learning_tpu.parallel import ulysses as julysses
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.parallel import ring_attention
from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, T, H, D = 4, 16, 4, 8
#: (name, causal, window, padded, Tk, Hkv)
CASES = [("causal", True, None, False, T, H),
         ("window", True, 5, False, T, H),
         ("padded", False, None, True, T, H),
         ("causal_padded", True, None, True, T, H),
         ("cross", False, None, True, 8, H),
         ("gqa", True, None, False, T, 2)]
WMT = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=8, mlp_dim=64)


def attention_inputs(name, causal, window, padded, Tk, Hkv, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kv = None
    if padded:
        kv = rng.random((B, Tk)) > 0.3
        kv[1] = False                      # a fully padded row
    return {"name": name, "q": f(B, T, H, D), "k": f(B, Tk, Hkv, D),
            "v": f(B, Tk, Hkv, D), "w": f(B, T, H, D), "kv": kv,
            "causal": causal, "window": window}


def wmt_case():
    ds = synthetic_wmt(n=4, src_len=32, tgt_len=32, vocab_size=64, seed=3)
    batch = {"inputs": np.asarray(ds.features),
             "targets": np.asarray(ds.targets)}
    assert (batch["inputs"] == 0).any(), "the batch must be padded"
    dense = jtf.TransformerSeq2Seq(dropout_rate=0.0, **WMT)
    params = dense.init(jax.random.key(0), {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    params = jax.tree.map(np.asarray, params)
    return params, batch


#: one rank: the adapter over its seq group on its data coordinate's
#: rows; the seq2seq model's padded forward and one step's gradients
RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.models import transformer as ttf
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.parallel import (ring_attention,
                                                          ulysses)

rank, world, port, blob = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
spec = torch.load(blob, weights_only=False)
S = spec["seq"]


def seq_groups(seq):
    # this rank's seq group, its data coordinate and the data size
    groups = [dist.new_group(list(range(i, i + seq)))
              for i in range(0, world, seq)]
    return groups[rank // seq], rank // seq, world // seq


group = seq_groups(S)[0]


def make(grp, inner=None, fold=None):
    if spec["scheme"] == "ring":
        return ring_attention.make_attention_fn(grp, fold=fold)
    return ulysses.make_attention_fn(grp, inner=inner)


# (suffix, seq, adapter options): the default path, Ulysses' flash inner,
# and the ring's LSE fold of flash calls (the card's) at each seq size
runs = [("", S, {})]
if spec.get("flash_inner"):
    runs.append(("_flash", S, {"inner": fa.make_attention_fn()}))
runs += [(f"_lse{n}", n, {"fold": "lse"}) for n in spec.get("lse_seq", ())]
out = {}
for suffix, seq, kw in runs:
    grp, d, n_data = seq_groups(seq)
    for c in spec["cases"]:
        rows = slice(d * len(c["q"]) // n_data,
                     (d + 1) * len(c["q"]) // n_data)
        q, k, v = (torch.from_numpy(c[x][rows]).requires_grad_()
                   for x in "qkv")
        kv = None if c["kv"] is None else torch.from_numpy(c["kv"][rows])
        o = make(grp, **kw)(q, k, v, key_valid=kv, causal=c["causal"],
                            window=c["window"])
        (o * torch.from_numpy(c["w"][rows])).sum().backward()
        out[c["name"] + suffix] = {"out": o.detach(), "dq": q.grad,
                                   "dk": k.grad, "dv": v.grad}
if "wmt" in spec:
    sd, batch = spec["wmt"]
    model = ttf.TransformerSeq2Seq(64, 2, 32, 8, 64, attention=make(group))
    model.load_state_dict(sd)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(batch)
    valid = (batch["targets"] != 0).float()
    ll = torch.log_softmax(logits, -1)
    ce = -ll.gather(-1, batch["targets"][..., None])[..., 0]
    loss = (ce * valid).sum() / valid.sum()
    loss.backward()
    out["wmt"] = {"logits": logits.detach(), "loss": loss.detach(),
                  "grads": {n: p.grad.clone()
                            for n, p in model.named_parameters()}}
torch.save(out, f"{blob}.{rank}")
dist.destroy_process_group()
"""


def run_ranks(spec: dict, world: int, tmp: Path) -> list:
    blob = tmp / "spec.pt"
    torch.save(spec, blob)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), port, str(blob)],
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


def jax_attention(scheme: str, case: dict, mesh):
    """JAX's attention and the gradients of ``sum(out * w)`` (GQA K/V
    repeated inside, so their gradients sum over each group)."""
    g = case["q"].shape[2] // case["k"].shape[2]
    kv = None if case["kv"] is None else jnp.asarray(case["kv"])
    fn = jring.ring_attention if scheme == "ring" \
        else julysses.ulysses_attention

    def loss(q, k, v):
        k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        o = fn(q, k, v, mesh=mesh, causal=case["causal"],
               window=case["window"], key_valid=kv)
        return jnp.sum(o * case["w"]), o

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(case[x]) for x in "qkv"))
    return {"out": np.asarray(out),
            **{f"d{x}": np.asarray(gr) for x, gr in zip("qkv", grads)}}


def jax_wmt(scheme: str, params, batch, mesh):
    adapter = (jring if scheme == "ring" else julysses) \
        .make_attention_fn(mesh)
    model = jtf.TransformerSeq2Seq(dropout_rate=0.0, attention_fn=adapter,
                                   **WMT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        logits = model.apply(p, jb)
        valid = (jb["targets"] != 0).astype(jnp.float32)
        ll = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(ll, jb["targets"][..., None], -1)[..., 0]
        return jnp.sum(ce * valid) / jnp.sum(valid), logits

    with mesh:
        (value, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    return {"logits": np.asarray(logits), "loss": float(value),
            "grads": load_flax_params(jax.tree.map(np.asarray, grads))}


def run_scheme(scheme: str, world: int, seq: int, tmp: Path,
               flash_inner: bool = False, lse_seq: tuple = ()):
    """Every case through the port's ranks and through JAX; ``lse_seq``:
    the seq sizes at which the ring also runs its LSE fold."""
    cases = [attention_inputs(*c, seed=i) for i, c in enumerate(CASES)]
    params, batch = wmt_case()
    spec = {"scheme": scheme, "seq": seq, "cases": cases,
            "flash_inner": flash_inner, "lse_seq": lse_seq,
            "wmt": (load_flax_params(params), batch)}
    mesh = build_mesh({"data": world // seq, "seq": seq},
                      jax.devices()[:world])
    wmt_mesh = build_mesh({"seq": seq}, jax.devices()[:seq])
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, world, tmp)
        want = {c["name"]: jax_attention(scheme, c, mesh) for c in cases}
        want["wmt"] = jax_wmt(scheme, params, batch, wmt_mesh)
        return ranks.result(), want


def gathered(ranks: list, name: str, part: str, seq: int) -> np.ndarray:
    """The global array: one seq group's (replicated) copy per data
    coordinate, stacked over the batch."""
    return np.concatenate([ranks[i][name][part].numpy()
                           for i in range(0, len(ranks), seq)])


def check_attention(ranks, want, name, seq, tol=1e-5, suffix=""):
    """Case ``name`` of the run ``suffix`` names against JAX's."""
    key = name + suffix
    for part in ("out", "dq", "dk", "dv"):
        got, w = gathered(ranks, key, part, seq), want[name][part]
        np.testing.assert_allclose(got, w, rtol=tol, atol=tol,
                                   err_msg=f"{key} {part}")
        assert np.isfinite(got).all()
    # the ranks of a seq group hold the same global copy
    for i in range(0, len(ranks), seq):
        for j in range(i + 1, i + seq):
            torch.testing.assert_close(ranks[j][key]["out"],
                                       ranks[i][key]["out"], rtol=0,
                                       atol=0)


def check_wmt(ranks, want):
    got, want = ranks[0]["wmt"], want["wmt"]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-4)
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(),
                                   torch.as_tensor(v).numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    for r in ranks[1:]:
        for k, v in got["grads"].items():
            torch.testing.assert_close(r["wmt"]["grads"][k], v, rtol=0,
                                       atol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_scheme("ring", 4, 2, tmp_path_factory.mktemp("ring"),
                      lse_seq=(2, 4))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ring_matches_jax(name, runs):
    ranks, want = runs
    check_attention(ranks, want, name, 2)


@pytest.mark.parametrize("seq", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_lse_fold_matches_jax(name, seq, runs):
    """The card's fold (one flash forward a visible hop, merged by LSE;
    masked hops skipped) through the kernels' plain versions, on a seq
    group of 2 (data 2) and of 4 ranks."""
    ranks, want = runs
    check_attention(ranks, want, name, seq, suffix=f"_lse{seq}")


def test_fully_padded_row_is_exactly_zero(runs):
    ranks, _ = runs
    for name in ("padded", "causal_padded", "cross"):
        for suffix in ("", "_lse2", "_lse4"):
            # batch row 1: the first data coordinate's second row
            assert (ranks[0][name + suffix]["out"][1] == 0).all(), suffix
            assert (ranks[0][name + suffix]["dq"][1] == 0).all(), suffix


def test_seq2seq_through_the_ring_matches_jax(runs):
    check_wmt(*runs)


def test_hop_masks():
    """Which hops launch a kernel, and with which mask."""
    hops = ring_attention.ring_hops
    # causal S 2: rank 0 its diagonal only, rank 1 the diagonal and the
    # whole earlier block
    assert [m is not None for _, m in hops(0, 2, 2048, 2048, True, None)] \
        == [True, False]
    assert hops(1, 2, 2048, 2048, True, None) == [
        (1, dict(causal=True, window=None, q_offset=0)),
        (0, dict(causal=False, window=None, q_offset=0))]
    # a window reaching into the earlier block bands it with an offset
    assert hops(1, 2, 2048, 2048, True, 1024)[1] == \
        (0, dict(causal=True, window=1024, q_offset=2048))
    # one it cannot reach is skipped
    assert hops(2, 3, 16, 16, True, 8)[2] == (0, None)
    # non-causal: every hop, no mask
    assert all(m == dict(causal=False, window=None, q_offset=0)
               for _, m in hops(0, 4, 8, 4, False, None))


def test_adapter_refuses_a_dense_mask():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="dense mask"):
        ring_attention.make_attention_fn(None)(
            q, q, q, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))


def test_an_unknown_fold_is_refused():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="fold"):
        ring_attention.ring_attention(q, q, q, group=None, fold="dense")
