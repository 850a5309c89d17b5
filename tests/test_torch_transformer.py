"""The port's CausalLM against the flax CausalLM on the same weights.

Weights are initialised by flax, carried across with ``load_flax_params``
and compared in f32 on the CPU at atol 1e-5 (two frameworks' f32 matmuls
and LayerNorms sum in different orders; at these widths the difference
is ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu_torch.models import layers as tlayers
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=64)
ATOL = 1e-5

VARIANTS = {
    "learned": {},
    "rope": {"pos_embedding": "rope"},
    "gqa": {"num_kv_heads": 2},
    "rope_gqa": {"pos_embedding": "rope", "num_kv_heads": 2},
    "window": {"attention_window": 4},
}


def _pair(**kw):
    jm = jtr.CausalLM(**{**MODEL, **kw})
    params = jm.init(jax.random.key(7), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**{**MODEL, **kw})
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm.eval()


def _tokens(seed, B=2, T=20, pad_at=None):
    toks = np.random.default_rng(seed).integers(1, MODEL["vocab_size"],
                                                (B, T)).astype(np.int32)
    if pad_at is not None:
        toks[0, pad_at] = 0
    return toks


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_flax(variant):
    jm, params, tm = _pair(**VARIANTS[variant])
    toks = _tokens(1, pad_at=5)
    want_h = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    want_l = np.asarray(jm.logits_from({"params": params},
                                       jnp.asarray(want_h)))
    with torch.no_grad():
        got_h = tm(torch.from_numpy(toks).long())
        got_l = tm.logits_from(got_h)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cached_prefill_then_steps_match_cached_apply(variant):
    jm, params, tm = _pair(**VARIANTS[variant])
    lm = jtr.make_decode_model(jm)
    prompt = _tokens(2, T=9, pad_at=3)
    steps = _tokens(3, T=4)
    jcache = jtr.init_cache(lm, 2, 16)
    tcache = tm.init_cache(2, 16)
    chunks = [prompt] + [steps[:, i:i + 1] for i in range(steps.shape[1])]
    for chunk in chunks:
        want, jcache = jtr.cached_apply(lm, params, jcache,
                                        jnp.asarray(chunk))
        with torch.no_grad():
            got = tm.cached_forward(torch.from_numpy(chunk).long(), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for i, layer in enumerate(tcache["layers"]):
        jl = jcache[f"layer_{i}"]["self_attn"]
        np.testing.assert_allclose(layer["cached_key"].numpy(),
                                   np.asarray(jl["cached_key"]), atol=ATOL)
        np.testing.assert_array_equal(layer["cached_valid"].numpy(),
                                      np.asarray(jl["cached_valid"]))


def test_greedy_sampling_matches_and_skips_pad():
    jm, params, tm = _pair()
    h = np.random.default_rng(4).normal(size=(5, MODEL["d_model"]))
    h = h.astype(np.float32)
    want, _ = jtr.sample_tokens(jm, params, jnp.asarray(h),
                                jax.random.key(0))
    got = ttr.sample_tokens(tm, torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a hidden state aligned with the pad row still never yields the pad id
    with torch.no_grad():
        pad_h = tm.tok.weight[0:1] * 100
    assert int(ttr.sample_tokens(tm, pad_h)[0]) != 0


def test_top_k_top_p_sampling_stays_in_the_filtered_set():
    _, _, tm = _pair()
    h = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, MODEL["d_model"])).astype(np.float32))
    top = torch.topk(tm.logits_from(h)[:, 1:], 2, dim=-1).indices + 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        got = ttr.sample_tokens(tm, h, temperature=1.0, top_k=2,
                                top_p=0.99, generator=gen)
        assert all(int(t) in top[i].tolist() for i, t in enumerate(got))


def test_rope_rotates_split_halves_like_jax():
    x = np.random.default_rng(6).normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5) + 11
    want = np.asarray(jtr.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # per-row positions (the paged decode's) give each row its own rotation
    per_row = ttr.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(np.stack([pos, pos + 3])))
    np.testing.assert_allclose(per_row[0].numpy(), want[0], atol=ATOL)
    with pytest.raises(ValueError, match="even head_dim"):
        ttr.apply_rope(torch.zeros(1, 2, 1, 3), torch.arange(2))


def test_reset_parameters_is_seeded():
    a = ttr.CausalLM(**MODEL).reset_parameters(
        torch.Generator().manual_seed(3))
    b = ttr.CausalLM(**MODEL).reset_parameters(
        torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    assert float(a.tok.weight.detach().std()) == pytest.approx(0.02, rel=0.2)


def _remat_grads(policy, backwards=1, attention="dense"):
    """Gradients of the mean square hidden state after ``backwards``
    backward passes through one (retained) graph, under ``policy`` (None:
    no remat)."""
    tm = ttr.CausalLM(**MODEL, attention=attention).reset_parameters(
        torch.Generator().manual_seed(3)).train()
    h = tm(torch.from_numpy(_tokens(2)).long(), remat=policy)
    loss = (h * h).mean()
    for i in range(backwards):
        loss.backward(retain_graph=i + 1 < backwards)
    return {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dots_recomputes_each_dropped_output_once(attention, monkeypatch):
    """Under ``dots`` each layer's LayerNorm, attention and GELU outputs
    are dropped and computed again exactly once in the backward, and the
    gradients equal the run that keeps them (exactly: the same ops)."""
    recipes, calls = [], []
    init = tlayers._Recipe.__init__

    def counting_init(self, fn, args):
        def counted(*a):
            calls.append(self)
            return fn(*a)
        init(self, counted, args)
        recipes.append(self)

    monkeypatch.setattr(tlayers._Recipe, "__init__", counting_init)
    got = _remat_grads("dots", attention=attention)
    dropped = [r for r in recipes if r.views]
    # ln_attn, the attention, ln_mlp and the GELU in each of the layers
    assert len(dropped) == 4 * MODEL["num_layers"]
    assert sorted(map(id, calls)) == sorted(map(id, dropped))
    assert all(r.out is None for r in dropped)       # nothing kept after
    want = _remat_grads(None, attention=attention)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_backward_twice_through_a_retained_graph(policy):
    """``retain_graph=True`` then a second backward: each saved tensor is
    unpacked twice, and the accumulated gradients equal the run without
    remat."""
    got, want = _remat_grads(policy, 2), _remat_grads(None, 2)
    for name in want:
        assert torch.equal(got[name], want[name]), name
