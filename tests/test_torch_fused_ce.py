"""The port's fused linear + cross-entropy head against the JAX one.

Inputs are made with numpy from a seed and fed to both packages:
``ops.fused_ce.fused_linear_cross_entropy`` (loss, and the gradients of
``h`` and of the table) is held against the JAX op within 1e-5 relative in
f32 (gradients within 1e-5 of the largest |gradient| as well: the two sum
in different orders).  The cases are ``tests/test_fused_ce.py``'s: several
blocks, a single block, a vocabulary the block does not divide (padded
columns), the ``(B, T, d)`` calling shape, every row ignored, bf16
activations and ``ignore_id=-1``.  ``CausalLM.loss`` is held against the
port's own logits path and against the JAX ``CausalLM.loss`` on the same
weights (the ``load_flax_params`` bridge), with ``pad_id`` 0 and None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models.transformer import CausalLM as JLM
from distributed_deep_learning_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jfused
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, load_flax_params)
from distributed_deep_learning_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy as tfused

RTOL = 1e-5


def _data(N=24, d=16, V=64, seed=0, pad_tail=4):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, d)).astype(np.float32)
    table = (0.1 * rng.normal(size=(V, d))).astype(np.float32)
    targets = rng.integers(1, V, size=N).astype(np.int32)
    targets[N - pad_tail:] = 0
    return h, table, targets


def _jax(h, table, targets, ignore_id, block, h_dtype=jnp.float32):
    def f(h, w):
        return jfused(h.astype(h_dtype), w, jnp.asarray(targets), ignore_id,
                      block)
    loss, grads = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h),
                                                         jnp.asarray(table))
    return float(loss), [np.asarray(g, np.float32) for g in grads]


def _torch(h, table, targets, ignore_id, block, h_dtype=torch.float32):
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(table).requires_grad_()
    loss = tfused(th.to(h_dtype), tw, torch.from_numpy(targets), ignore_id,
                  block)
    loss.backward()
    return loss.item(), [th.grad.numpy(), tw.grad.numpy()]


def _close(got, want):
    (gl, gg), (wl, wg) = got, want
    np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=1e-7)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))


#: name -> (data kwargs, ignore_id, block, reshape to (B, T, d))
CASES = {
    "blocks": (dict(seed=0), 0, 16, None),
    "single_block": (dict(seed=1), 0, 64, None),
    "indivisible_vocab": (dict(V=97, seed=2), 0, 32, None),
    "batched_sequence": (dict(N=32, seed=3), 0, 16, (4, 8)),
    "ignore_minus_one": (dict(seed=4), -1, 16, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    kw, ignore_id, block, bt = CASES[case]
    h, table, targets = _data(**kw)
    if bt is not None:
        h, targets = h.reshape(*bt, -1), targets.reshape(bt)
    _close(_torch(h, table, targets, ignore_id, block),
           _jax(h, table, targets, ignore_id, block))


def test_all_rows_ignored_is_finite_with_zero_gradients():
    h, table, targets = _data(seed=5)
    targets[:] = 0
    loss, grads = _torch(h, table, targets, 0, 16)
    assert loss == 0.0
    for g in grads:
        assert np.isfinite(g).all() and not g.any()
    jloss, _ = _jax(h, table, targets, 0, 16)
    assert jloss == 0.0


def test_bf16_activations_match_jax():
    """bf16 h is widened to f32 inside both ops; dh comes back in bf16."""
    h, table, targets = _data(seed=6)
    h = np.asarray(torch.from_numpy(h).bfloat16().float())
    got = _torch(h, table, targets, 0, 16, h_dtype=torch.bfloat16)
    want = _jax(h, table, targets, 0, 16, h_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    # dh is rounded to bf16 on both sides: one bf16 step apart at most
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want[1][0]).max()))
    np.testing.assert_allclose(got[1][1], want[1][1], rtol=RTOL,
                               atol=RTOL * float(np.abs(want[1][1]).max()))


MODEL = dict(vocab_size=97, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=64)


@pytest.mark.parametrize("pad_id", [0, None])
def test_causal_lm_loss_matches_logits_path_and_jax(pad_id):
    rng = np.random.default_rng(7)
    toks = rng.integers(1, MODEL["vocab_size"], size=(2, 17)).astype(np.int32)
    toks[1, 12:] = 0                      # a tail of id 0
    jm = JLM(**MODEL, pad_id=pad_id)
    params = jm.init(jax.random.key(1), jnp.asarray(toks[:, :-1]))
    jh = jm.apply(params, jnp.asarray(toks[:, :-1]), train=False)
    jloss = float(jm.loss(params, jh, jnp.asarray(toks[:, 1:])))

    tm = CausalLM(**MODEL, pad_id=pad_id)
    tm.load_state_dict(load_flax_params(jax.tree.map(np.asarray, params)))
    tm.eval()
    t = torch.from_numpy(toks).long()
    h = tm(t[:, :-1])
    targets = t[:, 1:]
    loss = tm.loss(h, targets)
    logp = torch.log_softmax(tm.logits_from(h), -1)
    picked = logp.gather(-1, targets[..., None])[..., 0]
    valid = targets != (pad_id if pad_id is not None else -1)
    ref = -(picked * valid).sum() / valid.sum()
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=RTOL)
    np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL)
    # the gradients through the model equal the logits path's
    grads = torch.autograd.grad(loss, [tm.tok.weight, tm.layers[0].mlp_in
                                       .weight], retain_graph=True)
    refs = torch.autograd.grad(ref, [tm.tok.weight, tm.layers[0].mlp_in
                                     .weight])
    for a, b in zip(grads, refs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=RTOL * float(b.abs().max()))
