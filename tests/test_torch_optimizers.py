"""``--optimizer lamb|adafactor``: the port's optax-semantics optimizers
against optax on the same small CausalLM.

A CausalLM of d 128, MLP 256, 2 layers and 4 heads (so Adafactor factors
the MLP kernels and the tables, whose flax shapes have two axes of at
least 128, and not the q/k/v/out kernels, whose flax shapes ``(d, H, hd)``
and ``(H, hd, d)`` have a second-largest axis of 32) starts from the JAX
init on both sides (``load_flax_params``), and each side steps the
optimizer its package's ``build_optimizer`` makes of the same command line.
After every one of 6 steps the parameters agree within 1e-5 (absolute;
they are O(0.1)).  Both optimizers are fed the JAX gradients of the token
cross-entropy on one batch (mapped to the torch layout by the bridge), so
the comparison is of the optimizers.  LAMB also runs on each side's own
gradients; Adafactor cannot: the key bias's exact gradient is zero (a
softmax does not see a shift of all its logits), each package's is
rounding noise of either sign, and at step 1 Adafactor moves each element
by ``lr * 1e-3 * sign(g)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_deep_learning_tpu.models.transformer import CausalLM as JLM
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, load_flax_params)
from distributed_deep_learning_tpu_torch.train.state import Adafactor
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=256, num_layers=2, d_model=128, num_heads=4,
             mlp_dim=256, max_len=32)
STEPS, ATOL = 6, 1e-5


def _setup(optimizer):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, MODEL["vocab_size"], size=(4, 17)).astype(np.int32)
    jm = JLM(**MODEL)
    params = jm.init(jax.random.key(0), jnp.asarray(toks[:, :-1]))["params"]
    argv = ["--optimizer", optimizer, "--lr", "0.01"]
    jtx = jbase.build_optimizer(jns.GPT_SPEC,
                                jconfig.parse_args(argv, "gpt"), 1)
    tm = CausalLM(**MODEL)
    tm.load_state_dict(load_flax_params(jax.tree.map(np.asarray, params)))
    ttx = tbase.build_optimizer(tns.GPT_SPEC,
                                tconfig.parse_args(argv, "gpt"), 1)
    return toks, jm, params, jtx, tm, ttx


def _jax_loss(jm, toks):
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])

    def loss(params):
        h = jm.apply({"params": params}, x, train=False)
        logits = jm.logits_from({"params": params}, h)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
    return jax.jit(jax.grad(loss))


def _torch_loss(tm, toks):
    t = torch.from_numpy(toks).long()
    logits = tm.logits_from(tm(t[:, :-1]))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           t[:, 1:].reshape(-1))


def _trajectory(optimizer, own_gradients):
    toks, jm, params, jtx, tm, ttx = _setup(optimizer)
    jstate, grad = jtx.init(params), _jax_loss(jm, toks)
    opt = ttx.build(tm.named_parameters(), layout=tm.flax_layout)
    named = dict(tm.named_parameters())
    for step in range(STEPS):
        g = grad(params)
        updates, jstate = jtx.update(g, jstate, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        if own_gradients:
            _torch_loss(tm, toks).backward()
        else:
            for name, t in load_flax_params(
                    jax.tree.map(np.asarray, g)).items():
                named[name].grad = t
        opt.step()
        want = load_flax_params(jax.tree.map(np.asarray, params))
        for name, p in tm.state_dict().items():
            np.testing.assert_allclose(
                p.numpy(), want[name].numpy(), rtol=0, atol=ATOL,
                err_msg=f"{optimizer} step {step + 1}: {name}")


@pytest.mark.parametrize("optimizer", ["lamb", "adafactor"])
def test_trajectory_matches_optax(optimizer):
    _trajectory(optimizer, own_gradients=False)


def test_lamb_trajectory_on_own_gradients_matches_optax():
    _trajectory("lamb", own_gradients=True)


def test_adafactor_factors_the_flax_shapes():
    """The leaves Adafactor factors are optax's on the flax parameters:
    the MLP kernels and the tables, not q/k/v/out (whose torch weights
    are (128, 128) and would be)."""
    toks, jm, params, jtx, tm, ttx = _setup("adafactor")
    jstate = jtx.init(params)
    factored_jax = {
        jax.tree_util.keystr(path) for path, leaf in
        jax.tree_util.tree_leaves_with_path(jstate[0].v_row)
        if leaf.shape != (1,)}
    opt = ttx.build(tm.named_parameters(), layout=tm.flax_layout)
    assert isinstance(opt, Adafactor)
    opt.zero_grad()
    _torch_loss(tm, toks).backward()
    opt.step()
    names = {p: n for n, p in tm.named_parameters()}
    factored = sorted(names[p] for p, st in opt.state.items()
                      if "v_row" in st)
    assert factored == ["layers.0.mlp_in.weight", "layers.0.mlp_out.weight",
                        "layers.1.mlp_in.weight", "layers.1.mlp_out.weight",
                        "tok.weight"]
    assert len(factored_jax) == len(factored)
    for name in ("layers.0.self_attn.q.weight",
                 "layers.0.self_attn.out.weight"):
        assert tuple(dict(tm.named_parameters())[name].shape) == (128, 128)
    # its state is smaller than AdamW's two moments
    state_numel = sum(t.numel() for st in opt.state.values()
                      for t in st.values() if torch.is_tensor(t))
    assert state_numel < sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("optimizer", ["lamb", "adafactor"])
def test_optimizer_flag_parses_as_jax(optimizer):
    argv = ["--optimizer", optimizer]
    assert tconfig.parse_args(argv, "gpt").optimizer == \
        jconfig.parse_args(argv, "gpt").optimizer == optimizer
    tx = tbase.build_optimizer(tns.GPT_SPEC, tconfig.parse_args(argv, "gpt"),
                               1)
    assert tx.kind == optimizer
    assert tx.weight_decay == (1e-2 if optimizer == "lamb" else 0.0)
