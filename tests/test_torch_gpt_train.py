"""Training the ``gpt`` CausalLM: the port against the JAX package.

Both sides start from the same JAX init (carried over with
``load_flax_params``) and see the same batches.  The port runs on the CPU,
where ``--attention flash`` takes the kernels' plain versions; the JAX side
runs its flash path through the Pallas kernels in interpret mode.  Checked:
step-1 gradients per parameter (1e-5 x max|g|), a 3-step loss trajectory
(rtol 1e-4), a 1-epoch ``run_workload`` history (rtol 1e-4), the CLI's log
grammar, and dropout's reproducibility.
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.ops.attention_pallas import \
    make_attention_fn
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train import objectives as jobj
from distributed_deep_learning_tpu.train.state import \
    create_train_state as jcreate
from distributed_deep_learning_tpu.train.step import (make_step_fns as jsteps,
                                                      place_state)
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_lm
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.ops import attention as tat
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
T, BATCH = 16, 8
MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=128, max_len=T)


def _batches(n=3):
    """Three seeded batches; the second has a right-padded row."""
    ds = synthetic_lm(n=BATCH * n, seq_len=T, vocab_size=61, seed=0)
    out = []
    for i in range(n):
        x = ds.features[i * BATCH:(i + 1) * BATCH].copy()
        y = ds.targets[i * BATCH:(i + 1) * BATCH].copy()
        if i == 1:
            x[2, 12:] = 0
            y[2, 11:] = 0
        out.append((x, y))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(attention):
    """JAX side: init, step-1 gradients, and 3 train-step losses."""
    fn = make_attention_fn() if attention == "flash" else None
    model = jtr.CausalLM(**MODEL, with_logits=True, attention_fn=fn)
    state = jcreate(model, jax.random.key(0), jnp.zeros((1, T), jnp.int32),
                    jbase.adamw(1e-3))
    params = jax.tree.map(np.asarray, state.params)
    loss_fn = jobj.token_cross_entropy
    x0, y0 = (jnp.asarray(a) for a in _batches()[0])

    def loss(p):
        pred, _, _ = state.apply_fn(p, state.model_state, x0, train=True)
        return loss_fn(pred, y0)

    grads = jax.tree.map(np.asarray, jax.grad(loss)(state.params))
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    train_step, _ = jsteps(mesh, loss_fn)
    state = place_state(state, mesh)
    losses = []
    for x, y in _batches():
        state, m = train_step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    return params, grads, losses


def _port_state(params, attention, dropout=0.0, dropout_seed=None):
    model = ttr.CausalLM(**MODEL, with_logits=True, attention=attention,
                         dropout_rate=dropout)
    return create_train_state(model, 0, tbase.adamw(1e-3),
                              ttr.load_flax_params(params), device="cpu",
                              dropout_seed=dropout_seed)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_step1_gradients_match_jax(attention):
    params, jgrads, _ = _jax_run(attention)
    state = _port_state(params, attention)
    train_step, _ = make_step_fns(tobj.token_cross_entropy)
    x, y = (torch.from_numpy(a) for a in _batches()[0])
    train_step(state, x, y)
    want = ttr.load_flax_params(jgrads)
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        # 1e-5 of the leaf's largest entry; the 1e-8 floor is for the key
        # biases, whose gradient is zero up to rounding (~1e-10) on both
        # sides, since softmax ignores a per-query constant
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-5 * scale + 1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_three_step_losses_match_jax(attention):
    params, _, jlosses = _jax_run(attention)
    state = _port_state(params, attention)
    train_step, _ = make_step_fns(tobj.token_cross_entropy)
    losses = []
    for x, y in _batches():
        state, m = train_step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert state.step == 3
    assert tat.flash_forward.launches == 0    # CPU: plain versions


def test_flash_model_matches_jax_dense_rope_gqa_window():
    cfg = dict(MODEL, pos_embedding="rope", num_kv_heads=2,
               attention_window=5)
    jm = jtr.CausalLM(**cfg, with_logits=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(3), jnp.zeros((1, T), jnp.int32))["params"])
    x, _ = _batches()[1]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = ttr.CausalLM(**cfg, with_logits=True, attention="flash")
    tm.load_state_dict(ttr.load_flax_params(params))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_run_workload_history_matches_jax(monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = ["-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu"]
    jcfg = jconfig.parse_args(argv, workload="gpt")
    dataset = jns.GPT_SPEC.build_dataset(jcfg)
    params = jns.GPT_SPEC.build_model(jcfg, dataset).init(
        jax.random.key(jcfg.seed),
        jnp.zeros((1, dataset.features.shape[1]), jnp.int32))["params"]
    _, jhist = jbase.run_workload(jns.GPT_SPEC, jcfg)
    _, thist = tbase.run_workload(
        tns.GPT_SPEC, tconfig.parse_args(argv, workload="gpt"),
        init_state_dict=ttr.load_flax_params(jax.tree.map(np.asarray,
                                                          params)))
    assert [(h.phase, h.epoch, h.examples) for h in thist] == \
        [(h.phase, h.epoch, h.examples) for h in jhist]
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=1e-4, err_msg=mine.phase)
    train = thist[0]
    assert len(train.step_losses) == len(train.step_seconds) == 5
    assert all(np.isfinite(train.step_losses))


def test_cli_prints_the_phase_log():
    env = dict(os.environ, DDL_DATA_LIMIT="64")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_learning_tpu_torch", "gpt",
         "-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    ts = r"\d+\.\d{6}"
    ends = rf" ends at {ts} with accuracy \d+\.\d{{3}} and loss \d+\.\d{{9}}"
    for pattern in (rf'^"train epoch 1 begins at {ts}"$',
                    rf'^"train epoch 1{ends}"$',
                    r'^"metrics phase=train epoch=1 examples_per_sec=\S+ '
                    r'examples=\d+"$',
                    rf'^"validation epoch 1{ends}"$',
                    rf'^"test{ends}"$'):
        assert any(re.match(pattern, ln) for ln in lines), pattern


def test_cli_refuses_other_workloads_and_cuda_without_a_card():
    from distributed_deep_learning_tpu_torch.__main__ import main

    with pytest.raises(ValueError, match="unknown workload 'vit'"):
        main(["vit", "-d", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["gpt", "-l", "1", "-s", "32"])


def test_attention_auto_resolves_by_device():
    dense = tconfig.parse_args(["-d", "cpu"], "gpt")
    assert tns._attention_fn(dense) == "dense"
    assert tns._attention_fn(dense.replace(attention="flash")) == "flash"
    if torch.cuda.is_available():
        assert tns._attention_fn(dense.replace(device="cuda")) == "flash"


def test_dropout_is_reproducible_and_changes_the_loss():
    params, _, _ = _jax_run("dense")
    train_step, _ = make_step_fns(tobj.token_cross_entropy)
    x, y = (torch.from_numpy(a) for a in _batches()[0])

    def first_loss(dropout, seed=43):
        state = _port_state(params, "dense", dropout=dropout,
                            dropout_seed=seed)
        before = state.generator.get_state().clone()
        _, m = train_step(state, x, y)
        drew = not torch.equal(before, state.generator.get_state())
        return m["loss"].item(), drew

    a, drew = first_loss(0.1)
    b, _ = first_loss(0.1)
    plain, drew_plain = first_loss(0.0)
    assert a == b and drew
    assert a != plain and not drew_plain       # rate 0 draws nothing
    assert first_loss(0.1, seed=44)[0] != a
