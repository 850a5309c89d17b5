"""The pipelined LM (``-m pipeline`` of ``transformer``, ``bert`` and
``gpt``) against the JAX package's on a ``{"data": 1, "stage": S}`` mesh,
from the same weights (``load_flax_params`` of JAX's ``{"embed", "trunk",
"head"}``, the trunk stacked ``(S, ...)`` or ``(V, S, ...)``).

The forward equals JAX's ``apply_fn`` (1e-5 of max|logit|).  One train
step under ``gpipe`` (JAX's ordinary step over ``spmd_pipeline``),
``1f1b`` and ``interleaved`` (JAX's ``_make_1f1b_train_step``) gives
JAX's loss (1e-5 relative: each schedule keeps its own convention, the
whole batch's token mean or the mean of the microbatch means, which
differ with BERT's pads) and gradients (1e-4 of each leaf's largest; both
steps are SGD at lr 1, so JAX's gradient is its parameters' move).  The
key projection's bias has a zero gradient in exact arithmetic (a softmax
ignores a shift common to a query's logits): both sides' are held below
1e-6 of the model's largest.  (The optimizers' steps on the stacked
layout, and the variants' steps: ``test_torch_pipelined_lm_variants``.)
Cases: ``gpt`` (learned positions; rotary, a window of 5 and 2 KV heads
in the forward), ``bert`` (non-causal, pads attended) and
``transformer`` (the head reads ``take``).  Under ``--dropout`` the
recompute of 1F1B and interleaved replays each (virtual stage,
microbatch)'s masks: gradients equal a plain sequential walk applying
the same generators in turn."""

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.models.pipelined_lm import \
    PipelinedLM as JPipelinedLM
from distributed_deep_learning_tpu.parallel.tensor_parallel import \
    tp_state_spec
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train.objectives import \
    token_cross_entropy
from distributed_deep_learning_tpu.train.state import \
    TrainState as JTrainState
from distributed_deep_learning_tpu.train.step import (make_step_fns,
                                                      place_state)
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu_torch.models.pipelined_lm import \
    PipelinedLM
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.parallel.spmd_pipeline import \
    mb_generator
from distributed_deep_learning_tpu_torch.train import step as tstep
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy
from distributed_deep_learning_tpu_torch.train.state import (Optimizer,
                                                             TrainState)
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

S, LAYERS, D, HEADS, MLP, VOCAB, T, B, MB = 2, 4, 64, 4, 128, 64, 16, 8, 2
LR = 1e-3
CASES = {
    "gpt": dict(causal=True),
    "gpt_rope_window_gqa": dict(causal=True, pos_embedding="rope",
                                attention_window=5, num_kv_heads=2),
    "bert": dict(causal=False),
    "transformer": dict(causal=True, head_take=(7, 8)),
}
SCHEDULES = {"gpipe": 1, "1f1b": 1, "interleaved": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _data(case, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
    if case == "bert":
        tokens[:, -3:] = 0                  # pads, attended in the trunk
    n = 8 if case == "transformer" else T
    targets = rng.integers(1, VOCAB, size=(B, n)).astype(np.int32)
    targets[:, ::3] = 0                     # pad targets, left out
    return tokens, targets


def _jax_model(case, n_chunks=1):
    mesh = build_mesh({"data": 1, "stage": S}, jax.devices()[:S])
    return mesh, JPipelinedLM(
        vocab_size=VOCAB, num_layers=LAYERS, d_model=D, num_heads=HEADS,
        mlp_dim=MLP, mesh=mesh, microbatch_size=MB, n_chunks=n_chunks,
        max_len=T, **CASES[case])


def _port_model(case, n_chunks=1):
    return PipelinedLM(vocab_size=VOCAB, num_layers=LAYERS, d_model=D,
                       num_heads=HEADS, mlp_dim=MLP, n_stages=S,
                       microbatch_size=MB, n_chunks=n_chunks, max_len=T,
                       **CASES[case])


def _init(case, n_chunks):
    mesh, jmodel = _jax_model(case, n_chunks)
    tokens, _ = _data(case)
    params = jmodel.init(jax.random.key(3), tokens[:1])
    # seeded noise on every leaf: no LayerNorm bias or scale sits at its
    # initial 0 or 1, so a wrong mapping or decay cannot hide there
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    model = _port_model(case, n_chunks)
    model.load_state_dict(load_flax_params(jax.tree.map(np.asarray, params)))
    return mesh, jmodel, params, model


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    mesh, jmodel, params, model = _init(case, 1)
    tokens, _ = _data(case)
    want = np.asarray(jax.jit(jmodel.apply_fn)(params, {}, tokens)[0])
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(tokens)).numpy()
        seq = model.apply_sequential(torch.as_tensor(tokens)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(seq, want, rtol=0, atol=1e-5 * scale)


def _jax_step(mesh, jmodel, params, case, schedule, tx):
    tokens, targets = _data(case)
    state = JTrainState.create(apply_fn=jmodel.apply_fn, params=params,
                               tx=tx)
    spec = tp_state_spec(state, jmodel.shard_rules)
    state = place_state(state, mesh, spec)
    if schedule == "gpipe":
        step, _ = make_step_fns(mesh, token_cross_entropy, state_spec=spec)
    else:
        step = jbase._make_1f1b_train_step(
            mesh, jmodel, token_cross_entropy, spec, MB,
            interleaved=schedule == "interleaved")
    state, metrics = step(state, tokens, targets)
    return float(metrics["loss"]), jax.tree.map(np.asarray, state.params)


def _port_step(model, case, schedule, tx):
    tokens, targets = _data(case)
    state = TrainState(model=model, tx=tx,
                       optimizer=tx.build(model.named_parameters(),
                                          layout=model.flax_layout))
    loss_fn = TokenCrossEntropy()
    if schedule == "gpipe":
        step, _ = tstep.make_step_fns(loss_fn)
    else:
        step = tbase._make_1f1b_train_step(
            model, loss_fn, MB, interleaved=schedule == "interleaved")
    _, metrics = step(state, torch.as_tensor(tokens),
                      torch.as_tensor(targets))
    return metrics["loss"].item()


def _grads_of_one_step(case, schedule):
    """JAX's and the port's gradients of one step (as port state dicts)
    and the two losses."""
    mesh, jmodel, params, model = _init(case, SCHEDULES[schedule])
    init = load_flax_params(jax.tree.map(np.asarray, params))
    # JAX's step donates its state
    jloss, jparams = _jax_step(mesh, jmodel, params, case, schedule,
                               optax.sgd(1.0))
    loss = _port_step(model, case, schedule, Optimizer("sgd", 1.0))
    moved = load_flax_params(jparams)
    want = {k: init[k] - moved[k] for k in init}
    got = {k: p.grad for k, p in model.named_parameters()}
    return jloss, loss, want, got


def check_step(case, schedule):
    """One step of ``case`` under ``schedule``: losses and gradients."""
    jloss, loss, want, got = _grads_of_one_step(case, schedule)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    rotary = CASES[case].get("pos_embedding") == "rope"
    for k, v in want.items():
        if k.endswith("self_attn.k.bias") and not rotary:
            assert float(v.abs().max()) <= 1e-6 * top, k
            assert float(got[k].abs().max()) <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(
            got[k].numpy(), v.numpy(), rtol=0,
            atol=1e-4 * float(v.abs().max()), err_msg=k)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("case", ["gpt", "bert"])
def test_train_step_matches_jax(case, schedule):
    check_step(case, schedule)


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved"])
def test_dropout_recompute_matches_sequential_replay(schedule):
    """``--dropout 0.3``: the pipeline's loss and gradients equal a plain
    sequential walk of each microbatch through every virtual stage with
    that (virtual stage, microbatch)'s generator, the sum of microbatch
    means over M; a different seed gives other gradients."""
    from torch.func import functional_call

    V = SCHEDULES[schedule]
    torch.manual_seed(0)
    model = PipelinedLM(vocab_size=VOCAB, num_layers=LAYERS, d_model=D,
                        num_heads=HEADS, mlp_dim=MLP, n_stages=S,
                        microbatch_size=MB, n_chunks=V, max_len=T,
                        causal=True, dropout_rate=0.3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    tokens, targets = (torch.as_tensor(a) for a in _data("gpt"))
    loss_fn = TokenCrossEntropy()
    gen = torch.Generator().manual_seed(11)
    seed = int(torch.randint(0, 2 ** 62, (1,),
                             generator=torch.Generator().manual_seed(11)))
    state = TrainState(model=model, tx=Optimizer("sgd", 0.0),
                       optimizer=Optimizer("sgd", 0.0).build(
                           model.named_parameters()), generator=gen)
    step = tbase._make_1f1b_train_step(model, loss_fn, MB,
                                       interleaved=V > 1)
    loss = step(state, tokens, targets)[1]["loss"].item()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}

    model.zero_grad()
    h = model.embed(tokens)
    total = 0.0
    M = B // MB
    for m in range(M):
        x = h[m * MB:(m + 1) * MB]
        for v in range(S * V):
            x = model.trunk.stage_fn(model.trunk.stage_params(v), x,
                                     mb_generator(seed, v, m, "cpu"))
        logits = functional_call(model.head,
                                 dict(model.head.named_parameters()), (x,))
        total = total + loss_fn(logits, targets[m * MB:(m + 1) * MB])
    (total / M).backward()
    np.testing.assert_allclose(loss, (total / M).item(), rtol=1e-6)
    for k, p in model.named_parameters():
        torch.testing.assert_close(got[k], p.grad, rtol=1e-5, atol=1e-7,
                                   msg=k)
    # the masks matter: without them the gradients differ
    model.zero_grad()
    plain = loss_fn(model.train().apply_sequential(tokens), targets)
    assert abs(plain.item() - loss) > 1e-4
