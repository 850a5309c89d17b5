"""The ``moe`` workload's model (``models/moe.py``) and its train step in
the port against the JAX package's, on the CPU, from the same weights
(``load_flax_params``) and numpy-seeded inputs:

* ``top2_gating`` at capacities that drop tokens (positions past the
  capacity, where ``jax.nn.one_hot`` gives a zero row and torch's raises)
  and with forced ties among the first and second choices: dispatch,
  combine and the load-balance loss within 1e-6.
* ``MoEMLP``'s forward and the gradients of the router, ``w_in`` and
  ``w_out`` (objective: a seeded cotangent plus the sown aux): 1e-5.
* ``MoELM`` in eval and train mode with its sown aux: f32 within 1e-5,
  bf16 within 2e-2 (the residual stream f32 from the first routed layer
  on in both).
* One train step (SGD, so the update is the gradient) against JAX's
  ``create_train_state``/``make_step_fns`` step: the logged loss is the
  task loss, and the update carries the aux term.
* ``--remat`` under both policies leaves the step's gradients unchanged
  (the recompute in the backward sows into no collection, so the aux is
  counted once).
* The refusals: ``-m model|pipeline`` and ``--generate`` with JAX's
  messages, the three gpt-only flags, and fault 5's four cases on the
  workloads JAX refuses them on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.models import moe as jmoe
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train.objectives import \
    token_cross_entropy as jtoken_ce
from distributed_deep_learning_tpu.train.state import \
    create_train_state as jcreate
from distributed_deep_learning_tpu.train.step import \
    make_step_fns as jmake_step_fns
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.models import moe as tmoe
from distributed_deep_learning_tpu_torch.models.layers import collect_losses
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

#: the test model: 4 layers (two routed), d 32, 2 heads, 8 experts
LM = dict(vocab_size=61, num_layers=4, d_model=32, num_heads=2, mlp_dim=64,
          num_experts=8)
B, T = 4, 12
LR = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def mlm_batch(seed=0, b=B, t=T, vocab=LM["vocab_size"]):
    """Token ids with a ragged pad tail (id 0) and MLM targets at ~30% of
    the real positions (0 elsewhere: not counted)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (b, t)).astype(np.int32)
    for r, n in enumerate(rng.integers(0, t // 3, b)):
        if n:
            x[r, t - n:] = 0
    y = np.where((rng.random((b, t)) < 0.3) & (x != 0),
                 rng.integers(1, vocab, (b, t)), 0).astype(np.int32)
    return x, y


# --- gating ------------------------------------------------------------------

def _tied_logits(seed, G, E):
    """Seeded logits with exact ties: rows whose two largest entries are
    equal (a first-choice tie) and rows whose second and third are equal
    (a second-choice tie)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(G, E)).astype(np.float32)
    for r in range(0, G, 5):
        order = np.argsort(-logits[r])
        logits[r, order[1]] = logits[r, order[0]]
    for r in range(2, G, 7):
        order = np.argsort(-logits[r])
        logits[r, order[2]] = logits[r, order[1]]
    # a crowd on expert 0, so its queue overflows the capacity
    logits[: G // 2, 0] += 3.0
    return logits


@pytest.mark.parametrize("capacity", [1, 3, 6, 64])
def test_top2_gating_matches_jax(capacity):
    G, E = 40, 8
    logits = _tied_logits(capacity, G, E)
    jd, jc, ja = jmoe.top2_gating(jnp.asarray(logits), capacity)
    td, tc, ta = tmoe.top2_gating(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    kept = float(td.sum())
    assert kept <= min(2 * G, E * capacity)
    if capacity < 64:
        assert kept < 2 * G             # tokens were dropped
    else:
        assert kept == 2 * G


def test_tied_rows_pick_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 0.5, 2.0, 2.0]])
    d, _, _ = tmoe.top2_gating(logits, capacity=4)
    chosen = d.sum(-1)                   # (G, E): 1 where routed
    assert chosen[0].tolist() == [0.0, 1.0, 1.0, 0.0]
    assert chosen[1].tolist() == [1.0, 0.0, 1.0, 0.0]


# --- MoEMLP ------------------------------------------------------------------

def _torch_mlp(jparams, d, E, m, cf, dtype=torch.float32):
    mlp = tmoe.MoEMLP(d, E, m, cf, dtype)
    p = _np(jparams)
    sd = {"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
          "router.bias": torch.tensor(p["router"]["bias"]),
          "w_in": torch.tensor(p["w_in"]),
          "w_out": torch.tensor(p["w_out"])}
    mlp.load_state_dict(sd)
    return mlp


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_mlp_forward_and_gradients_match_jax(cf):
    d, E, m = 16, 4, 32
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    ct = rng.normal(size=(2, 6, d)).astype(np.float32)
    jm = jmoe.MoEMLP(num_experts=E, mlp_dim=m, capacity_factor=cf)
    jp = jm.init(jax.random.key(1), jnp.asarray(x))["params"]

    def jobjective(p):
        out, st = jm.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        (aux,) = st["losses"]["moe_aux_loss"]
        return jnp.sum(out * ct) + aux, out

    (_, jout), jg = jax.value_and_grad(jobjective, has_aux=True)(jp)
    mlp = _torch_mlp(jp, d, E, m, cf)
    with collect_losses() as sown:
        out = mlp(torch.from_numpy(x))
    assert len(sown) == 1 and out.dtype == torch.float32
    (torch.sum(out * torch.from_numpy(ct)) + sown[0]).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    jg = _np(jg)
    for got, want in ((mlp.router.weight.grad.T, jg["router"]["kernel"]),
                      (mlp.router.bias.grad, jg["router"]["bias"]),
                      (mlp.w_in.grad, jg["w_in"]),
                      (mlp.w_out.grad, jg["w_out"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# --- MoELM -------------------------------------------------------------------

def _models(dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = jmoe.MoELM(**LM, dtype=jdt)
    x, _ = mlm_batch()
    jp = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    tm = tmoe.MoELM(**LM, dtype=tdt)
    tm.load_state_dict(load_flax_params(_np(jp)))
    return jm, jp, tm


def test_flax_tree_maps_onto_the_port():
    _, jp, tm = _models()
    assert sorted(jp) == ["embed", "final_norm", "layer_0", "layer_2",
                          "moe_layer_1", "moe_layer_3"]
    assert isinstance(tm.layers[1], tmoe.MoETransformerLayer)
    assert not isinstance(tm.layers[2], tmoe.MoETransformerLayer)
    assert not hasattr(tm, "mlm_dense")
    sd = load_flax_params(_np(jp))
    assert sorted(sd) == sorted(tm.state_dict())
    assert tuple(sd["layers.1.moe.w_in"].shape) == (8, 32, 64)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("train", [False, True])
def test_moe_lm_matches_jax(dtype, tol, train):
    jm, jp, tm = _models(dtype)
    x, _ = mlm_batch(3)
    if train:
        jout, st = jm.apply({"params": jp}, jnp.asarray(x), train=True,
                            mutable=["losses"])
        jaux = sum(float(a) for a in jax.tree.leaves(st["losses"]))
    else:
        jout = jm.apply({"params": jp}, jnp.asarray(x))
    tm.train(train)
    with torch.no_grad(), collect_losses() as sown:
        out = tm(torch.from_numpy(x))
    jout = np.asarray(jout, np.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=tol * np.abs(jout).max())
    assert len(sown) == 2
    if train:
        np.testing.assert_allclose(float(sum(sown)), jaux, rtol=tol)


def test_bf16_residual_stream_turns_f32_at_the_first_routed_layer():
    _, _, tm = _models("bfloat16")
    seen = []
    for layer in tm.layers:
        layer.register_forward_hook(
            lambda mod, args, out: seen.append(out.dtype))
    with torch.no_grad():
        tm(torch.from_numpy(mlm_batch()[0]))
    assert seen == [torch.bfloat16] + [torch.float32] * 3


# --- the train step ----------------------------------------------------------

def _jax_step(jm, jp, x, y):
    """JAX's train step (SGD at ``LR``) on one device: the updated params,
    its logged loss, and the objective loss + aux at the initial params."""
    state = jcreate(jm, jax.random.key(0), jnp.asarray(x[:1]),
                    optax.sgd(LR))
    # the step donates its state: hand it a copy of the params
    state = state.replace(params=jax.tree.map(jnp.array, jp))
    pred, _, aux = state.apply_fn(jp, state.model_state, jnp.asarray(x),
                                  train=True)
    objective = float(jtoken_ce(pred, jnp.asarray(y))) + float(aux)
    step, _ = jmake_step_fns(build_mesh({"data": 1}, jax.devices()[:1]),
                             jtoken_ce)
    new, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
    return _np(new.params), float(metrics["loss"]), objective, float(aux)


def _torch_state(jp, **kw):
    return create_train_state(tmoe.MoELM(**LM, **kw), 0,
                              Optimizer("sgd", LR),
                              load_flax_params(_np(jp)), device="cpu")


def test_train_step_matches_jax():
    jm, jp, _ = _models()
    x, y = mlm_batch(5)
    before = load_flax_params(_np(jp))
    jnew, jloss, jobjective, jaux = _jax_step(jm, jp, x, y)
    state = _torch_state(jp)
    step, _ = make_step_fns(TokenCrossEntropy())
    state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert jaux > 0
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-6)
    assert abs(jobjective - jloss - jaux) < 1e-6     # the aux is not logged
    got = state.model.state_dict()
    for k, want in load_flax_params(jnew).items():
        # SGD: (before - after) / LR is the gradient
        g_want = (before[k] - want).numpy() / LR
        g_got = (before[k] - got[k]).numpy() / LR
        np.testing.assert_allclose(g_got, g_want, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(g_want).max()),
                                   err_msg=k)
    # the update carries the aux term: the task loss alone (a forward
    # outside any collection) moves the router otherwise
    plain = _torch_state(jp)
    TokenCrossEntropy()(plain.model.train()(torch.from_numpy(x)),
                        torch.from_numpy(y)).backward()
    r = "layers.1.moe.router.weight"
    g_task = plain.model.get_parameter(r).grad.numpy()
    g_step = (before[r] - got[r]).numpy() / LR
    assert np.abs(g_step - g_task).max() > 1e-6


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_keeps_gradients_and_counts_aux_once(policy):
    _, jp, _ = _models()
    x, y = map(torch.from_numpy, mlm_batch(6))
    grads = []
    for remat in (False, True):
        state = _torch_state(jp)
        step, _ = make_step_fns(TokenCrossEntropy(), remat=remat,
                                remat_policy=policy)
        step(state, x, y)
        grads.append({k: p.grad.clone()
                      for k, p in state.model.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=1e-6,
                                   msg=k)


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("workload,flags", [
    ("moe", ["-m", "model"]), ("moe", ["-m", "pipeline"]),
    ("moe", ["--generate", "4"]), ("moe", ["--pos", "rope"]),
    ("moe", ["--window", "8"]), ("moe", ["--kv-heads", "1"]),
    ("mlp", ["--label-smoothing", "0.1"]), ("bert", ["--window", "8"]),
    ("resnet", ["--kv-heads", "2"]), ("bert", ["--pos", "rope"]),
])
def test_refusals_match_jax(workload, flags, monkeypatch):
    """``moe``'s refusals, and the four flags the JAX runner refuses
    outside ``gpt`` or the token-CE workloads: the same ``ValueError``,
    message for message."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    argv = ["-l", "2", "-s", "32", "-e", "1", "-d", "cpu", *flags]
    with pytest.raises(ValueError) as theirs:
        jbase.run_workload(jget(workload),
                           jconfig.parse_args(argv, workload))
    with pytest.raises(ValueError) as mine:
        tbase.run_workload(tget(workload),
                           tconfig.parse_args(argv, workload))
    assert str(mine.value) == str(theirs.value)
