"""The bf16 compute path of the port's CausalLM against the JAX CausalLM
with ``dtype=jnp.bfloat16`` (flax's bf16 compute over f32 parameters).

Both sides start from the same JAX init (``load_flax_params``) and see the
same seeded batches.  ``--attention flash`` runs the kernels' plain
versions here and JAX's Pallas kernels in interpret mode.  Tolerances
(bf16 keeps 8 significant bits, ~4e-3 a rounding, and the two sides round
at different places inside fused ops): logits within 2e-2 of max|ref|;
each gradient leaf within 3e-2 of its norm (relative L2), the key biases,
whose gradient is rounding noise around zero on both sides, against 3e-2
of the query biases' norm; the phase losses of a 3-step ``run_workload``
within 1e-3 relative (measured ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.ops.attention_pallas import \
    make_attention_fn
from distributed_deep_learning_tpu.train import objectives as jobj
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

T = 32
MODEL = dict(vocab_size=61, num_layers=2, d_model=64, num_heads=4,
             mlp_dim=256, max_len=T)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads run them as fast as
    eight, without spinning against the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(seed=0):
    """Seeded tokens and targets; row 1 right-padded."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 61, (4, T)).astype(np.int32)
    y = rng.integers(1, 61, (4, T)).astype(np.int32)
    x[1, 20:] = 0
    y[1, 19:] = 0
    return x, y


def _jax_model(attention):
    fn = make_attention_fn() if attention == "flash" else None
    return jtr.CausalLM(**MODEL, with_logits=True, dtype=jnp.bfloat16,
                        attention_fn=fn)


_PARAMS = {}


def _params():
    if not _PARAMS:
        init = jax.jit(_jax_model("dense").init)(
            jax.random.key(0), jnp.zeros((1, T), jnp.int32))
        _PARAMS.update(jax.tree.map(np.asarray, init["params"]))
    return _PARAMS


def _port_model(attention):
    model = ttr.CausalLM(**MODEL, with_logits=True, attention=attention,
                         dtype=torch.bfloat16)
    model.load_state_dict(ttr.load_flax_params(_params()))
    return model


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_logits_match_jax(attention):
    x, _ = _batch()
    want = np.asarray(jax.jit(_jax_model(attention).apply)(
        {"params": _params()}, jnp.asarray(x)))
    model = _port_model(attention)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32            # the tied head is f32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    model.with_logits = False
    assert model(torch.from_numpy(x)).dtype == torch.bfloat16


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_gradients_match_jax(attention):
    x, y = _batch(1)
    jm = _jax_model(attention)

    def loss(p):
        return jobj.token_cross_entropy(jm.apply({"params": p},
                                                 jnp.asarray(x)),
                                        jnp.asarray(y))

    want = ttr.load_flax_params(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(_params())))
    model = _port_model(attention)
    tobj.token_cross_entropy(model(torch.from_numpy(x)),
                             torch.from_numpy(y)).backward()
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert got[name].grad.dtype == torch.float32, name
        err = float((got[name].grad - g).norm())
        ref = g.norm() if not name.endswith("self_attn.k.bias") else \
            want[name.replace(".k.", ".q.")].norm()
        assert err <= 3e-2 * float(ref), (name, err, float(ref))


def test_bf16_master_weights_and_optimizer_state_stay_f32():
    model = ttr.CausalLM(**MODEL, with_logits=True, dtype=torch.bfloat16)
    state = create_train_state(model, 0, tbase.adamw(1e-3),
                               ttr.load_flax_params(_params()), device="cpu")
    train_step, _ = make_step_fns(tobj.TokenCrossEntropy())
    x, y = _batch(2)
    _, m = train_step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert np.isfinite(m["loss"].item())
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name
    moments = [v for s in state.optimizer.state.values()
               for k, v in s.items() if k != "step"]
    assert moments and all(v.dtype == torch.float32 for v in moments)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_run_workload_matches_jax(attention, monkeypatch):
    """3 train steps (35 rows: 24 train, 3 val, 8 test) through both
    packages' ``run_workload`` under ``--dtype bfloat16``."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "35")
    argv = ["-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu",
            "--dtype", "bfloat16", "--attention", attention]
    jcfg = jconfig.parse_args(argv, workload="gpt")
    dataset = jns.GPT_SPEC.build_dataset(jcfg)
    params = jax.jit(jns.GPT_SPEC.build_model(jcfg, dataset).init)(
        jax.random.key(jcfg.seed),
        jnp.zeros((1, dataset.features.shape[1]), jnp.int32))["params"]
    _, jhist = jbase.run_workload(jns.GPT_SPEC, jcfg)
    state, thist = tbase.run_workload(
        tns.GPT_SPEC, tconfig.parse_args(argv, workload="gpt"),
        init_state_dict=ttr.load_flax_params(jax.tree.map(np.asarray,
                                                          params)))
    assert state.model.dtype == torch.bfloat16
    assert [(h.phase, h.examples) for h in thist] == \
        [(h.phase, h.examples) for h in jhist]
    assert len(thist[0].step_losses) == 3
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=1e-3, err_msg=mine.phase)
