"""The anomaly sentinel (``train/sentinel.py``) against the JAX package's.

The same poisoned and spiked batches (one seeded ``ChaosPlan``, so the
same NaN sites) go through JAX's ``fit`` and the port's, from the same
MLP weights (``load_flax_variables``), SGD at 0.05: every step's anomaly
code equals JAX's (a NaN batch is NONFINITE, a batch blown up 1e6x after
warm-up is GRAD_SPIKE), the final parameters agree within 1e-6 and the
sentinel's running means (JAX's carried across by
``SentinelState.from_flax``) within 1e-5.  In
the port a contained step leaves the state bit-identical to a run that
never trained the batch (parameters, optimizer state, update count,
dropout generator and BatchNorm statistics: ``diff_trees`` over
``state_tree``); ``halt`` raises within one step, naming the batch;
``--sentinel`` refusals are JAX's, message for message; the CLI trains
``mlp -m data --sentinel skip`` with no anomaly on clean data."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.data.datasets import \
    synthetic_mqtt as jmqtt
from distributed_deep_learning_tpu.data.loader import \
    make_loaders as jloaders
from distributed_deep_learning_tpu.data.splits import \
    train_val_test_split as jsplit
from distributed_deep_learning_tpu.models.mlp import MLP as JMLP
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train import loop as jloop
from distributed_deep_learning_tpu.train.objectives import \
    cross_entropy_loss as jce
from distributed_deep_learning_tpu.train.sentinel import (
    SentinelConfig as JSentinelConfig, attach_sentinel as jattach)
from distributed_deep_learning_tpu.train.state import \
    create_train_state as jcreate
from distributed_deep_learning_tpu.train.step import (make_step_fns as
                                                      jsteps, place_state)
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_mqtt
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from distributed_deep_learning_tpu_torch.models.mlp import (
    MLP, load_flax_variables)
from distributed_deep_learning_tpu_torch.train import sentinel as tsent
from distributed_deep_learning_tpu_torch.train.loop import fit
from distributed_deep_learning_tpu_torch.train.objectives import \
    cross_entropy_loss
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.chaos import (ChaosEvent,
                                                             ChaosPlan)
from distributed_deep_learning_tpu_torch.utils.determinism import (
    diff_trees, state_tree)
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SPE = 11                 # 1024 rows -> 716 train examples -> 11 of 64
EVENTS = [(5, "nan_batch", 0.0), (SPE + 3, "grad_spike", 1e6)]


def _jax_params():
    model = JMLP(hidden_size=16)
    state = jcreate(model, jax.random.key(7), jnp.zeros((1, 48)),
                    optax.sgd(0.05))
    return model, jax.tree.map(np.asarray, state.params)


def _recording(step, codes):
    """``step`` that appends each step's anomaly code to ``codes``."""
    def run(state, x, y):
        state, m = step(state, x, y)
        codes.append(int(float(m["anomaly_code"])))
        return state, m
    return run


def _plan(cls, event_cls):
    return cls([event_cls(step=s, kind=k, magnitude=mag)
                for s, k, mag in EVENTS], seed=3)


def _jax_run():
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    ds = jmqtt(1024, seed=21)
    loaders = jloaders(ds, jsplit(len(ds), seed=42), 64, mesh)
    model, _ = _jax_params()
    state = jcreate(model, jax.random.key(7), jnp.zeros((1, 48)),
                    optax.sgd(0.05))
    state = place_state(jattach(state), mesh)
    cfg = JSentinelConfig(policy="skip", warmup_steps=2)
    step, ev = jsteps(mesh, jce, sentinel=cfg)
    codes = []
    state, _ = jloop.fit(state, _recording(step, codes), ev, *loaders,
                         epochs=2, sentinel=cfg,
                         chaos=_plan(jchaos.ChaosPlan, jchaos.ChaosEvent))
    return codes, jax.tree.map(np.asarray, jax.device_get(state.params)), \
        jax.device_get(state.sentinel)


def _port_setup(policy="skip"):
    ds = synthetic_mqtt(1024, seed=21)
    loaders = make_loaders(ds, train_val_test_split(len(ds), seed=42), 64,
                           "cpu")
    assert len(loaders[0]) == SPE
    _, params = _jax_params()
    init = load_flax_variables({"params": params})
    cfg = tsent.SentinelConfig(policy=policy, warmup_steps=2)

    def make_state():
        state = create_train_state(MLP(48, hidden_size=16), 7,
                                   Optimizer("sgd", 0.05), init,
                                   device="cpu")
        return tsent.attach_sentinel(state)

    return make_state, make_step_fns(cross_entropy_loss, sentinel=cfg), \
        loaders, cfg


def test_codes_and_parameters_match_jax():
    make_state, (step, ev), loaders, cfg = _port_setup()
    codes = []
    state, _ = fit(make_state(), _recording(step, codes), ev, *loaders,
                   epochs=2, sentinel=cfg,
                   chaos=_plan(ChaosPlan, ChaosEvent))
    want_codes, want, want_sen = _jax_run()
    assert codes == want_codes
    theirs = tsent.SentinelState.from_flax(want_sen)
    assert (state.sentinel.count, state.sentinel.anomalies) == \
        (theirs.count, theirs.anomalies) == (2 * SPE - 2, 2)
    np.testing.assert_allclose([state.sentinel.grad_ema,
                                state.sentinel.loss_ema],
                               [theirs.grad_ema, theirs.loss_ema],
                               rtol=1e-5)
    assert codes[4] == tsent.NONFINITE and codes[SPE + 2] == tsent.GRAD_SPIKE
    assert sum(c != tsent.OK for c in codes) == 2
    assert state.sentinel.anomalies == 2 and state.step == 2 * SPE - 2
    got = state.model.state_dict()
    ref = load_flax_variables({"params": want})
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_contained_step_is_bit_identical_to_the_skip_set_run():
    make_state, (step, ev), loaders, cfg = _port_setup()
    plan = ChaosPlan([ChaosEvent(step=5, kind="nan_batch")], seed=1)
    chaos, _ = fit(make_state(), step, ev, *loaders, epochs=2,
                   sentinel=cfg, chaos=plan)
    ref, _ = fit(make_state(), step, ev, *loaders, epochs=2, sentinel=cfg,
                 skip_steps={5})
    assert plan.fired == [(5, "nan_batch")]
    assert diff_trees(state_tree(chaos), state_tree(ref)) == []
    assert chaos.step == ref.step == 2 * SPE - 1
    assert chaos.sentinel.anomalies == 1 and ref.sentinel.anomalies == 0


class _DrawingNet(torch.nn.Module):
    """A BatchNorm model whose forward draws from the step's generator
    (as dropout does)."""

    def __init__(self):
        super().__init__()
        self.body = torch.nn.Sequential(torch.nn.Linear(8, 8),
                                        torch.nn.BatchNorm1d(8),
                                        torch.nn.Linear(8, 3))

    def reset_parameters(self, generator=None):
        return self

    def forward(self, x, generator=None):
        torch.rand(1, generator=generator)
        return self.body(x)


def test_contained_step_restores_generator_and_buffers():
    """A step that draws dropout masks and moves BatchNorm statistics,
    contained: both are as the step found them."""
    state = tsent.attach_sentinel(create_train_state(
        _DrawingNet(), 0, Optimizer("sgd", 0.1), device="cpu",
        dropout_seed=5))

    def loss_fn(pred, y):
        return cross_entropy_loss(pred, y)

    step, _ = make_step_fns(loss_fn, sentinel=tsent.SentinelConfig(
        warmup_steps=1))
    x = torch.randn(4, 8)
    y = torch.nn.functional.one_hot(torch.arange(4) % 3, 3).float()
    state, _ = step(state, x, y)
    before = state_tree(state)
    state, m = step(state, x * float("nan"), y)
    assert float(m["anomaly_code"]) == tsent.NONFINITE
    assert float(m["count"]) == 0.0
    assert diff_trees(state_tree(state), before) == []


def test_halt_raises_within_one_step():
    make_state, (step, ev), loaders, cfg = _port_setup("halt")
    plan = ChaosPlan([ChaosEvent(step=7, kind="nan_batch")], seed=2)
    trained = []

    def counting(state, x, y):
        trained.append(1)
        return step(state, x, y)
    with pytest.raises(tsent.AnomalyError) as e:
        fit(make_state(), counting, ev, *loaders, epochs=2, sentinel=cfg,
            chaos=plan)
    assert e.value.global_step == 7 and e.value.policy == "halt"
    assert e.value.code == tsent.NONFINITE
    assert len(trained) == 8               # the verdict read one step late


@pytest.mark.parametrize("workload,argv", [
    ("mlp", ["-m", "data", "--sentinel", "skip", "--grad-accum", "2"]),
    ("mlp", ["-m", "data", "--sentinel", "halt", "--grad-compress",
             "int8"]),
    ("gpt", ["-m", "pipeline", "--sentinel", "skip", "-l", "2", "-s",
             "32"]),
    ("mlp", ["-m", "model", "--sentinel", "skip", "--elastic",
             "--heartbeat-dir", "hb", "--zero", "1"]),
])
def test_sentinel_refusals_match_jax(workload, argv, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = argv + ["-e", "1", "-b", "8", "-d", "cpu"]
    with pytest.raises(ValueError) as theirs:
        jbase.run_workload(jget(workload),
                           jconfig.parse_args(argv, workload=workload))
    with pytest.raises(ValueError) as mine:
        tbase.run_workload(tget(workload),
                           tconfig.parse_args(argv, workload=workload))
    assert str(mine.value) == str(theirs.value)


def test_sentinel_cli_end_to_end(monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "512")
    state, history = tbase.run_workload(
        tget("mlp"), tconfig.parse_args(
            ["-e", "1", "-b", "64", "-m", "data", "--sentinel", "skip",
             "-d", "cpu"], workload="mlp"))
    assert np.isfinite(history[-1].loss)
    assert state.sentinel.anomalies == 0 and state.sentinel.count > 0
