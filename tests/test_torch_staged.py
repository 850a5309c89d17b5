"""Staged MPMD training (``-m model``, ``-m pipeline`` for the workloads
without a pipelined LM) against the JAX package's ``StagedTrainer``: the
same per-stage weights (``load_flax_stages``), one train step on the same
batch, then the loss, every parameter (within 1e-4 of its largest
element) and the BatchNorm statistics.  The initial weights are JAX's
plus seeded noise (0.05 a weight), so no leaf starts at zero: a zero
bias or BatchNorm scale would make a leaf's largest element one step's
update, and the limit a limit on summation order.  The step is SGD at lr
0.01 (cnn's first step), whose update is the gradient scaled: Adam's
first update is ``lr·g / (|g| + eps)``, which turns f32 summation noise
in a near-zero gradient into a move of up to ``lr`` (each optimizer is
held against optax in ``test_torch_optimizers`` and the workloads'
recipes in ``test_torch_workloads``).  ``-p 3`` on a batch of 8 leaves a
ragged last chunk; ``--clip-norm`` clips each stage by its own norm."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.parallel.partition import \
    validate_assignment as jvalidate
from distributed_deep_learning_tpu.parallel.staging import \
    StagedModel as JStagedModel
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.parallel.mpmd import MPMDPipeline
from distributed_deep_learning_tpu_torch.parallel.staging import (
    StagedModel, load_flax_stages)
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from distributed_deep_learning_tpu_torch.workloads.base import staged_setup
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

BATCH = 8
#: DenseNet-BC and ResNet-18 in ``test_torch_staged_cnn`` and
#: ``test_torch_staged_resnet``
WORKLOADS = {"mlp": [], "lstm": [], "mnist": []}
MODES = {"model": ["-m", "model", "--nstages", "2"],
         "pipeline": ["-m", "pipeline", "--nstages", "2", "-p", "3"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_staged(workload, argv):
    """JAX's trainer and initial state for ``argv``, built as its
    ``run_workload`` builds them (stage ``i`` on CPU device ``i``)."""
    import optax

    cfg = jconfig.parse_args(argv, workload=workload)
    spec = jget(workload)
    dataset = spec.build_dataset(cfg)
    layers = list(spec.build_layers(cfg, dataset))
    n = cfg.num_stages
    staged = JStagedModel.from_layers(
        layers, jvalidate(spec.partitioner(len(layers), n), n), n)
    tx = jbase.build_optimizer(spec, cfg, 10)
    if cfg.clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(cfg.clip_norm), tx)
    micro = cfg.microbatch if cfg.mode.value == "pipeline" else None
    trainer = jbase.StagedTrainer(staged, jax.devices()[:n],
                                  spec.build_loss(cfg), tx,
                                  microbatch_size=micro)
    state = trainer.init(jax.random.key(cfg.seed),
                         spec.example_input(cfg, dataset))
    rng = np.random.default_rng(0)
    params = [jax.device_put(jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        p), d) for p, d in zip(state.params, trainer.devices)]
    return trainer, dataclasses.replace(state, params=params), dataset


def _variables(state):
    return [jax.tree.map(np.asarray, {"params": p, **ms})
            for p, ms in zip(state.params, state.model_state)]


def _one_step(workload, argv):
    """``(JAX loss, port loss, JAX's updated state as the port's state
    dict, the port's)`` after one step from the same weights."""
    jtrainer, jstate, dataset = _jax_staged(workload, argv)
    init = _variables(jstate)
    x, y = dataset.batch(np.arange(BATCH))
    jstate, jmetrics = jtrainer.train_step(jstate, x, y)
    cfg = tconfig.parse_args(argv + ["-d", "cpu"], workload=workload)
    trainer, state, _, _ = staged_setup(tget(workload), cfg,
                                        PhaseLogger(verbose=False))
    trainer.staged.load_state_dict(load_flax_stages(init, trainer.staged))
    state, metrics = trainer.train_step(state, torch.as_tensor(x),
                                        torch.as_tensor(y))
    want = load_flax_stages(_variables(jstate), trainer.staged)
    return (float(jmetrics["loss"]), metrics["loss"].item(), want,
            trainer.staged.state_dict())


def check_step(workload, argv):
    """One SGD step of ``workload`` under ``argv``, the port against JAX."""
    argv = argv + ["-b", str(BATCH), "--optimizer", "sgd", "--lr", "0.01"]
    jloss, loss, want, got = _one_step(workload, argv)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(got) == set(want) | {k for k in got
                                    if k.endswith("num_batches_tracked")}
    for k, v in want.items():
        top = max(float(v.abs().max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * top, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_staged_step_matches_jax(workload, mode):
    check_step(workload, WORKLOADS[workload] + MODES[mode])


def test_staged_clip_norm_is_per_stage():
    """``--clip-norm`` small enough to clip every stage: the port clips
    each stage by its own norm, as the JAX trainer's per-stage optax
    chain does (a global norm would move the stages otherwise)."""
    argv = ["-m", "pipeline", "--nstages", "3", "-p", "3", "-b",
            str(BATCH), "--clip-norm", "1e-3", "--optimizer", "sgd",
            "--lr", "1.0"]
    jloss, loss, want, got = _one_step("mlp", argv)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    init = _one_step("mlp", argv[:-4] + ["--optimizer", "sgd", "--lr",
                                         "0.0"])[2]
    for i in range(3):
        step = torch.cat([(want[k] - init[k]).flatten() for k in want
                          if k.startswith(f"stages.{i}.")])
        # sgd at lr 1 moves each stage by exactly its clipped gradient
        np.testing.assert_allclose(float(step.norm()), 1e-3, rtol=1e-4)
        mine = torch.cat([(got[k] - init[k]).flatten() for k in want
                          if k.startswith(f"stages.{i}.")])
        np.testing.assert_allclose(mine.numpy(), step.numpy(), rtol=1e-4,
                                   atol=1e-9)


def test_split_state_dict_rekeys_a_sequential_model():
    """A sequential MLP's state dict re-keyed per stage loads into the
    staged model, whose forward then equals the sequential one's."""
    cfg = tconfig.parse_args(["-l", "3", "-d", "cpu"], workload="mlp")
    spec = tget("mlp")
    dataset = spec.build_dataset(cfg)
    seq = spec.build_model(cfg, dataset)
    seq.reset_parameters(torch.Generator().manual_seed(3))
    layers = spec.build_layers(cfg, dataset)
    staged = StagedModel.from_layers(layers, spec.partitioner(len(layers), 3),
                                     3, spec.stage_input(cfg))
    parts = staged.split_state_dict(seq.state_dict())
    assert [len(p) for p in parts] == [4, 4, 2]       # 2, 2, 1 layers
    assert sorted(parts[2]) == ["layers.0.dense.bias",
                                "layers.0.dense.weight"]
    staged.load_state_dict(staged.from_sequential(seq.state_dict()))
    x = torch.as_tensor(dataset.batch(np.arange(5))[0])
    with torch.no_grad():
        want = seq.eval()(x)
        torch.testing.assert_close(staged.apply(x), want)
        torch.testing.assert_close(staged.apply_train(x)[0], want)
        pipe = MPMDPipeline(staged, ["cpu"] * 3, microbatch_size=2)
        torch.testing.assert_close(pipe(x), want)
        torch.testing.assert_close(pipe(x, pipelined=False), want)
    with pytest.raises(ValueError, match="3 stages need 3 devices"):
        MPMDPipeline(staged, ["cpu"])


def test_seeded_staged_init_is_the_sequential_init():
    """One seed gives a staged model the sequential model's weights: the
    layers draw in the same order."""
    cfg = tconfig.parse_args(["-d", "cpu"], workload="cnn")
    spec = tget("cnn")
    dataset = spec.build_dataset(cfg)
    seq = spec.build_model(cfg, dataset)
    seq.reset_parameters(torch.Generator().manual_seed(5))
    layers = spec.build_layers(cfg, dataset)
    staged = StagedModel.from_layers(layers, spec.partitioner(len(layers), 2),
                                     2)
    staged.reset_parameters(torch.Generator().manual_seed(5))
    want = staged.from_sequential(seq.state_dict())
    for k, v in staged.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
