"""The port's training pieces against the JAX package's: token CE and
metrics, the optax schedules, one optimizer step (decay mask, clipping),
the data pipeline's splits and batch order, the CLI and the phase log.
Inputs are seeded numpy arrays handed to both sides."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.data import datasets as jds
from distributed_deep_learning_tpu.data import loader as jloader
from distributed_deep_learning_tpu.data import splits as jsplits
from distributed_deep_learning_tpu.data import tokens as jtokens
from distributed_deep_learning_tpu.runtime.mesh import build_mesh
from distributed_deep_learning_tpu.train import objectives as jobj
from distributed_deep_learning_tpu.train import schedules as jsched
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.utils.logging import PhaseLogger as JLog
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu_torch.data import datasets as tds
from distributed_deep_learning_tpu_torch.data import loader as tloader
from distributed_deep_learning_tpu_torch.data import splits as tsplits
from distributed_deep_learning_tpu_torch.data import tokens as ttokens
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from distributed_deep_learning_tpu_torch.train import schedules as tsched
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, clip_by_global_norm)
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def _logits_targets(seed=0, V=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 7, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (3, 7)).astype(np.int32)
    targets[0, :3] = 0                            # pad sites
    return logits, targets


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_token_cross_entropy_matches(smoothing):
    logits, targets = _logits_targets()
    got = tobj.token_cross_entropy(torch.tensor(logits),
                                   torch.tensor(targets),
                                   label_smoothing=smoothing, pad_id=0)
    want = jobj.token_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(targets),
                                    label_smoothing=smoothing, pad_id=0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["tokens", "one_hot"])
def test_prediction_metrics_match(kind):
    logits, targets = _logits_targets(seed=1)
    if kind == "one_hot":
        logits = logits[0]
        targets = np.eye(logits.shape[-1], dtype=np.float32)[targets[1]]
    got = tobj.prediction_metrics(torch.tensor(logits),
                                  torch.tensor(targets), torch.tensor(0.5))
    want = jobj.prediction_metrics(jnp.asarray(logits),
                                   jnp.asarray(targets), jnp.asarray(0.5))
    for key in ("correct", "count"):
        assert got[key].dtype == torch.int32
        assert got[key].item() == int(want[key]), key


SCHEDULES = {
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-3, 10, 100), 10, 100),
    "warmup_cosine_end": (lambda m: m.warmup_cosine(1e-3, 10, 100, 0.1),
                          10, 100),
    "warmup_rsqrt": (lambda m: m.warmup_rsqrt(512, 10), 10, 100),
    "step_decay": (lambda m: m.step_decay(0.1, 7), 7, 30),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    make, warm, end = SCHEDULES[name]
    got, want = make(tsched), make(jsched)
    for step in (0, 1, warm, warm + 1, end, end + 5):
        # optax evaluates in f32: ~1e-10 absolute at these rates
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-10, err_msg=f"step {step}")


@pytest.mark.parametrize("flags", [
    ["--schedule", "cosine"], ["--schedule", "cosine", "--warmup", "0"],
    ["--schedule", "rsqrt", "--warmup", "3"], ["--schedule", "step"]])
def test_resolve_lr_matches(flags):
    argv = ["-e", "2", *flags]
    got = tbase.resolve_lr(tconfig.parse_args(argv, "gpt"), 20, 1e-3)
    want = jbase.resolve_lr(jconfig.parse_args(argv, "gpt"), 20, 1e-3)
    for step in (0, 1, 2, 3, 19, 39):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-10)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}


def _step_both(tx_jax, tx_torch, steps=2):
    """Apply ``steps`` updates with seeded gradients on both sides.  The
    rates are small enough for f32 rounding to stay under 1e-6: optax
    takes Adam's bias corrections ``1 - b**t`` in f32, torch in f64
    (1e-5 apart in the first step's ``1 - 0.999``)."""
    params = _tree()
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = tx_torch.build(tparams.items())
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx_jax.init(jp)
    for i in range(steps):
        grads = _tree(seed=10 + i)
        upd, state = tx_jax.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        if tx_torch.clip_norm is not None:
            clip_by_global_norm([p.grad for p in tparams.values()],
                                tx_torch.clip_norm)
        for group in opt.param_groups:
            group["lr"] = tx_torch.lr_at(i)
        opt.step()
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jp[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_adamw_with_decay_mask_matches_optax():
    # a large decay so the mask (w decays, b does not) shows in the result
    _step_both(jbase.adamw(0.05, weight_decay=0.5),
               tbase.adamw(0.05, weight_decay=0.5), steps=1)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_plain_optimizers_match_optax(kind):
    tx_jax = {"sgd": optax.sgd(0.02), "momentum": optax.sgd(0.02, 0.9),
              "adam": optax.adam(0.02)}[kind]
    _step_both(tx_jax, Optimizer(kind, 0.02), steps=3)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipped_step_matches_optax(max_norm):
    # 0.5 is below the gradients' norm (clipped), 100 above it (untouched)
    _step_both(optax.chain(optax.clip_by_global_norm(max_norm),
                           optax.sgd(0.1)),
               Optimizer("sgd", 0.1, clip_norm=max_norm))


def test_scheduled_adamw_matches_optax():
    sched_j = jsched.warmup_cosine(0.02, 1, 4)
    sched_t = tsched.warmup_cosine(0.02, 1, 4)
    _step_both(jbase.adamw(sched_j), tbase.adamw(sched_t), steps=3)


def test_decay_mask_follows_the_flax_layout():
    from distributed_deep_learning_tpu_torch.models.transformer import \
        CausalLM

    model = CausalLM(vocab_size=13, num_layers=1, d_model=8, num_heads=2,
                     mlp_dim=16, max_len=8)
    decayed = {n for n, p in model.named_parameters()
               if tbase.decay_mask(n, p)}
    assert "layers.0.self_attn.q.bias" in decayed      # (H, hd) in flax
    assert "layers.0.self_attn.out.bias" not in decayed
    assert "layers.0.mlp_in.bias" not in decayed
    assert "layers.0.ln_attn.weight" not in decayed
    assert {"tok.weight", "pos", "layers.0.mlp_in.weight"} <= decayed


def test_datasets_and_splits_match():
    a = tds.synthetic_lm(n=40, seq_len=12, vocab_size=61, seed=3)
    b = jds.synthetic_lm(n=40, seq_len=12, vocab_size=61, seed=3)
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.targets, b.targets)
    for n in (40, 64, 7):
        for x, y in zip(tsplits.train_val_test_split(n, seed=5),
                        jsplits.train_val_test_split(n, seed=5)):
            np.testing.assert_array_equal(x, y)


def test_token_file_dataset_matches(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "tokens.npy", rng.integers(0, 50, (6, 9)))
    a = ttokens.lm_dataset(ttokens.load_tokens(str(tmp_path)))
    b = jtokens.lm_dataset(jtokens.load_tokens(str(tmp_path)))
    assert a.vocab_size == b.vocab_size
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert ttokens.load_tokens(str(tmp_path / "missing")) is None


def test_loader_batch_order_matches():
    ds = tds.synthetic_lm(n=50, seq_len=6, vocab_size=61, seed=1)
    splits = tsplits.train_val_test_split(len(ds), seed=42)
    mine = tloader.make_loaders(ds, splits, 4, "cpu", seed=42)
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jds_ = jds.ArrayDataset(ds.features, ds.targets)
    theirs = jloader.make_loaders(jds_, jsplits.train_val_test_split(
        len(ds), seed=42), 4, mesh, seed=42, prefetch=0)
    for a, b in zip(mine, theirs):
        assert len(a) == len(b)
        for epoch in (1, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got = [(x.numpy(), y.numpy()) for x, y in a]
            want = [(np.asarray(x), np.asarray(y)) for x, y in b]
            assert len(got) == len(want)
            for (x, y), (xw, yw) in zip(got, want):
                np.testing.assert_array_equal(x, xw)
                np.testing.assert_array_equal(y, yw)
            assert got and got[0][0].dtype == np.int32


def test_cli_defaults_match_jax():
    for workload in ("gpt", "mlp", "bert"):
        mine = tconfig.parse_args([], workload)
        theirs = jconfig.parse_args([], workload)
        for field in ("num_layers", "size", "epochs", "batch_size", "seed",
                      "learning_rate", "dtype", "dropout", "attention",
                      "optimizer", "pos_embedding", "label_smoothing",
                      "lr_schedule", "warmup_steps", "clip_norm"):
            assert getattr(mine, field) == getattr(theirs, field), field
    assert tconfig.parse_args([], "gpt").device == "cuda"
    assert tconfig.parse_args(["-d", "gpu"], "gpt").device == "cuda"
    assert tconfig.parse_args(["-d", "cpu"], "gpt").device == "cpu"


@pytest.mark.parametrize("argv,match", [
    (["--target-mesh", "data=2"], None), (["--canary-slots", "2"],
                                           None),
    (["--publish-weights", "p"], None),
    (["--autotune"], None),
    (["--profile-dir", "d"], None), (["--obs"], None),
    (["--plan", "p.json"], None), (["--obs-file", "f"], None),
    (["--reload-watch", "d"], None),
    (["--disagg"], None), (["--replicas", "2"], None),
])
def test_unported_flags_raise_naming_the_roadmap_item(argv, match):
    """Refused flags would name their item; none is left: the serving,
    disaggregation, observability, resharding and tuning flags (items 13
    and 14, ``match=None``) parse as JAX's CLI parses them: accepted, or
    refused with its message."""
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tconfig.parse_args(argv, "gpt")
        return
    try:
        theirs = jconfig.parse_args(argv, "gpt")
    except SystemExit as e:
        with pytest.raises(SystemExit) as mine:
            tconfig.parse_args(argv, "gpt")
        assert str(mine.value) == str(e)
        return
    mine = tconfig.parse_args(argv, "gpt")
    for field in ("canary_slots", "autotune", "plan_file", "reshard",
                  "target_mesh"):
        assert getattr(mine, field) == getattr(theirs, field), field


#: the training-resilience flags (item 12, refused until it landed), and
#: JAX's parse-time checks of them
RESILIENCE_FLAGS = [
    ["--heartbeat-timeout", "5"], ["--heartbeat-dir", "d"], ["--elastic"],
    ["--sentinel", "skip"], ["--sentinel-window", "5"],
    ["--sentinel", "rollback", "--elastic", "--sentinel-factor", "3"],
]


@pytest.mark.parametrize("argv", RESILIENCE_FLAGS)
def test_resilience_flags_parse_as_jax(argv):
    mine = tconfig.parse_args(argv, "gpt")
    theirs = jconfig.parse_args(argv, "gpt")
    for field in ("sentinel", "sentinel_window", "sentinel_factor",
                  "elastic", "heartbeat_dir", "heartbeat_timeout"):
        assert getattr(mine, field) == getattr(theirs, field), field


@pytest.mark.parametrize("argv", [
    ["--sentinel", "rollback"],
    ["--sentinel", "skip", "--sentinel-factor", "1"],
])
def test_resilience_flags_raise_jax_parse_messages(argv):
    with pytest.raises(SystemExit) as theirs:
        jconfig.parse_args(argv, "gpt")
    with pytest.raises(SystemExit) as mine:
        tconfig.parse_args(argv, "gpt")
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["--comm", "int8"],
    ["--zero", "fsdp", "--comm", "bf16", "--grad-compress", "int8"],
    ["--comm-overlap"],
    ["--zero", "fsdp", "--comm", "int8", "--mesh", "data=2,model=2"],
])
def test_comm_flags_raise_jax_parse_messages(argv):
    """The flags that item 11 ported are refused where JAX's parser
    refuses them, with its message."""
    with pytest.raises(SystemExit) as theirs:
        jconfig.parse_args(argv, "gpt")
    with pytest.raises(SystemExit) as mine:
        tconfig.parse_args(argv, "gpt")
    assert str(mine.value) == str(theirs.value)


def test_mesh_seq_is_refused_as_a_library_path():
    """No CLI path of either package runs the seq axis: ring attention
    and Ulysses are library entry points."""
    with pytest.raises(NotImplementedError, match="library entry points"):
        tconfig.parse_args(["--mesh", "data=2,seq=2"], "gpt")


@pytest.mark.parametrize("workload,argv,match", [
    ("mlp", ["--mesh", "model=2"],
     "workload 'mlp' has no tensor-parallel sharding rules"),
    ("gpt", ["--mesh", "model=2", "--zero", "1"],
     "--zero with a model axis is not supported yet"),
])
def test_mesh_flags_raise_jax_value_errors(workload, argv, match):
    """What ``--mesh``/``--zero`` took over from the refusals above: the
    JAX runner's own ``ValueError`` s, on the resolved 2-rank mesh."""
    from distributed_deep_learning_tpu_torch.runtime.mesh import MeshSpec

    cfg = tconfig.parse_args(argv, workload)
    sizes = dict(zip(MeshSpec.__dataclass_fields__, MeshSpec.from_dict(
        cfg.mesh_shape).resolve(2).sizes()))
    with pytest.raises(ValueError, match=match):
        tbase.derive_state_spec(tget(workload), cfg, sizes)


def test_phase_logger_lines_match():
    def lines(cls):
        out = io.StringIO()
        clock = iter(range(100, 200)).__next__
        log = cls(stream=out, clock=lambda: float(clock()))
        log.phase_begin("train", 1)
        log.phase_end("train", 1, accuracy=12.5, loss=0.25)
        log.metrics(phase="train", epoch=1, examples=8)
        log.phase_end("test", accuracy=1.0, loss=2.0)
        return out.getvalue()

    assert lines(PhaseLogger) == lines(JLog)


@pytest.mark.parametrize("entry", ["create_train_state", "build_pools"])
def test_public_entries_default_to_cuda_and_raise_without_a_card(
        entry, monkeypatch):
    """No public function of the port runs on the CPU unless asked: the
    default device is ``cuda``, which raises when no card is visible."""
    from distributed_deep_learning_tpu_torch.serve import paged
    from distributed_deep_learning_tpu_torch.train import state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "create_train_state":
        class Tiny(torch.nn.Linear):
            def reset_parameters(self, generator=None):
                super().reset_parameters()

        def call(**kw):
            return state.create_train_state(Tiny(2, 2), 0,
                                            tbase.adamw(1e-3), **kw)
    else:
        def call(**kw):
            return paged.build_pools(1, 2, 4, 1, 8, **kw)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
    call(device="cpu")                   # the CPU only when asked for
