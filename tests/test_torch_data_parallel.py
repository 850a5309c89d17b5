"""``-m data`` (DDP), ``--no-sync``, ``--grad-accum`` and ``--remat``:
the port against the JAX package's runs and against itself.

Multi-rank runs go through ``--spawn``'s launcher (two gloo ranks on the
CPU, each bounded by a timeout, so a hung rendezvous fails the test) and
start from the JAX init: the test writes it as the port's step-0
checkpoint and the ranks ``--resume`` from it.  Rank 0's phase log (the
reference's grammar; losses printed to 9 decimals, accuracies to 3) is
held against the JAX package's ``-m data`` run on 2 of the 8 CPU devices
``tests/conftest.py`` makes: losses within 1e-4 relative, accuracies
within the printed rounding.  In-process runs are held to their
counterparts exactly (same process, same arithmetic) or within 1e-4.
"""

import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.__main__ import main
from distributed_deep_learning_tpu_torch.data import loader as tloader
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_lm
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SMALL = ["-l", "2", "-s", "32", "-e", "1", "-b", "8", "-d", "cpu"]
RANK_TIMEOUT = 120.0
_END = re.compile(r'^"(train|validation|test)(?: epoch (\d+))? ends at '
                  r'\S+ with accuracy (\S+) and loss (\S+)"$')


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads run them as fast as
    eight, without spinning against the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _uneven_pad_tokens(path, rows=64, T=17, seed=0):
    """A tokens.npy whose rows end in 0-12 pads, so the two halves of a
    batch hold different numbers of pad targets."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 61, (rows, T))
    for r, n in enumerate(rng.integers(0, 13, rows)):
        if n:
            tokens[r, T - n:] = 0
    np.save(path / "tokens.npy", tokens.astype(np.int32))
    return str(path)


def _jax_init(argv):
    cfg = jconfig.parse_args(argv, workload="gpt")
    dataset = jns.GPT_SPEC.build_dataset(cfg)
    params = jax.jit(jns.GPT_SPEC.build_model(cfg, dataset).init)(
        jax.random.key(cfg.seed),
        jnp.zeros((1, dataset.features.shape[1]), jnp.int32))["params"]
    return ttr.load_flax_params(jax.tree.map(np.asarray, params))


def _seed_checkpoint(directory, argv, state_dict):
    """The JAX init as the port's step-0 checkpoint (an epoch-0 save), so
    spawned ranks start from it with ``--resume``."""
    cfg = tconfig.parse_args(argv, workload="gpt")
    dataset = tns.GPT_SPEC.build_dataset(cfg)
    tx = tbase.build_optimizer(tns.GPT_SPEC, cfg, 1)
    state = create_train_state(tns.GPT_SPEC.build_model(cfg, dataset),
                               cfg.seed, tx, state_dict, device="cpu")
    Checkpointer(directory).save(0, state, extra={
        "epoch": 0, "batch": 0, "epoch_complete": True})


def _phase_ends(stdout):
    """``[(phase, epoch, accuracy, loss)]`` from rank 0's log."""
    out = []
    for line in stdout.splitlines():
        m = _END.match(line)
        if m:
            out.append((m.group(1), int(m.group(2)) if m.group(2) else None,
                        float(m.group(3)), float(m.group(4))))
    return out


def _assert_history_matches(got, jhist):
    assert [(p, e) for p, e, _, _ in got] == \
        [(h.phase, h.epoch) for h in jhist]
    for (phase, _, acc, loss), h in zip(got, jhist):
        np.testing.assert_allclose(loss, h.loss, rtol=1e-4, atol=1e-9,
                                   err_msg=phase)
        assert abs(acc - h.accuracy) <= 1.5e-3, (phase, acc, h.accuracy)


def _spawned_vs_jax(tmp_path, flags, data=None):
    """The spawned ranks run while this process runs JAX's side."""
    argv = SMALL + flags + (["--data-dir", data] if data else [])
    ckdir = str(tmp_path / "ckpt")
    _seed_checkpoint(ckdir, argv, _jax_init(argv))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            launch_local, 2, ["gpt", "-m", "data", "-r", "2", *argv,
                              "--checkpoint-dir", ckdir, "--resume"],
            device="cpu", timeout=RANK_TIMEOUT)
        _, jhist = jbase.run_workload(jns.GPT_SPEC, jconfig.parse_args(
            ["-m", "data", "-r", "2", *argv], workload="gpt"))
        results = ranks.result()
    assert "resumed from epoch 0" in results[0].stdout
    assert _phase_ends(results[1].stdout) == []       # rank 0 logs
    _assert_history_matches(_phase_ends(results[0].stdout), jhist)
    return results


@pytest.mark.parametrize("case", ["synthetic", "uneven_pads",
                                  "uneven_pads_grad_accum_2"])
def test_spawned_data_parallel_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    data, flags = None, []
    if case != "synthetic":
        data = _uneven_pad_tokens(tmp_path)
        ds = tns.GPT_SPEC.build_dataset(
            tconfig.parse_args(["--data-dir", data], "gpt"))
        loader = tloader.DeviceLoader(
            ds, train_val_test_split(64, seed=42).train, 8, "cpu",
            shuffle=True)
        loader.set_epoch(1)
        _, y = next(iter(loader))
        halves = [int((half == 0).sum()) for half in y.chunk(2)]
        assert halves[0] != halves[1], halves     # the global-mean trap
    if case.endswith("grad_accum_2"):
        flags = ["--grad-accum", "2"]
    _spawned_vs_jax(tmp_path, flags, data)


def test_no_sync_matches_jax_quirk_q1(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    results = _spawned_vs_jax(tmp_path, ["--no-sync"])
    assert "quirk Q1 mode: no gradient sync; training rank 0's 1/2 shard " \
           "only" in results[0].stdout


@pytest.mark.parametrize("sync", ["synced", "no_sync"])
def test_spawned_mid_epoch_resume_is_bit_identical(sync, tmp_path,
                                                   monkeypatch):
    """Two ranks with dropout 0.1, each drawing its own masks, saving every
    step: a run stopped after an early save and resumed equals the run
    never stopped, in rank 0's log and in every leaf CRC of each rank's
    final checkpoint.  Synced, the checkpoint holds both ranks' dropout
    streams; under --no-sync each rank keeps its own replica (rank 1's
    under ``rank-1/``)."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    ckdir = tmp_path / "ckpt"
    argv = ["gpt", "-m", "data", "-r", "2", *SMALL, "--dropout", "0.1",
            "--checkpoint-dir", str(ckdir), "--checkpoint-every", "1",
            *(["--no-sync"] if sync == "no_sync" else [])]
    dirs = [ckdir] + ([ckdir / "rank-1"] if sync == "no_sync" else [])
    whole = launch_local(2, argv, device="cpu", timeout=RANK_TIMEOUT)
    ckpts = [Checkpointer(d) for d in dirs]
    steps = ckpts[0].all_steps()
    final = {d: c.read_manifest(steps[-1]) for d, c in zip(dirs, ckpts)}
    for d in dirs:
        for step in steps[1:]:
            for name in (f"ckpt-{step}.pt", f"extra-{step}.json",
                         f"manifest-{step}.json"):
                os.remove(d / name)
    resumed = launch_local(2, argv + ["--resume"], device="cpu",
                           timeout=RANK_TIMEOUT)
    assert f"resumed mid-epoch 1 at step {steps[0]}" in resumed[0].stdout
    got, want = _phase_ends(resumed[0].stdout), _phase_ends(whole[0].stdout)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert got[0][2] == want[0][2]
    np.testing.assert_allclose(got[0][3], want[0][3], rtol=1e-6)  # totals
    assert got[1:] == want[1:]
    for d, c in zip(dirs, ckpts):
        assert c.all_steps()[-1] == steps[-1]
        assert c.read_manifest(steps[-1])["leaves"] == final[d]["leaves"]


def _history(argv, state_dict):
    return tbase.run_workload(
        tns.GPT_SPEC, tconfig.parse_args(argv, workload="gpt"),
        init_state_dict=state_dict)


def test_data_mode_at_world_1_equals_sequential(monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    init = _jax_init(SMALL)
    seq_state, seq = _history(SMALL + ["--dropout", "0.1"], init)
    assert not dist.is_initialized()
    data_state, data = _history(["-m", "data"] + SMALL + ["--dropout", "0.1"],
                                init)
    assert not dist.is_initialized()            # the run destroyed its group
    assert [h.step_losses for h in data] == [h.step_losses for h in seq]
    assert [(h.loss, h.accuracy) for h in data] == \
        [(h.loss, h.accuracy) for h in seq]
    for (name, a), b in zip(seq_state.model.state_dict().items(),
                            data_state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_grad_accum_2_matches_jax(tmp_path, monkeypatch):
    """Microbatches with different pad counts: the gradient is the mean of
    the microbatch means, JAX's rule."""
    argv = SMALL + ["--grad-accum", "2", "--data-dir",
                    _uneven_pad_tokens(tmp_path)]
    _, jhist = jbase.run_workload(jns.GPT_SPEC, jconfig.parse_args(
        argv, workload="gpt"))
    _, thist = _history(argv, _jax_init(argv))
    assert [(h.phase, h.examples) for h in thist] == \
        [(h.phase, h.examples) for h in jhist]
    for mine, theirs in zip(thist, jhist):
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=1e-4, err_msg=mine.phase)


_NO_REMAT = {}


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_equals_the_run_without_it(policy, monkeypatch):
    """Dropout 0.1: the recompute must replay each layer's masks from the
    run's generator, or the gradients would silently differ."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "48")
    argv = SMALL + ["--dropout", "0.1", "--attention", "flash"]
    if not _NO_REMAT:
        _NO_REMAT["init"] = _jax_init(SMALL)
        _NO_REMAT["run"] = _history(argv, _NO_REMAT["init"])
    base_state, base = _NO_REMAT["run"]
    state, hist = _history(argv + ["--remat", "--remat-policy", policy],
                           _NO_REMAT["init"])
    assert [h.step_losses for h in hist] == [h.step_losses for h in base]
    assert [(h.loss, h.accuracy) for h in hist] == \
        [(h.loss, h.accuracy) for h in base]
    for (name, a), b in zip(base_state.model.state_dict().items(),
                            state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(state.generator.get_state(),
                       base_state.generator.get_state())


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="--remat with --grad-accum"):
        tbase.run_workload(tns.GPT_SPEC, tconfig.parse_args(
            SMALL + ["--remat", "--grad-accum", "2"], workload="gpt"))
    with pytest.raises(SystemExit, match="--remat-policy requires --remat"):
        tconfig.parse_args(["--remat-policy", "dots"], "gpt")
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        tconfig.parse_args(["--checkpoint-every", "2"], "gpt")
    ds = synthetic_lm(n=40, seq_len=6, vocab_size=61, seed=1)
    splits = train_val_test_split(len(ds), seed=42)
    with pytest.raises(ValueError, match="not divisible by data-parallel "
                                         "size 2"):
        tloader.make_loaders(ds, splits, 9, "cpu", rank=1, world=2)
    with pytest.raises(ValueError, match="accumulation factor 2"):
        tloader.make_loaders(ds, splits, 6, "cpu", rank=0, world=2, accum=2)
    with pytest.raises(ValueError, match="--spawn"):
        tbase.run_workload(tns.GPT_SPEC, tconfig.parse_args(
            ["-m", "data", "-r", "2"] + SMALL, workload="gpt"))
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="N >= 2"):
        main(["gpt", "--spawn", "-r", "1", "-d", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards, 1 visible"):
        main(["gpt", "--spawn", "-r", "2", "-m", "data"])


def test_a_failing_rank_raises_with_its_tail(monkeypatch):
    """-b 9 does not divide over 2 ranks: both exit non-zero, and the
    launcher raises with their tails."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    with pytest.raises(RuntimeError, match=r"(?s)2/2 ranks failed.*rank 0 "
                                           r"\(exit 1\).*not divisible by "
                                           r"data-parallel size 2"):
        launch_local(2, ["gpt", "-m", "data", "-r", "2", "-l", "1", "-s",
                         "32", "-e", "1", "-b", "9", "-d", "cpu"],
                     device="cpu", timeout=RANK_TIMEOUT)


def test_ranks_past_the_timeout_are_killed():
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        launch_local(2, ["gpt", "-m", "data", "-r", "2", "-d", "cpu"],
                     device="cpu", timeout=0.5)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("argv", [
    [], ["-m", "data", "-r", "2", "--no-sync"],
    ["--remat", "--remat-policy", "dots_no_batch"], ["--grad-accum", "4"],
    ["--checkpoint-dir", "d", "--checkpoint-every", "3", "--resume"],
    ["--dtype", "bfloat16"]])
def test_step_variant_flags_parse_as_jax(argv):
    mine = tconfig.parse_args(argv, "gpt")
    theirs = jconfig.parse_args(argv, "gpt")
    for field in ("mode", "world_size", "sync_in_local_data_mode", "remat",
                  "remat_policy", "grad_accum", "checkpoint_dir",
                  "checkpoint_every", "resume", "dtype"):
        assert str(getattr(mine, field)) == str(getattr(theirs, field)), \
            field


def test_remat_policies_are_the_models_and_jaxs():
    """The CLI's policy names (kept in the config layer) are the keys the
    model maps to saved matmuls, and each parses in the JAX CLI."""
    assert set(tconfig.REMAT_POLICIES) == set(ttr.REMAT_SAVED_OPS)
    for policy in tconfig.REMAT_POLICIES:
        assert jconfig.parse_args(["--remat", "--remat-policy", policy],
                                  "gpt").remat_policy == policy


def test_local_rows_cover_each_microbatch():
    """Rank r of W holds its 1/W of every global microbatch; together the
    ranks hold the batch once."""
    rows = [tloader.local_rows(16, r, 2, accum=2) for r in range(2)]
    np.testing.assert_array_equal(rows[0], [0, 1, 2, 3, 8, 9, 10, 11])
    np.testing.assert_array_equal(rows[1], [4, 5, 6, 7, 12, 13, 14, 15])
    np.testing.assert_array_equal(tloader.local_rows(8, 1, 2), [4, 5, 6, 7])
    np.testing.assert_array_equal(tloader.local_rows(8), np.arange(8))
