"""Elastic recovery and the chaos drills (``train/elastic.py``,
``utils/failures.py``, ``utils/chaos.py``), after the JAX package's
``tests/test_elastic.py`` and ``tests/test_chaos.py``.

On the CPU with the port's MLP (SGD 0.05, 11 steps an epoch): a worker
failure mid-epoch 2 restores the last step save and ends bit-identical
to an uninterrupted run, history merged; a deterministic failure fails
fast after two attempts; the sentinel's rollback replays with the bad
step skipped, bit-identical to that replay; a truncated or bit-flipped
latest save is quarantined and the older one restored; the monitor
tolerates transient I/O errors and reports persistent ones; staleness is
read from mtimes; a stale heartbeat restarts the run; the injection
hooks validate their spec; ``run_resilience_drill`` returns JAX's record
keys with passing verdicts.  Then the CLI: ``mlp -m data --elastic`` on
two gloo ranks with ``DDL_INJECT_STEP_FAILURE=all:3`` ends with the
uninterrupted run's log, and ``--elastic`` without ``--checkpoint-dir``
is refused with JAX's message."""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_mqtt
from distributed_deep_learning_tpu_torch.data.loader import make_loaders
from distributed_deep_learning_tpu_torch.data.splits import \
    train_val_test_split
from distributed_deep_learning_tpu_torch.models.mlp import MLP
from distributed_deep_learning_tpu_torch.train.elastic import (
    RestartLoopError, fit_with_recovery)
from distributed_deep_learning_tpu_torch.train.loop import fit
from distributed_deep_learning_tpu_torch.train.objectives import \
    cross_entropy_loss
from distributed_deep_learning_tpu_torch.train.sentinel import (
    SentinelConfig, attach_sentinel)
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils import failures
from distributed_deep_learning_tpu_torch.utils.chaos import (
    ChaosEvent, ChaosPlan, run_resilience_drill)
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer
from distributed_deep_learning_tpu_torch.utils.determinism import (
    diff_trees, state_tree)
from distributed_deep_learning_tpu_torch.utils.failures import (
    FailureMonitor, Heartbeat, MonitorUnhealthy, WorkerFailure,
    detect_failures, last_beat)
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SPE = 11


def _setup(sentinel=None):
    ds = synthetic_mqtt(1024, seed=21)
    loaders = make_loaders(ds, train_val_test_split(len(ds), seed=42), 64,
                           "cpu")
    assert len(loaders[0]) == SPE

    def make_state():
        state = create_train_state(MLP(48, hidden_size=16), 7,
                                   Optimizer("sgd", 0.05), device="cpu")
        return attach_sentinel(state) if sentinel is not None else state

    return make_state, make_step_fns(cross_entropy_loss,
                                     sentinel=sentinel), loaders


def _same(a, b) -> bool:
    return diff_trees(state_tree(a), state_tree(b)) == []


def test_mid_epoch_worker_failure_is_bit_identical(tmp_path):
    make_state, (step, ev), loaders = _setup()
    ref, ref_hist = fit(make_state(), step, ev, *loaders, epochs=2)
    plan = ChaosPlan([ChaosEvent(step=SPE + 3, kind="worker_failure")])
    with Checkpointer(tmp_path / "ck", shared=False) as ckpt:
        state, hist = fit_with_recovery(
            make_state, step, ev, loaders, epochs=2, checkpointer=ckpt,
            checkpoint_every=2, chaos=plan, max_restarts=2)
        assert ckpt.latest_step() == 2 * SPE
    assert plan.fired == [(SPE + 3, "worker_failure")]
    assert _same(state, ref)
    assert [(h.phase, h.epoch) for h in hist] == \
        [(h.phase, h.epoch) for h in ref_hist]
    assert hist[-1].loss == ref_hist[-1].loss


def test_deterministic_failure_fails_fast(tmp_path):
    make_state, (step, ev), loaders = _setup()
    attempts, calls = {"n": 0}, {"n": 0}

    def counting():
        attempts["n"] += 1
        calls["n"] = 0
        return make_state()

    def buggy(state, x, y):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("deterministic bug: bad op at batch 3")
        return step(state, x, y)

    with Checkpointer(tmp_path / "ff", shared=False) as ckpt:
        with pytest.raises(RestartLoopError, match="same resume point"):
            fit_with_recovery(counting, buggy, ev, loaders, epochs=2,
                              checkpointer=ckpt, max_restarts=50)
    assert attempts["n"] == 2


def test_gives_up_after_max_restarts(tmp_path):
    make_state, (_, ev), loaders = _setup()
    n = {"calls": 0}

    def always_fails(state, x, y):
        n["calls"] += 1
        raise RuntimeError(f"permanently broken ({n['calls']})")

    with Checkpointer(tmp_path / "dead", shared=False) as ckpt:
        with pytest.raises(RuntimeError, match="permanently broken"):
            fit_with_recovery(make_state, always_fails, ev, loaders,
                              epochs=2, checkpointer=ckpt, max_restarts=1)


def test_rollback_is_bit_identical_to_the_replay(tmp_path):
    cfg = SentinelConfig(policy="rollback", warmup_steps=2)
    make_state, (step, ev), loaders = _setup(cfg)
    bad = SPE + 2
    plan = ChaosPlan([ChaosEvent(step=bad, kind="nan_batch")], seed=4)
    with Checkpointer(tmp_path / "rb", shared=False) as ckpt:
        state, hist = fit_with_recovery(
            make_state, step, ev, loaders, epochs=2, checkpointer=ckpt,
            sentinel=cfg, chaos=plan, max_restarts=2)
    ref, _ = fit(make_state(), step, ev, *loaders, epochs=2,
                 skip_steps={bad})
    assert plan.fired == [(bad, "nan_batch")]
    assert diff_trees(state_tree(state)["params"],
                      state_tree(ref)["params"]) == []
    assert state.step == ref.step == 2 * SPE - 1
    assert [h.epoch for h in hist if h.phase == "train"] == [1, 2]


@pytest.mark.parametrize("corrupt", ["truncate", "bitflip"])
def test_corrupt_latest_quarantined_and_fallback(tmp_path, corrupt):
    make_state, (step, ev), loaders = _setup()
    state, _ = fit(make_state(), step, ev, *loaders, epochs=1)
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, shared=False)
    ckpt.save(1, state)
    ckpt.save(2, state)
    if corrupt == "truncate":
        ChaosPlan.truncate_checkpoint(str(d), 2)
    else:
        ChaosPlan.bitflip_checkpoint(str(d), 2, seed=7)
    restored, used = ckpt.restore_verified(make_state())
    assert used == 1 and ckpt.latest_step() == 1
    assert any(n.startswith("ckpt-2") for n in os.listdir(d / "quarantine"))
    assert _same(restored, state)


def test_monitor_tolerates_transient_io_errors(tmp_path):
    d = str(tmp_path / "hb")
    Heartbeat(d, rank=0).beat_once()
    mon = FailureMonitor(d, world_size=1, timeout=30.0, poll_interval=0.02,
                         io_error_tolerance=3)
    ChaosPlan.flaky_io(mon, failures=2)
    with mon:
        time.sleep(0.3)
        assert mon.healthy and mon.failure is None
        mon.raise_if_failed()


def test_monitor_surfaces_persistent_io_failure(tmp_path):
    d = str(tmp_path / "hb2")
    Heartbeat(d, rank=0).beat_once()
    mon = FailureMonitor(d, world_size=1, timeout=30.0, poll_interval=0.02,
                         io_error_tolerance=3)
    ChaosPlan.flaky_io(mon, failures=50)
    mon.start()
    try:
        deadline = time.time() + 5
        while mon.failure is None and time.time() < deadline:
            time.sleep(0.01)
        assert isinstance(mon.failure, MonitorUnhealthy)
        assert not mon.healthy
        with pytest.raises(MonitorUnhealthy):
            mon.raise_if_failed()
    finally:
        mon.stop()


def test_staleness_is_mtime_based(tmp_path):
    d = str(tmp_path / "hb3")
    Heartbeat(d, rank=0).beat_once()
    with open(os.path.join(d, "hb-0"), "w") as f:
        f.write(f"{time.time() + 10_000:f}\n")   # a writer clock ahead
    assert last_beat(d, 0) > time.time() + 5_000
    assert detect_failures(d, world_size=1, timeout=30.0) == []
    ChaosPlan.stale_heartbeat(d, rank=0, age=3600)
    assert detect_failures(d, world_size=1, timeout=30.0) == [0]
    # the JAX package's injector ages the same file the same way
    Heartbeat(d, rank=1).beat_once()
    jchaos.ChaosPlan.stale_heartbeat(d, rank=1, age=3600)
    assert detect_failures(d, world_size=2, timeout=30.0) == [0, 1]


def test_stale_heartbeat_restart_drill(tmp_path):
    make_state, (step, ev), loaders = _setup()
    d = str(tmp_path / "hb")
    Heartbeat(d, rank=0).beat_once()
    hb1 = Heartbeat(d, rank=1)
    hb1.beat_once()
    monitor = FailureMonitor(d, world_size=2, timeout=20.0,
                             poll_interval=0.05, self_rank=0).start()
    plan = ChaosPlan([ChaosEvent(step=SPE + 2, kind="stale_heartbeat",
                                 target=d, magnitude=3600.0)])
    restarts = {"n": 0}

    class _Drill:
        def batch_hook(self, gstep, x, y):
            x, y = plan.batch_hook(gstep, x, y)
            if plan.fired and monitor.failure is None \
                    and restarts["n"] == 0:
                deadline = time.time() + 10
                while monitor.failure is None and time.time() < deadline:
                    time.sleep(0.01)
            return x, y

    def rejoin():
        if restarts["n"] or plan.fired:
            restarts["n"] += 1
        hb1.beat_once()
        return make_state()

    try:
        with Checkpointer(tmp_path / "ck", shared=False) as ckpt:
            _, hist = fit_with_recovery(
                rejoin, step, ev, loaders, epochs=2, checkpointer=ckpt,
                monitor=monitor, chaos=_Drill(), max_restarts=2)
    finally:
        monitor.stop()
    assert plan.fired == [(SPE + 2, "stale_heartbeat")]
    assert 1 <= restarts["n"] <= 2
    assert [h.epoch for h in hist if h.phase == "train"] == [1, 2]
    assert monitor.failure is None


def test_monitor_failure_is_a_restart_loop_when_the_peer_stays_dead(
        tmp_path):
    make_state, (step, ev), loaders = _setup()
    d = str(tmp_path / "hb")
    Heartbeat(d, rank=0).beat_once()
    monitor = FailureMonitor(d, world_size=2, timeout=1.0, self_rank=0)
    with Checkpointer(tmp_path / "mon", shared=False) as ckpt:
        with pytest.raises(RestartLoopError) as e:
            fit_with_recovery(make_state, step, ev, loaders, epochs=1,
                              checkpointer=ckpt, monitor=monitor,
                              max_restarts=1)
    assert isinstance(e.value.__cause__, WorkerFailure)


@pytest.mark.parametrize("var,hook", [
    ("DDL_INJECT_FAILURE", "maybe_inject_failure"),
    ("DDL_INJECT_STEP_FAILURE", "maybe_inject_step_failure")])
def test_inject_hooks_validate_and_fire_once(monkeypatch, var, hook):
    fn = getattr(failures, hook)
    monkeypatch.setattr(failures, "_injected", False)
    monkeypatch.setattr(failures, "_step_injected", False)
    for bad in ("2", "all:two", "1:2:3", "x:1"):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var):
            fn(1)
    monkeypatch.setenv(var, "0:2")
    fn(1)
    with pytest.raises(RuntimeError, match="injected failure"):
        fn(2)
    fn(2)                                   # at most once a process
    monkeypatch.setenv(var, "1:3")          # another rank's
    monkeypatch.setattr(failures, "_injected", False)
    monkeypatch.setattr(failures, "_step_injected", False)
    fn(3)


def test_resilience_drill_record():
    rec = run_resilience_drill(seed=0)
    want = set(jchaos.run_resilience_drill.__code__.co_consts) & set(rec)
    assert {"detection_latency_steps", "containment_bit_identical",
            "anomalies_contained", "faults_fired", "sentinel_overhead_frac",
            "corrupt_restore_fallback_seconds", "corrupt_restore_fell_back",
            "quarantined", "recovery_seconds", "restarts_used",
            "recovered_bit_identical"} == set(rec) == want
    assert rec["containment_bit_identical"]
    assert rec["corrupt_restore_fell_back"]
    assert rec["recovered_bit_identical"]
    assert rec["detection_latency_steps"] <= 1
    assert rec["restarts_used"] == 1
    assert rec["anomalies_contained"] == 1
    assert [k for _, k in rec["faults_fired"]] == ["nan_batch",
                                                   "worker_failure"]


def _cli(argv, env=None):
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_learning_tpu_torch", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                 DDL_DATA_LIMIT="512", **(env or {})))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc


def _ends(out: str) -> list[str]:
    return [re.sub(r"at [0-9.]+ ", "", line) for line in out.splitlines()
            if " ends at " in line]


def test_step_failure_hook_on_two_gloo_ranks(tmp_path):
    """Both ranks die after global step 3, restore step 2 and finish
    with the uninterrupted run's log."""
    argv = ["mlp", "-m", "data", "--spawn", "-r", "2", "-d", "cpu", "-e",
            "2", "-b", "64", "--elastic", "--checkpoint-every", "2"]
    clean = _cli(argv + ["--checkpoint-dir", str(tmp_path / "clean")])
    hurt = _cli(argv + ["--checkpoint-dir", str(tmp_path / "hurt"),
                        "--heartbeat-dir", str(tmp_path / "hb")],
                env={"DDL_INJECT_STEP_FAILURE": "all:3"})
    # the launcher prints each rank's merged output streams
    assert hurt.stdout.count("CHAOS: injected failure") == 2
    assert "recovering from failure (RuntimeError: injected failure" in \
        hurt.stdout
    assert "restart 1/2 from epoch 1 step 2" in hurt.stdout
    assert _ends(hurt.stdout) == _ends(clean.stdout) != []
    assert sorted(n for n in os.listdir(tmp_path / "hb")
                  if n.startswith("hb-")) == ["hb-0", "hb-1"]


def test_elastic_needs_a_checkpoint_dir(monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = ["-e", "1", "-b", "8", "-d", "cpu", "--elastic"]
    with pytest.raises(ValueError) as theirs:
        jbase.run_workload(jget("mlp"), jconfig.parse_args(argv, "mlp"))
    with pytest.raises(ValueError) as mine:
        tbase.run_workload(tget("mlp"), tconfig.parse_args(argv, "mlp"))
    assert str(mine.value) == str(theirs.value)


def test_elastic_resumes_a_dirty_directory(tmp_path, monkeypatch, capsys):
    """``--elastic`` over a directory that holds a finished run's saves
    restores the latest and logs it, where a plain run is refused."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "256")
    argv = ["-b", "32", "-d", "cpu", "--checkpoint-dir", str(tmp_path),
            "-e", "1"]
    tbase.run_workload(tget("mlp"), tconfig.parse_args(argv, "mlp"))
    with pytest.raises(ValueError, match="already holds checkpoints"):
        tbase.run_workload(tget("mlp"), tconfig.parse_args(argv, "mlp"))
    capsys.readouterr()
    state, hist = tbase.run_workload(
        tget("mlp"), tconfig.parse_args(argv[:-1] + ["2", "--elastic"],
                                        "mlp"))
    assert "elastic: restored checkpoint step 1; continuing from epoch 2" \
        in capsys.readouterr().out
    train = [h for h in hist if h.phase == "train"]
    assert [h.epoch for h in train] == [2]
    assert state.step == 2 * train[0].examples // 32
    assert torch.isfinite(next(state.model.parameters())).all()
