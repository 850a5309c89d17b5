"""The staged modes' runs in the port alone: a mid-epoch ``--resume`` of
``gpt -m pipeline --pipeline-schedule 1f1b --dropout 0.1`` is
bit-identical to the run that was never stopped (the dropout generator
rides in the checkpoint); each schedule's forward launches on the CPU are
none (the flash kernels' plain versions run there); and the refusals:
JAX's, with its messages (the MPMD flag list, interleaved without
``--virtual-stages >= 2``, ``--remat-policy`` under 1F1B, ``moe`` under
either staged mode), and the port's own where JAX drops a flag
silently (``--grad-accum`` under ``-m pipeline``, ``--stem-s2d`` on the
staged ResNet, ``--attention flash`` on a staged LM layer list) or where
one card cannot hold the run (a multi-rank launch)."""

import os

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu.workloads import get_spec as jget
from distributed_deep_learning_tpu_torch.__main__ import main
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.train.elastic import resume_point
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

PIPE = ["gpt", "-m", "pipeline", "--nstages", "2", "-l", "4", "-s", "32",
        "-b", "8", "-p", "2", "-d", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_mid_epoch_resume_under_1f1b_is_bit_identical(tmp_path,
                                                      monkeypatch):
    """2 epochs of 5 steps, saves every 2 steps (ids 2, 4, 5, 7, 9, 10;
    the newest three kept); removing 9 and 10 leaves epoch 2's batch 2,
    and the resumed run trains batches 3-5 of epoch 2 as the
    uninterrupted run did, with the same dropout masks."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = PIPE + ["--pipeline-schedule", "1f1b", "--dropout", "0.1", "-e",
                   "2", "--checkpoint-every", "2"]
    whole_state, whole = main(argv + ["--checkpoint-dir",
                                      str(tmp_path / "a")])
    ckdir = tmp_path / "b"
    main(argv + ["--checkpoint-dir", str(ckdir)])
    assert Checkpointer(ckdir).all_steps() == [7, 9, 10]
    for step in (9, 10):
        for name in (f"ckpt-{step}.pt", f"extra-{step}.json",
                     f"manifest-{step}.json"):
            os.remove(ckdir / name)
    assert resume_point(Checkpointer(ckdir))[1:3] == (2, 2)
    state, resumed = main(argv + ["--checkpoint-dir", str(ckdir),
                                  "--resume"])
    assert [h.phase for h in resumed] == ["train", "validation", "test"]
    assert resumed[0].step_losses == whole[2].step_losses[2:]
    assert [h.loss for h in resumed[1:]] == [h.loss for h in whole[3:]]
    for (k, a), (_, b) in zip(whole_state.model.state_dict().items(),
                              state.model.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    assert whole_state.generator.get_state().equal(
        state.generator.get_state())


def test_dropout_changes_the_steps_and_is_seeded(monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    argv = PIPE + ["--pipeline-schedule", "interleaved", "-e", "1"]
    plain = main(argv)[1][0].step_losses
    drop = [main(argv + ["--dropout", "0.2"])[1][0].step_losses
            for _ in range(2)]
    assert drop[0] == drop[1]
    assert drop[0][0] != plain[0]


def test_cpu_runs_launch_no_kernel(monkeypatch):
    """``--attention flash`` on the CPU: every schedule runs the flash
    kernels' plain versions, so no launch counter moves."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    before = [c.launches for c in counters]
    for sched in ("gpipe", "1f1b", "interleaved"):
        _, hist = main(PIPE + ["--pipeline-schedule", sched, "-e", "1",
                               "--attention", "flash"])
        assert all(np.isfinite([h.loss for h in hist]))
    assert [c.launches for c in counters] == before


#: (workload, argv): JAX's refusals, its message matched
JAX_REFUSALS = {
    "mpmd checkpoint": ("mlp", ["-m", "model", "--checkpoint-dir", "d"]),
    "mpmd resume": ("cnn", ["-m", "pipeline", "--resume"]),
    "mpmd grad-accum": ("lstm", ["-m", "model", "--grad-accum", "2"]),
    "mpmd remat": ("mnist", ["-m", "pipeline", "--remat"]),
    "mpmd dropout": ("gpt", ["-m", "model", "--dropout", "0.1", "-l", "2",
                             "-s", "32"]),
    "mpmd several": ("resnet", ["-m", "model", "--remat", "--dropout",
                                "0.1"]),
    "interleaved v1": ("gpt", ["-m", "pipeline", "--pipeline-schedule",
                               "interleaved", "--virtual-stages", "1"]),
    "1f1b remat policy": ("bert", ["-m", "pipeline", "--pipeline-schedule",
                                   "1f1b", "--remat", "--remat-policy",
                                   "dots"]),
    "moe model": ("moe", ["-m", "model"]),
}


@pytest.mark.parametrize("case", list(JAX_REFUSALS))
def test_refusals_match_jax(case, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    workload, argv = JAX_REFUSALS[case]
    argv = argv + ["-e", "1", "-d", "cpu"]
    with pytest.raises(ValueError) as theirs:
        jbase.run_workload(jget(workload),
                           jconfig.parse_args(argv, workload=workload))
    with pytest.raises(ValueError) as mine:
        tbase.run_workload(tget(workload),
                           tconfig.parse_args(argv, workload=workload))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("argv,error,match", [
    (["moe", "-m", "pipeline"], ValueError,
     "moe parallelises over experts, not stages"),
    (PIPE[:1] + ["-m", "pipeline", "--grad-accum", "2"], ValueError,
     "--grad-accum: -m pipeline takes no gradient accumulation"),
    (["resnet", "-m", "model", "--stem-s2d"], ValueError,
     "no space-to-depth form"),
    (["bert", "-m", "model", "--attention", "flash"], ValueError,
     "attends densely"),
    (["mlp", "-m", "pipeline", "-r", "2"], ValueError,
     "-m pipeline of 'mlp' is the staged MPMD path"),
])
def test_port_refusals(argv, error, match, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "32")
    with pytest.raises(error, match=match):
        main(argv + ["-e", "1", "-d", "cpu"])


def test_generate_and_serve_after_a_staged_run_are_skipped(monkeypatch,
                                                           capsys):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    main(PIPE + ["-e", "1", "--generate", "300", "--serve"])
    out = capsys.readouterr().out
    assert "generate skipped: --generate needs the whole-model" in out
    assert "serve skipped: --serve needs the whole-model" in out


def test_microbatch_snaps_to_a_divisor(monkeypatch, capsys):
    """``-p 3`` on ``-b 8``: JAX's snapping at ``dp = 1`` picks 2 (the
    nearest divisor, the smaller on a tie) and logs it."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    assert tbase.snap_microbatch(8, 3) == 2
    assert tbase.snap_microbatch(8, 5) == 4
    assert tbase.snap_microbatch(8, 6) == 4
    assert tbase.snap_microbatch(8, 7) == 8
    main(PIPE[:-4] + ["-b", "8", "-p", "3", "-d", "cpu", "-e", "1"])
    assert "microbatch 3 incompatible with batch 8 / dp 1; using 2" in \
        capsys.readouterr().out
