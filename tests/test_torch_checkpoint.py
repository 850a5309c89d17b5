"""Checkpoints of the port (``utils/checkpoint.py``, ``train/elastic.py``
``resume_point``, ``fit``'s saves and ``--resume``), on the CPU.

Checked: a save restores exactly (parameters, optimizer state, update
count, dropout generator, sidecar) and its manifest holds a CRC32 per
leaf; a step whose contents no longer match its manifest, or whose file is
torn, is quarantined (renamed, never deleted) and the previous step
restored; a step that verifies but does not fit the run (another world
size, or dropout where the run has none) is refused, not quarantined; a
directory holding checkpoints is refused without ``--resume``; a checkpoint id past the run's final id is refused; and a
run stopped after a mid-epoch save (``--checkpoint-every``) and resumed is
bit-identical to the run that was never stopped, with dropout on, in
``-m sequential`` and in ``-m data`` (gloo, world 1).  The phase totals,
which the resumed run adds from the sidecar, agree within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu_torch.models.transformer import CausalLM
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from distributed_deep_learning_tpu_torch.train.elastic import resume_point
from distributed_deep_learning_tpu_torch.train.state import \
    create_train_state
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.utils.checkpoint import (
    Checkpointer, CheckpointCorruption, load_payload)
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

SMALL = ["-l", "2", "-s", "32", "-b", "8", "-d", "cpu", "--dropout", "0.1"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads run them as fast as
    eight, without spinning against the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _state(seed=0):
    model = CausalLM(vocab_size=31, num_layers=1, d_model=16, num_heads=2,
                     mlp_dim=32, max_len=8, with_logits=True,
                     dropout_rate=0.1)
    return create_train_state(model, seed, tbase.adamw(1e-2), device="cpu",
                              dropout_seed=seed + 1)


def _train(state, steps=2, seed=0):
    train_step, _ = make_step_fns(tobj.TokenCrossEntropy())
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x = torch.from_numpy(rng.integers(1, 31, (4, 8)).astype(np.int32))
        train_step(state, x, torch.roll(x, -1, 1))
    return state


def _same_state(a, b):
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_round_trip_restores_everything(tmp_path):
    state = _train(_state())
    ckpt = Checkpointer(tmp_path)
    extra = {"epoch": 1, "batch": 2, "epoch_complete": False,
             "totals": {"loss": 1.5, "correct": 3.0, "count": 8.0}}
    assert ckpt.save(2, state, extra=extra)
    assert not ckpt.save(2, state)                 # an existing id is kept
    fresh = _state(seed=5)
    assert ckpt.restore(fresh) is fresh
    _same_state(fresh, state)
    assert ckpt.read_extra(2) == extra
    assert resume_point(ckpt) == (2, 1, 2, extra["totals"])
    manifest = ckpt.read_manifest(2)
    assert manifest["all_finite"]
    leaves = manifest["leaves"]
    assert "/params/tok.weight" in leaves and "/generator/0" in leaves
    assert all("crc32" in r for r in leaves.values())
    assert any(k.startswith("/optimizer/state/") for k in leaves)
    # the same draws after the restore as after the save
    _same_state(_train(fresh, 1, seed=9), _train(state, 1, seed=9))


def test_keeps_the_newest_three(tmp_path):
    state, ckpt = _state(), Checkpointer(tmp_path)
    for step in range(1, 6):
        ckpt.save(step, state, extra={"epoch": step, "batch": 0,
                                      "epoch_complete": True})
    assert ckpt.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{kind}-{s}.{ext}" for s in (3, 4, 5)
        for kind, ext in (("ckpt", "pt"), ("extra", "json"),
                          ("manifest", "json")))


@pytest.mark.parametrize("damage", ["contents", "torn"])
def test_damaged_step_is_quarantined_and_the_previous_restored(tmp_path,
                                                               damage):
    ckpt = Checkpointer(tmp_path)
    state = _train(_state())
    ckpt.save(1, state)
    good = _state(seed=3)
    ckpt.restore(good)
    ckpt.save(2, _train(state, 1))
    path = tmp_path / "ckpt-2.pt"
    if damage == "contents":          # a valid file that is not the save
        payload = torch.load(path, weights_only=True)
        payload["params"]["tok.weight"][0, 0] += 1.0
        torch.save(payload, path)
        with pytest.raises(CheckpointCorruption, match="checksum mismatch "
                                                       "at leaf"):
            ckpt.load(2)
    else:
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    target = _state(seed=7)
    restored, used = ckpt.restore_verified(target)
    assert used == 1 and restored is target
    _same_state(target, good)
    assert ckpt.all_steps() == [1]
    qdir = tmp_path / "quarantine"
    assert (qdir / "ckpt-2.pt").exists()
    assert (qdir / "ckpt-2.pt-manifest-2.json").exists()
    reason = json.loads((qdir / "ckpt-2.pt.reason.json").read_text())
    assert reason["step"] == 2 and reason["reason"]


def test_a_checkpoint_that_does_not_fit_the_run_is_refused_not_quarantined(
        tmp_path):
    """A step that verifies but was saved by another world size, or with
    dropout where the run has none, raises and stays where it is."""
    state, ckpt = _train(_state()), Checkpointer(tmp_path)
    ckpt.save(1, state)
    with pytest.raises(ValueError, match="dropout streams of 1 rank"):
        load_payload(_state(seed=2), ckpt.load(1), rank=1, world=2)
    no_dropout = create_train_state(
        CausalLM(vocab_size=31, num_layers=1, d_model=16, num_heads=2,
                 mlp_dim=32, max_len=8, with_logits=True),
        0, tbase.adamw(1e-2), device="cpu")
    with pytest.raises(ValueError, match="disagree on dropout"):
        ckpt.restore_verified(no_dropout)
    assert ckpt.all_steps() == [1]
    assert not (tmp_path / "quarantine").exists()


def _run(argv, monkeypatch):
    monkeypatch.setenv("DDL_DATA_LIMIT", "64")
    return tbase.run_workload(tns.GPT_SPEC,
                              tconfig.parse_args(argv, workload="gpt"))


def test_dirty_directory_without_resume_is_refused(tmp_path, monkeypatch):
    argv = SMALL + ["-e", "1", "--checkpoint-dir", str(tmp_path)]
    _run(argv, monkeypatch)
    with pytest.raises(ValueError, match="pass --resume"):
        _run(argv, monkeypatch)


def test_checkpoint_past_the_final_id_is_refused(tmp_path, monkeypatch):
    """Step ids (every 2 of 5 steps) resumed without --checkpoint-every,
    whose epoch ids (1, 2) could never pass them."""
    _run(SMALL + ["-e", "2", "--checkpoint-dir", str(tmp_path),
                  "--checkpoint-every", "2"], monkeypatch)
    os.remove(tmp_path / "ckpt-10.pt")       # left: 9, epoch 2 at batch 4
    with pytest.raises(ValueError, match="existing checkpoint id 9 >= this "
                                         "run's final id 2"):
        _run(SMALL + ["-e", "2", "--checkpoint-dir", str(tmp_path),
                      "--resume"], monkeypatch)


@pytest.mark.parametrize("mode", ["sequential", "data"])
def test_mid_epoch_resume_is_bit_identical(tmp_path, monkeypatch, mode):
    """2 epochs of 5 steps, saves every 2 steps (ids 2, 4, 5, 7, 9, 10;
    the newest three kept).  Removing 9 and 10 leaves epoch 2's batch 2,
    and the resumed run trains batches 3-5 of epoch 2 as the uninterrupted
    run did."""
    argv = ["-m", mode] + SMALL + ["-e", "2", "--checkpoint-every", "2"]
    whole_state, whole = _run(argv + ["--checkpoint-dir",
                                      str(tmp_path / "a")], monkeypatch)
    ckdir = tmp_path / "b"
    _run(argv + ["--checkpoint-dir", str(ckdir)], monkeypatch)
    assert Checkpointer(ckdir).all_steps() == [7, 9, 10]
    for step in (9, 10):
        for name in (f"ckpt-{step}.pt", f"extra-{step}.json",
                     f"manifest-{step}.json"):
            os.remove(ckdir / name)
    assert resume_point(Checkpointer(ckdir))[1:3] == (2, 2)
    state, resumed = _run(argv + ["--checkpoint-dir", str(ckdir),
                                  "--resume"], monkeypatch)
    assert [h.phase for h in resumed] == ["train", "validation", "test"]
    assert resumed[0].step_losses == whole[2].step_losses[2:]
    for mine, theirs in zip(resumed, whole[2:]):
        assert mine.examples == theirs.examples
        np.testing.assert_allclose([mine.loss, mine.accuracy],
                                   [theirs.loss, theirs.accuracy],
                                   rtol=1e-6, err_msg=mine.phase)
    assert resumed[1:] and [h.loss for h in resumed[1:]] == \
        [h.loss for h in whole[3:]]
    _same_state(state, whole_state)
    assert Checkpointer(ckdir).all_steps() == [7, 9, 10]
