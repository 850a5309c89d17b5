"""Asynchronous checkpoint saves (``utils/checkpoint.py``).

``save(..., wait=False)`` snapshots the state and writes it on a thread:
its file holds, leaf for leaf and byte for byte, what a synchronous save
of the same state holds (the two zip archives differ only in their
member prefix and serialization id, so the leaves and the manifests are
compared), also when the state is updated in place while the thread
writes.  The planted race, a snapshot that keeps the live tensors
instead of copying them, must be caught by that same comparison.  On
the card the copy runs on a side stream and may land late; every
in-place writer of the saved tensors (the update, ``--comm``'s gathers)
first waits on its fence: with the copy held back until a fence wait,
the file is the state at the save, and the planted race (a fence wait
that does nothing) is caught.  A
writer that dies mid-write leaves no finalised step: the previous one
stays the latest, the error is raised at ``wait_until_finished`` and a
verified restore finds the previous step.  The training loop's saves
are asynchronous and the loop waits before the test phase: a run with
``--checkpoint-every`` saves every step it would save synchronously."""

import os
import threading
import time

import pytest
import torch

from distributed_deep_learning_tpu_torch.models.mlp import MLP
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, TrainState, create_train_state)
from distributed_deep_learning_tpu_torch.train.step import make_step_fns
from distributed_deep_learning_tpu_torch.train.objectives import \
    cross_entropy_loss
from distributed_deep_learning_tpu_torch.utils import checkpoint as ck
from distributed_deep_learning_tpu_torch.utils.determinism import diff_trees
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def _batch(g):
    x = torch.randn(8, 12, generator=g)
    return x, torch.nn.functional.one_hot(torch.arange(8) % 5, 5).float()


def _state(steps: int = 2):
    state = create_train_state(MLP(12, hidden_size=32), 3,
                               Optimizer("adamw", 1e-2), device="cpu",
                               dropout_seed=4)
    step, _ = make_step_fns(cross_entropy_loss)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        state, _ = step(state, *_batch(g))
    return state


def _file(directory, step):
    return torch.load(os.path.join(directory, f"ckpt-{step}.pt"),
                      weights_only=True)


def _bump(state):
    """An in-place update of everything a save reads."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for st in state.optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v) and v.is_floating_point():
                    v.add_(1.0)


@pytest.fixture
def slow_writer(monkeypatch):
    """The writer thread sleeps before it serialises the snapshot, so an
    update made right after ``save`` returns lands during the write."""
    real = ck.torch.save

    def slow(obj, f, *a, **kw):
        time.sleep(0.3)
        return real(obj, f, *a, **kw)
    monkeypatch.setattr(ck.torch, "save", slow)


def _save_async_then_bump(tmp_path, name):
    state = _state()
    want = ck.state_payload(state)
    c = ck.Checkpointer(tmp_path / name, shared=False)
    assert c.save(5, state, wait=False, extra={"epoch": 1})
    _bump(state)                        # while the thread writes
    c.wait_until_finished()
    return want, _file(tmp_path / name, 5), c


def test_async_save_equals_a_sync_save(tmp_path, slow_writer):
    want, got, c = _save_async_then_bump(tmp_path, "async")
    sync = ck.Checkpointer(tmp_path / "sync", shared=False)
    state = _state()
    assert sync.save(5, state)
    assert diff_trees(got, want) == []
    assert diff_trees(got, _file(tmp_path / "sync", 5)) == []
    assert c.read_manifest(5)["leaves"] == sync.read_manifest(5)["leaves"]
    assert c.read_extra(5) == {"epoch": 1}
    restored, used = c.restore_verified(_state(0))
    assert used == 5
    assert diff_trees(ck.state_payload(restored), want) == []


def test_planted_live_snapshot_is_caught(tmp_path, slow_writer,
                                         monkeypatch):
    """The planted fault: the snapshot hands the writer the live tensors
    (no copy), so the update made during the write reaches the file."""
    monkeypatch.setattr(ck, "_snapshot", lambda payload: (payload, None))
    want, got, _ = _save_async_then_bump(tmp_path, "planted")
    bad = diff_trees(got, want)
    assert bad and any(p.startswith("/params/") for p in bad)


def test_crash_mid_write_leaves_no_finalised_step(tmp_path, monkeypatch):
    state = _state()
    c = ck.Checkpointer(tmp_path / "crash", shared=False)
    assert c.save(1, state)
    real = ck.torch.save

    def torn(obj, f, *a, **kw):
        with open(f, "wb") as out:            # half a file, then death
            out.write(b"PK\x03\x04" + b"\0" * 64)
        raise OSError("disk went away mid-write")
    monkeypatch.setattr(ck.torch, "save", torn)
    assert c.save(2, _state(3), wait=False)
    with pytest.raises(OSError, match="mid-write"):
        c.wait_until_finished()
    monkeypatch.setattr(ck.torch, "save", real)
    assert c.all_steps() == [1]
    assert not os.path.exists(tmp_path / "crash" / "ckpt-2.pt")
    restored, used = c.restore_verified(_state(0))
    assert used == 1
    assert diff_trees(ck.state_payload(restored),
                      ck.state_payload(state)) == []


def test_one_save_in_flight_and_replayed_ids_skipped(tmp_path, slow_writer):
    state = _state()
    c = ck.Checkpointer(tmp_path / "two", shared=False)
    t0 = time.perf_counter()
    assert c.save(1, state, wait=False)
    returned = time.perf_counter() - t0
    assert c.save(2, state, wait=False)       # waits for save 1 first
    assert not c.save(2, state, wait=False)   # an existing id is kept
    c.close()
    assert c.all_steps() == [1, 2]
    assert returned < 0.3                     # the write was not waited on


class CopyInFlight:
    """The card's snapshot, on the host: the copy into the host buffers
    lands when a trainer waits on the fence (``wait``, what
    ``TrainState.wait_fence`` calls), else only when the test lets it
    (``land``), after the next step has run: as late as a side stream's
    copy may land.  The writer thread waits for it (``synchronize``)."""

    def __init__(self):
        self.pairs, self.lock = [], threading.Lock()
        self.landed = threading.Event()

    def snapshot(self, payload):
        def walk(o):
            if torch.is_tensor(o):
                self.pairs.append((o, torch.empty_like(o)))
                return self.pairs[-1][1]
            if isinstance(o, dict):
                return {k: walk(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(walk(v) for v in o)
            return o
        return walk(payload), self

    @torch.no_grad()
    def land(self):
        with self.lock:
            if not self.landed.is_set():
                for src, dst in self.pairs:
                    dst.copy_(src)
                self.landed.set()

    wait = land

    def synchronize(self):
        self.landed.wait()


class WritingGather:
    """``--comm``'s party, cut to what the fence guards: its gather
    writes the model's parameters in place (shifted, so a late copy
    shows it); its reduction leaves the gradients as they are."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def gather(self, exact=False):
        for p in self.model.parameters():
            p.add_(1.0)

    def reduce_gradients(self, residual):
        pass


@pytest.mark.parametrize("site", ["update", "comm gather", "comm eval"])
@pytest.mark.parametrize("fenced", [True, False],
                         ids=["fenced", "planted_unfenced"])
def test_fence_holds_writers_until_the_copy_lands(tmp_path, monkeypatch,
                                                  site, fenced):
    """A save whose copy lands late, then at once the next writer of the
    saved tensors: the optimizer's update, ``--comm``'s gather in the
    train step, or its exact gather in the eval step.  Each waits on the
    fence first, so the file is the state at the save; with the fence
    wait planted away, the write reaches the file and is caught."""
    fence = CopyInFlight()
    monkeypatch.setattr(ck, "_snapshot", fence.snapshot)
    if not fenced:
        monkeypatch.setattr(TrainState, "wait_fence", lambda self: None)
    state = _state()
    comm = None if site == "update" else WritingGather(state.model)
    train_step, eval_step = make_step_fns(cross_entropy_loss, comm=comm)
    want = ck.state_payload(state)
    c = ck.Checkpointer(tmp_path / "fence", shared=False)
    assert c.save(5, state, wait=False)
    assert state.fence is fence
    x, y = _batch(torch.Generator().manual_seed(9))
    if site == "comm eval":
        eval_step(state, x, y)
    else:
        train_step(state, x, y)
    assert fence.landed.is_set() == fenced
    fence.land()
    c.wait_until_finished()
    bad = diff_trees(_file(tmp_path / "fence", 5), want)
    if fenced:
        assert bad == []
        assert state.fence is None
    else:
        assert any(p.startswith("/params/") for p in bad)
