"""The port's resharding (``reshard/``) against the JAX package's, on the
CPU.

* The spec's JSON round trip (the same lists as JAX's ``spec_to_json``);
  ``Topology.from_json`` rejecting garbage and the port's earlier
  ``{"mesh", "zero"}`` block; ``same_topology`` ignoring size-1 axes.
* The sidecar carrying the topology.
* The four restore modes: ``legacy``, ``same``, ``chunked`` and
  ``gather``, all giving the saved bytes; and a checkpoint saved by two
  gloo ranks under ``--zero 1``, restored at world 1 (``gather``) and
  onto ``fsdp=2`` by two ranks (``chunked``), bit for bit against the
  saved whole tensors (what a same-topology restore gives).
* A corrupt latest step falling back across topologies, quarantined;
  ``ReshardGeometryError``'s message; an empty directory.
* ``choose_plan``'s plan and hash equal to JAX's for ``(8, 96)``,
  ``(6, 96)`` and ``(6, 64) → 4``, and the exhausted lattice's error;
  ``shrink_topology`` giving JAX's survivors and dead list.
"""

import os

import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_deep_learning_tpu.reshard import manifest as jmanifest
from distributed_deep_learning_tpu.reshard import replan as jreplan
from distributed_deep_learning_tpu.tune import plan_hash as jplan_hash
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu_torch.models.mlp import MLP
from distributed_deep_learning_tpu_torch.reshard import manifest as tmanifest
from distributed_deep_learning_tpu_torch.reshard import replan as treplan
from distributed_deep_learning_tpu_torch.reshard.redistribute import (
    CHUNK_THRESHOLD_BYTES, chunked_device_put, copy_chunked)
from distributed_deep_learning_tpu_torch.reshard.restore import (
    ReshardGeometryError, make_restore_fn, restore_resharded)
from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from distributed_deep_learning_tpu_torch.runtime.mesh import AXES
from distributed_deep_learning_tpu_torch.train.state import (
    Optimizer, create_train_state)
from distributed_deep_learning_tpu_torch.tune import plan_hash as tplan_hash
from distributed_deep_learning_tpu_torch.utils.chaos import ChaosPlan
from distributed_deep_learning_tpu_torch.utils.checkpoint import (
    Checkpointer, state_payload)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

TWO = {a: 1 for a in AXES} | {"data": 2}
ONE = dict(TWO, data=1)
PINNED = {"dtypes": ("float32",), "grad_accum_options": (1,),
          "attention_options": ("auto",), "zero_options": ("1",),
          "compress_options": ("none",)}
TIMEOUT = 240


def _state(seed=0, hidden=4, steps=1):
    """A small MLP state with Adam moments (``steps`` updates)."""
    state = create_train_state(MLP(8, hidden_size=hidden), seed,
                               Optimizer("adam", 1e-3), device="cpu")
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(seed))
    for _ in range(steps):
        state.optimizer.zero_grad()
        state.model(x).square().mean().backward()
        state.apply_gradients()
    return state


def _same(a, b) -> bool:
    from distributed_deep_learning_tpu_torch.reshard.drill import _same

    return _same(a, b)


def test_spec_json_round_trip_equals_jax():
    for entries in ((), ("data",), (None, "data"), (("data", "fsdp"),),
                    ("data", None, "model"), ("@data",)):
        j = tmanifest.spec_to_json(entries)
        assert tmanifest.spec_from_json(j) == tmanifest._canonical_entries(
            entries)
        if entries != ("@data",):
            assert j == jmanifest.spec_to_json(P(*entries))
    assert tmanifest.spec_to_json(("data", None, None)) == ["data"]


def test_topology_json_round_trip_and_garbage():
    topo = tmanifest.capture(_state(), TWO)
    assert topo.n_devices == 2 and topo.normalized_mesh() == (("data", 2),)
    parsed = tmanifest.Topology.from_json(topo.to_json())
    assert tmanifest.same_topology(topo, parsed)
    assert topo.describe() == "mesh[data=2]x2dev"
    for bad in (None, "not a dict", {"mesh": "nope"},
                {"mesh": TWO, "zero": "1"}):        # the earlier block
        assert tmanifest.Topology.from_json(bad) is None


def test_same_topology_ignores_size_one_axes():
    specs = {"/params/w": ("data",)}
    a = tmanifest.Topology((("data", 8),), 8, specs)
    b = tmanifest.Topology(tuple((x, 8 if x == "data" else 1)
                                 for x in AXES), 8, specs)
    c = tmanifest.Topology((("data", 4),), 4, specs)
    assert tmanifest.same_topology(a, b)
    assert not tmanifest.same_topology(a, c)
    assert not tmanifest.same_topology(a, None)


def test_sidecar_carries_topology(tmp_path):
    state = _state()
    with Checkpointer(tmp_path / "ck", mesh=TWO) as ck:
        ck.save(1, state)
        topo = ck.read_topology(1)
    assert tmanifest.same_topology(topo, tmanifest.capture(state, TWO))
    assert set(topo.leaf_specs) >= {f"/params/{k}" for k in
                                    state.model.state_dict()}
    assert Checkpointer(tmp_path / "plain").read_topology(1) is None


@pytest.mark.parametrize("method", ["auto", "chunked", "gather"])
def test_restore_modes_give_the_saved_bytes(tmp_path, method):
    saved = _state(steps=2)
    Checkpointer(tmp_path / "a", mesh=TWO).save(1, saved)
    Checkpointer(tmp_path / "b").save(1, saved)            # no topology
    want = state_payload(saved)
    cases = [("a", TWO, "same"), ("b", ONE, "legacy"),
             ("a", ONE, "gather" if method == "gather" else "chunked")]
    for name, mesh, mode in cases:
        fn = make_restore_fn(Checkpointer(tmp_path / name, mesh=mesh), mesh,
                             method=method)
        got, step = fn(_state(seed=1))
        assert (step, fn.last_info["mode"]) == (1, mode)
        payload = state_payload(got)
        assert _same(want["params"], payload["params"])
        assert _same(want["optimizer"]["state"],
                     payload["optimizer"]["state"])
    assert fn.last_info["redistribute"]["bytes_moved"] > 0


def test_chunked_puts_stay_within_their_pieces():
    big = torch.arange(3 * CHUNK_THRESHOLD_BYTES // 4,
                       dtype=torch.float32).reshape(-1, 256)
    out = chunked_device_put(big, "meta")
    assert out.shape == big.shape and out.device.type == "meta"
    dst = torch.empty_like(big)
    assert torch.equal(copy_chunked(dst, big, chunk_bytes=4096), big)


def test_corrupt_latest_falls_back_across_topologies(tmp_path):
    ck = Checkpointer(tmp_path, mesh=TWO)
    ck.save(1, _state(steps=1))
    ck.save(2, _state(steps=2))
    ChaosPlan.bitflip_checkpoint(str(tmp_path), 2)
    got, step, info = restore_resharded(Checkpointer(tmp_path, mesh=ONE),
                                        _state(seed=3), mesh=ONE)
    assert (step, info["mode"]) == (1, "chunked")
    assert _same(state_payload(_state(steps=1))["params"],
                 state_payload(got)["params"])
    assert os.listdir(tmp_path / "quarantine")
    assert Checkpointer(tmp_path).all_steps() == [1]


def test_wrong_model_raises_the_geometry_error(tmp_path):
    Checkpointer(tmp_path, mesh=TWO).save(1, _state())
    with pytest.raises(ReshardGeometryError) as e:
        restore_resharded(Checkpointer(tmp_path, mesh=ONE),
                          _state(hidden=6), mesh=ONE)
    assert str(e.value).startswith(
        "checkpoint step 1 cannot reshard onto this state — leaf geometry "
        "differs (/params/")
    assert "saved (4, 8) vs target (6, 8)" in str(e.value)
    assert Checkpointer(tmp_path).all_steps() == [1]      # not quarantined


def test_empty_dir_returns_none(tmp_path):
    assert restore_resharded(Checkpointer(tmp_path, mesh=ONE), _state(),
                             mesh=ONE) == (None, None, {"mode": None})


@pytest.mark.parametrize("n,batch,want", [(8, 96, 8), (6, 96, 6),
                                          (6, 64, 4)])
def test_choose_plan_equals_jax(n, batch, want):
    mine = treplan.choose_plan(n, batch, space_options=PINNED)
    theirs = jreplan.choose_plan(n, batch, space_options=PINNED)
    assert mine.to_dict() == theirs.to_dict()
    assert tplan_hash(mine) == jplan_hash(theirs)
    assert mine.n_devices == want


def test_choose_plan_exhausted_raises_as_jax():
    with pytest.raises(ValueError) as mine:
        treplan.choose_plan(2, 7, allow_fewer=False, space_options=PINNED)
    with pytest.raises(ValueError) as theirs:
        jreplan.choose_plan(2, 7, allow_fewer=False, space_options=PINNED)
    assert str(mine.value) == str(theirs.value)
    assert "no legal plan" in str(mine.value)


@pytest.mark.parametrize("n,kill", [(8, 2), (4, 1), (6, 3)])
def test_shrink_topology_equals_jax(n, kill):
    for seed in range(5):
        assert ChaosPlan.shrink_topology(range(n), kill, seed) == \
            jchaos.ChaosPlan.shrink_topology(range(n), kill, seed)
    for bad in (0, n):
        with pytest.raises(ValueError, match="kill"):
            ChaosPlan.shrink_topology(range(n), kill=bad)


def test_two_rank_zero1_save_restores_at_world_1_and_onto_fsdp(
        tmp_path, monkeypatch):
    """Two gloo ranks save ``--zero 1`` (ZeRO's whole-parameter split of
    the moments); the checkpoint restores at world 1 (gather) and onto
    ``fsdp=2`` by two ranks (chunked, FSDP2's ``Shard(0)``), each equal
    to the saved whole tensors bit for bit."""
    monkeypatch.setenv("DDL_DATA_LIMIT", "128")
    d = str(tmp_path / "ck")
    base = ["mlp", "-m", "data", "--zero", "1", "-d", "cpu", "-b", "32",
            "--checkpoint-dir", d]
    launch_local(2, base + ["-r", "2", "-e", "1"], device="cpu",
                 timeout=TIMEOUT)
    out = str(tmp_path / "fsdp.pt")
    launch_local(2, ["--restore", out, "chunked", *base[:4], "fsdp", *base[
        5:], "-r", "2", "-e", "2", "--reshard", "--resume", "--target-mesh",
        "fsdp=2"], device="cpu", timeout=TIMEOUT,
        module="distributed_deep_learning_tpu_torch.reshard.drill")
    saved = torch.load(os.path.join(d, "ckpt-1.pt"), weights_only=True)
    got = torch.load(out, weights_only=False)
    assert got["info"]["mode"] == "chunked" and got["step"] == 1
    assert "fsdp=2" in got["info"]["target"]
    for part in ("params", "optimizer"):
        want = saved[part] if part == "params" else saved[part]["state"]
        have = got["payload"][part] if part == "params" else \
            got["payload"][part]["state"]
        assert _same(want, have), part
    # world 1: a plain -m data state, the moments gathered onto it
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        build_optimizer

    cfg = parse_args(base[1:] + ["-e", "2"], "mlp")
    spec = get_spec("mlp")
    state = create_train_state(spec.build_model(cfg, spec.build_dataset(cfg)),
                               7, build_optimizer(spec, cfg, 1),
                               device="cpu")
    one, step, info = restore_resharded(Checkpointer(d, mesh=ONE), state,
                                        mesh=ONE, method="gather")
    assert (step, info["mode"]) == (1, "gather")
    payload = state_payload(one)
    assert _same(saved["params"], payload["params"])
    assert _same(saved["optimizer"]["state"], payload["optimizer"]["state"])
