"""The port's mesh shapes and parse-time checks against the JAX
package's: ``MeshSpec`` (``from_dict``, ``resolve`` with one -1 fill),
``parse_mesh_arg`` and the ``--mesh stage=`` / ``--nstages`` conflict
(messages included), ``leaf_shard_spec``, ``local_batch_size`` and
``mesh_for_mode``; and the runner's sharding decision
(``derive_state_spec``) in JAX's order and words."""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_deep_learning_tpu.parallel import zero as jzero
from distributed_deep_learning_tpu.runtime import mesh as jmesh
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu_torch.parallel import zero as tzero
from distributed_deep_learning_tpu_torch.runtime import mesh as tmesh
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec as tget
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def _outcome(fn):
    try:
        return "ok", fn()
    except (ValueError, SystemExit) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("shape,n", [
    ({"data": 2, "model": 2}, 4), ({"data": -1, "model": 2}, 8),
    ({"fsdp": -1}, 4), ({"expert": 2}, 2), ({"data": -1, "fsdp": -1}, 4),
    ({"data": 3, "model": 2}, 4), ({"data": -1, "model": 3}, 8),
    ({"bogus": 2}, 2), ({}, 1),
])
def test_mesh_spec_matches_jax(shape, n):
    def sizes(mod):
        return lambda: mod.MeshSpec.from_dict(shape).resolve(n).sizes()
    assert _outcome(sizes(tmesh)) == _outcome(sizes(jmesh))
    assert tmesh.AXES == jmesh.AXES == jconfig.MESH_AXES


@pytest.mark.parametrize("text", [
    "data=2,model=2", "data=-1,expert=2", "fsdp=4", "model", "data=2,data=2",
    "bogus=2", "data=x", "data=0", "data=-2", "data=-1,model=-1", "",
])
def test_parse_mesh_arg_matches_jax(text):
    assert _outcome(lambda: tconfig.parse_mesh_arg(text)) == \
        _outcome(lambda: jconfig.parse_mesh_arg(text))


@pytest.mark.parametrize("argv", [
    ["--mesh", "stage=2", "--nstages", "4"],
    ["--mesh", "data=2,model=2", "--zero", "fsdp"],
    ["--mesh", "data=-1", "--zero", "1"],
])
def test_parse_args_mesh_checks_match_jax(argv):
    def parse(mod):
        def run():
            cfg = mod.parse_args(argv, workload="gpt")
            return cfg.mesh_shape, cfg.zero
        return run
    assert _outcome(parse(tconfig)) == _outcome(parse(jconfig))


@pytest.mark.parametrize("shape,n,axis", [
    ((1024, 768), 2, "fsdp"), ((768, 12, 64), 2, "data"), ((3, 3), 2, "fsdp"),
    ((128, 128), 3, "fsdp"), ((16384,), 2, "fsdp"), ((16383,), 2, "fsdp"),
    ((7, 4096), 4, "fsdp"), ((4096, 7), 8, "fsdp"), ((64, 512), 1, "fsdp"),
    ((), 2, "fsdp"),
])
def test_leaf_shard_spec_matches_jax(shape, n, axis):
    class Leaf:
        pass

    leaf = Leaf()
    leaf.shape = shape
    assert P(*tzero.leaf_shard_spec(leaf, n, axis)) == \
        jzero.leaf_shard_spec(leaf, n, axis)


@pytest.mark.parametrize("mode,stages,n,explicit", [
    ("data", None, 4, None), ("sequential", None, 4, None),
    ("model", None, 4, None), ("pipeline", 2, 8, None),
    ("model", 3, 4, None), ("data", None, 8, {"data": 2, "model": -1}),
])
def test_mesh_for_mode_matches_jax(mode, stages, n, explicit):
    def jax_shape():
        mesh = jmesh.mesh_for_mode(mode, stages, jax.devices()[:n],
                                   explicit)
        return tuple(mesh.shape[a] for a in jmesh.AXES)
    assert _outcome(lambda: tmesh.mesh_for_mode(
        mode, stages, n, explicit).sizes()) == _outcome(jax_shape)


@pytest.mark.parametrize("batch,sizes", [
    (32, {"data": 2, "fsdp": 2}), (30, {"data": 4}), (8, {"model": 2}),
])
def test_local_batch_size_matches_jax(batch, sizes):
    mesh = jmesh.build_mesh(sizes, jax.devices()[:max(
        1, sizes.get("data", 1) * sizes.get("fsdp", 1)
        * sizes.get("model", 1))])
    assert _outcome(lambda: tmesh.local_batch_size(batch, sizes)) == \
        _outcome(lambda: jmesh.local_batch_size(batch, mesh))


@pytest.mark.parametrize("workload,argv,sizes,want", [
    ("mlp", ["--mesh", "model=2"], {"model": 2},
     "workload 'mlp' has no tensor-parallel sharding rules"),
    ("cnn", ["--mesh", "expert=2"], {"expert": 2},
     "workload 'cnn' has no tensor-parallel sharding rules"),
    ("gpt", ["--mesh", "model=2", "--zero", "1"], {"model": 2},
     "--zero with a model axis is not supported yet; use fsdp_axis in the "
     "TP rules instead"),
    ("gpt", ["--mesh", "model=2"], {"model": 2}, "tp"),
    ("moe", ["--mesh", "expert=2"], {"expert": 2}, "tp"),
    ("gpt", ["--zero", "1"], {"data": 2}, "zero1"),
    ("mlp", ["--zero", "fsdp"], {"data": 2}, "fsdp"),
    ("gpt", [], {"data": 2}, None),
])
def test_derive_state_spec_decides_as_jax(workload, argv, sizes, want):
    cfg = tconfig.parse_args(argv, workload)
    full = {a: sizes.get(a, 1) for a in tmesh.AXES}
    if isinstance(want, str) and " " in want:
        with pytest.raises(ValueError) as e:
            tbase.derive_state_spec(tget(workload), cfg, full)
        assert str(e.value) == want
    else:
        assert tbase.derive_state_spec(tget(workload), cfg, full) == want


def test_checkpoint_of_another_layout_is_refused(tmp_path):
    """A checkpoint records the state's topology over the run's mesh
    (:mod:`..reshard.manifest`); restoring it under another layout is
    ``--reshard``'s (the refusal names it), whose resharding restore
    gives the bytes of a same-layout restore.  One that records no
    topology, or the earlier ``{"mesh", "zero"}`` block, restores
    anywhere (legacy)."""
    import json

    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.reshard.restore import \
        restore_resharded
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.utils.checkpoint import (
        Checkpointer, state_payload)

    def state(seed=0):
        return create_train_state(MLP(8, hidden_size=4), seed,
                                  Optimizer("adam", 1e-3), device="cpu")

    two = {a: 1 for a in tmesh.AXES} | {"data": 2}
    one = dict(two, data=1)
    saved = state()
    Checkpointer(tmp_path / "a", mesh=two).save(1, saved)
    with pytest.raises(ValueError, match="needs --reshard"):
        Checkpointer(tmp_path / "a", mesh=one).restore(state(1))
    assert Checkpointer(tmp_path / "a", mesh=two).restore(state(1))
    got, step, info = restore_resharded(
        Checkpointer(tmp_path / "a", mesh=one), state(1), mesh=one)
    assert (step, info["mode"]) == (1, "chunked")
    for (k, a), b in zip(state_payload(saved)["params"].items(),
                         state_payload(got)["params"].values()):
        assert torch.equal(a, b), k
    Checkpointer(tmp_path / "b").save(1, state())
    assert Checkpointer(tmp_path / "b", mesh=one).restore(state())
    path = tmp_path / "a" / "manifest-1.json"
    manifest = json.loads(path.read_text())
    manifest["topology"] = {"mesh": one, "zero": "fsdp"}
    path.write_text(json.dumps(manifest))
    assert Checkpointer(tmp_path / "a", mesh=one).restore(state())
