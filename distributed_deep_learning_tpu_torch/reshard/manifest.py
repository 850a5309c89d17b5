"""Topology manifest: how a checkpoint's state was laid out across ranks.
The port of ``distributed_deep_learning_tpu/reshard/manifest.py``.

The integrity sidecar (:mod:`..utils.checkpoint`) already records *what*
was saved — per-leaf CRC32, shape, dtype, finiteness.  This module
records *how* the live state was split when it was saved: the mesh axis
names and sizes, the rank count, and each leaf's spec, as a plain-JSON
block (``format``, ``mesh``, ``n_devices``, ``leaf_specs``) embedded in
the same sidecar.  A restore on another layout reads it to decide
whether the checkpoint can be taken as-is (same topology), must be
resharded (different topology), or predates topology manifests entirely
(legacy — assume same topology, never quarantine).

A spec is JAX's ``PartitionSpec`` as a JSON list: one entry a dimension,
the mesh axis (or axes) that dimension is split over, or null; trailing
nulls are stripped, so ``[]`` is replicated.  The port's layouts give:

* ``--zero fsdp`` (FSDP2): ``Shard(0)`` over ZeRO's axis — ``["fsdp"]``,
  or ``["data"]`` without an fsdp axis (HSDP replicates over data);
* tensor parallelism: the split dim's entry is its axis;
* ``--comm`` (:class:`..parallel.collectives.ExplicitFSDP`): the split
  dim of the leaf's flax layout, over the comm axis;
* ``--zero 1`` (``ZeroRedundancyOptimizer``): each parameter's optimizer
  state lies whole on one rank of the axis, written ``["@data"]`` (an
  ``@`` entry names the axis whose ranks own whole leaves).

``leaf_specs`` is keyed as the integrity manifest keys its leaves:
``/params/<name>`` for a parameter; a parameter's optimizer moments share
one entry under ``/optimizer/state/<i>``, the prefix of their manifest
keys (torch makes them at the first update, so a target state has none
yet).  Everything here is metadata: nothing reads tensor bytes.
"""

from __future__ import annotations

import dataclasses
import math

TOPOLOGY_FORMAT = 1


def _canonical_entries(spec) -> tuple:
    """A spec's entries in canonical form: tuples for multi-axis entries,
    trailing ``None`` padding stripped."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_to_json(spec) -> list:
    """Spec -> JSON-safe entry list (axis name, axis-name list, or null
    for an unsplit dimension)."""
    return [list(e) if isinstance(e, tuple) else e
            for e in _canonical_entries(spec)]


def spec_from_json(entries) -> tuple:
    """Inverse of :func:`spec_to_json` (the canonical tuple)."""
    return _canonical_entries([tuple(e) if isinstance(e, list) else e
                               for e in (entries or [])])


@dataclasses.dataclass(frozen=True)
class Topology:
    """The placement fingerprint of one saved state.

    ``mesh_shape`` keeps every axis (including size-1 ones) in mesh order
    so the manifest is a faithful record; comparisons normalise size-1
    axes away — a ``data=8`` mesh and a ``data=8, fsdp=1`` mesh place
    bytes identically.  ``leaf_specs`` maps the integrity manifest's keys
    to canonical spec entry tuples.
    """

    mesh_shape: tuple[tuple[str, int], ...]
    n_devices: int
    leaf_specs: dict[str, tuple]

    def mesh_dict(self) -> dict[str, int]:
        return dict(self.mesh_shape)

    def normalized_mesh(self) -> tuple[tuple[str, int], ...]:
        out = tuple((a, s) for a, s in self.mesh_shape if s != 1)
        return out if out else (("data", 1),)

    def describe(self) -> str:
        mesh = ",".join(f"{a}={s}" for a, s in self.normalized_mesh())
        return f"mesh[{mesh}]x{self.n_devices}dev"

    def to_json(self) -> dict:
        return {
            "format": TOPOLOGY_FORMAT,
            "mesh": {a: s for a, s in self.mesh_shape},
            "n_devices": self.n_devices,
            "leaf_specs": {k: spec_to_json(v)
                           for k, v in self.leaf_specs.items()},
        }

    @staticmethod
    def from_json(payload) -> "Topology | None":
        """Parse a manifest's ``topology`` block; ``None`` for anything
        missing or malformed (the caller treats that as legacy), such as
        the port's earlier ``{"mesh": ..., "zero": ...}`` block, which has
        no ``n_devices``."""
        try:
            mesh = tuple((str(a), int(s))
                         for a, s in payload["mesh"].items())
            specs = {str(k): spec_from_json(v)
                     for k, v in payload.get("leaf_specs", {}).items()}
            return Topology(mesh_shape=mesh,
                            n_devices=int(payload["n_devices"]),
                            leaf_specs=specs)
        except (TypeError, KeyError, ValueError, AttributeError):
            return None


def same_topology(a: Topology | None, b: Topology | None) -> bool:
    """True when two topologies place bytes identically: same rank
    count, same non-trivial mesh axes, same per-leaf specs."""
    if a is None or b is None:
        return False
    return (a.n_devices == b.n_devices
            and a.normalized_mesh() == b.normalized_mesh()
            and a.leaf_specs == b.leaf_specs)


def _param_spec(p, explicit=None, name: str = "",
                comm_axis: str = "data") -> tuple:
    """One parameter's spec in the live state (``comm_axis``: the axis
    ``--comm``'s shards lie on)."""
    from distributed_deep_learning_tpu_torch.parallel.shards import \
        is_dtensor

    if explicit is not None:                     # --comm's flax shards
        d = explicit.dims[name]
        if d < 0:
            return ()
        return _canonical_entries([None] * d + [comm_axis])
    if is_dtensor(p):
        names = p.device_mesh.mesh_dim_names
        spec: list = [None] * p.dim()
        for i, pl in enumerate(p.placements):
            if pl.is_shard():
                d = pl.dim
                spec[d] = names[i] if spec[d] is None else \
                    tuple(spec[d] if isinstance(spec[d], tuple)
                          else (spec[d],)) + (names[i],)
        return _canonical_entries(spec)
    shard = getattr(p, "tp_shard", None)
    if shard is not None:
        return _canonical_entries([None] * shard.dim + [shard.axis])
    return ()


def capture(state, sizes: dict[str, int] | None = None) -> Topology:
    """Fingerprint a live :class:`..train.state.TrainState` laid out over
    a mesh of ``sizes`` (axis -> size; ``None``: one rank).  Every rank
    computes the same fingerprint; nothing is gathered."""
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        ExplicitFSDP
    from distributed_deep_learning_tpu_torch.parallel.shards import resharded
    from distributed_deep_learning_tpu_torch.parallel.zero import zero_axis
    from distributed_deep_learning_tpu_torch.runtime.mesh import AXES

    sizes = dict(sizes or {"data": 1})
    mesh_shape = tuple((a, int(sizes.get(a, 1))) for a in AXES)
    explicit = state.comm if isinstance(state.comm, ExplicitFSDP) else None
    params = dict(resharded(state.model).named_parameters())
    leaf_specs: dict[str, tuple] = {}
    for name in state.model.state_dict():
        p = params.get(name)
        leaf_specs[f"/params/{name}"] = () if p is None else \
            _param_spec(p, explicit, name, zero_axis(sizes))
    owner = None
    if hasattr(state.optimizer, "consolidate_state_dict"):   # ZeRO-1
        owner = ("@" + zero_axis(sizes),)
    for i, name in enumerate(params):
        leaf_specs[f"/optimizer/state/{i}"] = owner or \
            leaf_specs[f"/params/{name}"]
    return Topology(mesh_shape=mesh_shape,
                    n_devices=max(1, math.prod(s for _, s in mesh_shape)),
                    leaf_specs=leaf_specs)


def of_placement(state, sizes: dict[str, int] | None = None) -> Topology:
    """Fingerprint a *target* placement: the state a restore fills (the
    same rule as :func:`capture`, which needs no saved values)."""
    return capture(state, sizes)

