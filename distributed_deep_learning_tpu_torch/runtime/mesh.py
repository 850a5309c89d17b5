"""Device meshes over the launched ranks: the port of
``distributed_deep_learning_tpu/runtime/mesh.py``.

The JAX package lays its devices out as a named ``jax.sharding.Mesh``
over the canonical axes ``(data, fsdp, stage, model, seq, expert)``; here
the same shape is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group (one rank a card), made by
``init_device_mesh`` with the same axis names.  Axes of size 1 stay in
the mesh, as in the JAX package, so no rule special-cases a missing axis.
Rank order is the plain row-major reshape (the JAX package's TPU torus
placement has no Hopper meaning).

:class:`MeshLayout` reads what the runner needs from a mesh: this rank's
coordinate, and the process groups of the batch axes ``(data, fsdp)``
(the rows a rank trains on come from its coordinate there), of
``model``, of ``expert`` and of ``seq``, and the two groups the explicit
FSDP collectives (``--comm``) split the batch axes into: the comm axis
(``fsdp`` when it has ranks, else ``data``, as JAX's runner picks it) and
the other batch axes (JAX's ``other_axes``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.utils.config import MESH_AXES

AXES = MESH_AXES
#: the axes a global batch is split over (the JAX loader's ``BATCH_AXES``)
BATCH_AXES = ("data", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape over the canonical axes.

    Unspecified axes get size 1.  At most one axis may be -1 ("fill with
    all remaining devices")."""

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1

    @staticmethod
    def from_dict(shape: dict[str, int]) -> "MeshSpec":
        unknown = set(shape) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: "
                             f"{AXES}")
        kw = {a: 1 for a in AXES}
        kw.update(shape)
        return MeshSpec(**kw)

    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Replace a single -1 with whatever devices remain."""
        sizes = list(self.sizes())
        fills = [i for i, s in enumerate(sizes) if s == -1]
        if len(fills) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = int(np.prod([s for s in sizes if s != -1]))
        if fills:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {fixed}")
            sizes[fills[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {dict(zip(AXES, sizes))} wants {fixed} "
                             f"devices, have {n_devices}")
        return MeshSpec(**dict(zip(AXES, sizes)))


def build_mesh(spec: MeshSpec | dict[str, int] | None = None,
               device_type: str = "cuda", world: int | None = None):
    """A ``DeviceMesh`` of ``spec``'s shape over the default group's
    ``world`` ranks (default: all of them), axes named :data:`AXES`."""
    from torch.distributed.device_mesh import init_device_mesh

    if world is None:
        world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec()
    if isinstance(spec, dict):
        spec = MeshSpec.from_dict(spec)
    spec = spec.resolve(world)
    return init_device_mesh(device_type, spec.sizes(), mesh_dim_names=AXES)


def mesh_for_mode(mode: "str | None", n_stages: int | None = None,
                  world: int = 1,
                  explicit: dict[str, int] | None = None) -> MeshSpec:
    """The mesh shape of a reference execution mode over ``world`` ranks
    (the JAX package's per-mode shapes), or ``explicit``."""
    if explicit:
        return MeshSpec.from_dict(explicit).resolve(world)
    mode = str(mode) if mode is not None else "sequential"
    if mode in ("model", "pipeline"):
        stages = n_stages or world
        if world % stages:
            raise ValueError(f"{world} devices not divisible into {stages} "
                             "stages")
        return MeshSpec.from_dict({"stage": stages,
                                   "data": world // stages})
    if mode == "data":
        return MeshSpec.from_dict({"data": world})
    return MeshSpec.from_dict({"data": 1})


def local_batch_size(global_batch: int, sizes: dict[str, int]) -> int:
    """Rows of a global batch one rank holds (``sizes``: axis -> size):
    the JAX package's helper (the loader's ``local_rows`` makes the same
    check with the accumulation factor)."""
    n = sizes.get("data", 1) * sizes.get("fsdp", 1)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n


def _rows(ranks: np.ndarray, axes: Sequence[str]) -> list:
    """The ranks of every group over ``axes`` of the rank grid."""
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    n = int(np.prod([ranks.shape[i] for i in keep]))
    return ranks.transpose(rest + keep).reshape(-1, n).tolist()


def _subgroups(ranks: np.ndarray, axes: Sequence[str]):
    """This rank's group over ``axes`` of the rank grid ``ranks`` (every
    rank makes every group, in one order), or None when it has one rank."""
    rows = _rows(ranks, axes)
    if len(rows[0]) == 1:
        return None
    mine = dist.get_rank()
    found = None
    for row in rows:
        group = dist.new_group(row)
        if mine in row:
            found = group
    return found


@dataclasses.dataclass
class MeshLayout:
    """A rank's place in a mesh: ``sizes`` (axis -> size), ``coord``
    (axis -> index), ``batch_rank``/``batch_world`` (its index among and
    the number of the ranks its global batch is split over: the batch
    axes, data-major), and the process groups of the batch axes, of
    ``model``, of ``expert``, of ``seq``, of the comm axis
    (:meth:`comm_axis`) and of the other batch axes (None where the axes
    have one rank).  ``mesh`` is the ``DeviceMesh`` (None for
    :meth:`plain`)."""

    sizes: dict
    coord: dict
    mesh: object = None
    batch_group: object = None
    model_group: object = None
    expert_group: object = None
    batch_rows: list | None = None      # every batch group's ranks
    seq_group: object = None
    comm_group: object = None
    other_group: object = None

    @property
    def comm_axis(self) -> str:
        """The axis the explicit FSDP collectives run over: ``fsdp`` when
        it has ranks, else ``data`` (JAX ``workloads/base.py:456``)."""
        return "fsdp" if self.sizes["fsdp"] > 1 else "data"

    @property
    def batch_world(self) -> int:
        return self.sizes["data"] * self.sizes["fsdp"]

    @property
    def batch_rank(self) -> int:
        return self.coord["data"] * self.sizes["fsdp"] + self.coord["fsdp"]

    @classmethod
    def plain(cls, rank: int = 0, world: int = 1) -> "MeshLayout":
        """``-m data``'s ``{"data": world}`` without a ``DeviceMesh``: the
        default group is the batch group (groups None)."""
        sizes, coord = {a: 1 for a in AXES}, {a: 0 for a in AXES}
        sizes["data"], coord["data"] = world, rank
        return cls(sizes=sizes, coord=coord)

    @classmethod
    def of(cls, mesh) -> "MeshLayout":
        """The layout of this rank in ``mesh`` (made by :func:`build_mesh`),
        with its groups."""
        ranks = mesh.mesh.cpu().numpy()
        sizes = dict(zip(AXES, ranks.shape))
        coord = dict(zip(AXES, (int(i) for i in
                                np.argwhere(ranks == dist.get_rank())[0])))
        comm = "fsdp" if sizes["fsdp"] > 1 else "data"
        other = tuple(a for a in BATCH_AXES if a != comm)
        return cls(sizes=sizes, coord=coord, mesh=mesh,
                   batch_group=_subgroups(ranks, BATCH_AXES),
                   model_group=_subgroups(ranks, ("model",)),
                   expert_group=_subgroups(ranks, ("expert",)),
                   batch_rows=_rows(ranks, BATCH_AXES),
                   seq_group=_subgroups(ranks, ("seq",)),
                   comm_group=_subgroups(ranks, (comm,)),
                   other_group=_subgroups(ranks, other))


@dataclasses.dataclass
class PipelineGrid:
    """A rank's place in ``-m pipeline``'s ``{"data": dp, "stage": S}``
    grid of ``dp·S`` ranks: rank ``r`` is ``(data r // S, stage r % S)``,
    the row-major order of JAX's ``build_mesh({"data": dp, "stage": S})``.
    ``stage_group`` holds this data coordinate's stages, in stage order
    (the pipeline's neighbours, and the sums JAX takes over ``stage``);
    ``data_group`` this stage's data coordinates (the trunk gradients'
    all-reduce).  Either is None where its axis has one rank."""

    dp: int
    stages: int
    data: int
    stage: int
    stage_group: object = None
    data_group: object = None

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def rank_of(self, data: int, stage: int) -> int:
        return data * self.stages + stage

    @classmethod
    def build(cls, dp: int, stages: int) -> "PipelineGrid":
        """This rank's grid over the default group's ``dp·stages`` ranks
        (every rank makes every group, in one order)."""
        world, me = dist.get_world_size(), dist.get_rank()
        if world != dp * stages:
            raise ValueError(f"a {dp} x {stages} data x stage grid needs "
                             f"{dp * stages} ranks, the group has {world}")
        ranks = np.arange(world).reshape(dp, stages)
        stage_group = data_group = None
        if stages > 1:
            for row in ranks.tolist():
                g = dist.new_group(row)
                if me in row:
                    stage_group = g
        if dp > 1:
            for col in ranks.T.tolist():
                g = dist.new_group(col)
                if me in col:
                    data_group = g
        return cls(dp=dp, stages=stages, data=me // stages,
                   stage=me % stages, stage_group=stage_group,
                   data_group=data_group)
