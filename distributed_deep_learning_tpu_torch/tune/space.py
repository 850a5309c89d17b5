"""The plan lattice: every legal execution-plan point for a device count.
The port of ``distributed_deep_learning_tpu/tune/space.py``, its legality
rules word for word; a device is a rank of ``-m data`` here.

A :class:`Plan` is one point in the knob space the CLI exposes by hand
(``--mesh --grad-accum --remat/--remat-policy --zero --grad-compress
--attention --dtype``).  Enumeration produces only *legal* points: mesh
shapes go through the same :meth:`~..runtime.mesh.MeshSpec.resolve` the
trainer uses, and the flag-composition constraints mirror the rejections in
:mod:`..workloads.base` (grad-compress needs pure DP, accumulation has no
remat wiring, a remat policy needs remat, the batch must divide over the
data axes x microbatches).  A plan applies to a run as plain ``Config``
field overrides — every existing code path (train loop, elastic,
checkpointing, sentinel) works unchanged under a tuned plan.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from distributed_deep_learning_tpu_torch.utils.config import (
    MESH_AXES, REMAT_POLICIES, Config, Mode)


def _normalize_mesh(shape: dict[str, int]) -> tuple[tuple[str, int], ...]:
    """Canonical mesh representation: (axis, size) pairs in MESH_AXES order,
    size-1 axes dropped; a fully trivial mesh keeps ``data=1`` so the shape
    survives a round-trip through ``Config.mesh_shape`` (an empty dict would
    read as "no explicit mesh")."""
    out = tuple((a, int(shape[a])) for a in MESH_AXES
                if int(shape.get(a, 1)) != 1)
    return out if out else (("data", 1),)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One immutable execution plan (a point in the search lattice)."""

    mesh: tuple[tuple[str, int], ...] = (("data", 1),)
    grad_accum: int = 1
    remat: bool = False
    remat_policy: str = "nothing"
    zero: str = "none"
    grad_compress: str = "none"
    comm: str = "none"
    comm_overlap: bool = False
    attention: str = "auto"
    dtype: str = "float32"
    # serving-surface axes: engine generation + quantized
    # storage dtypes.  "none" = full precision, so the training-only
    # lattice corner is the all-default Plan and old anchors hold.
    paged: bool = False
    kv_dtype: str = "none"
    weight_dtype: str = "none"

    def mesh_dict(self) -> dict[str, int]:
        return dict(self.mesh)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.mesh:
            n *= s
        return n

    @property
    def dp(self) -> int:
        """Batch-parallel degree (the loader shards over data x fsdp)."""
        d = self.mesh_dict()
        return d.get("data", 1) * d.get("fsdp", 1)

    def to_overrides(self) -> dict:
        """The ``Config`` field overrides that realise this plan.

        ``mode`` pins to DATA: the lattice lives in the SPMD sharded-step
        world (sequential is just the 1-device corner of it)."""
        return {
            "mode": Mode.DATA,
            "mesh_shape": self.mesh_dict(),
            "grad_accum": self.grad_accum,
            "remat": self.remat,
            "remat_policy": self.remat_policy,
            "zero": self.zero,
            "grad_compress": self.grad_compress,
            "comm": self.comm,
            "comm_overlap": self.comm_overlap,
            "attention": self.attention,
            "dtype": self.dtype,
            "paged": self.paged,
            # Config stores the serving dtypes as Optional[str]
            "kv_dtype": None if self.kv_dtype == "none" else self.kv_dtype,
            "weight_dtype": None if self.weight_dtype == "none"
            else self.weight_dtype,
        }

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh"] = self.mesh_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "Plan":
        d = dict(d)
        d["mesh"] = _normalize_mesh(d["mesh"])
        return Plan(**d)

    def describe(self) -> str:
        mesh = ",".join(f"{a}={s}" for a, s in self.mesh)
        bits = [f"mesh[{mesh}]"]
        if self.grad_accum > 1:
            bits.append(f"accum={self.grad_accum}")
        if self.remat:
            bits.append(f"remat={self.remat_policy}")
        if self.zero != "none":
            bits.append(f"zero={self.zero}")
        if self.grad_compress != "none":
            bits.append(f"compress={self.grad_compress}")
        if self.comm != "none":
            ring = "+ring" if self.comm_overlap else ""
            bits.append(f"comm={self.comm}{ring}")
        if self.attention != "auto":
            bits.append(f"attention={self.attention}")
        bits.append(self.dtype)
        if self.paged:
            bits.append("paged")
        if self.kv_dtype != "none":
            bits.append(f"kv={self.kv_dtype}")
        if self.weight_dtype != "none":
            bits.append(f"w={self.weight_dtype}")
        return " ".join(bits)


def apply_plan(config: Config, plan: Plan) -> Config:
    """Realise `plan` on `config` (pure field overrides)."""
    return config.replace(**plan.to_overrides())


def plan_from_config(config: Config, n_devices: int) -> Plan:
    """The plan the hand-set config corresponds to — the search baseline.

    Sequential mode maps to the 1-device mesh corner; data mode without an
    explicit ``--mesh`` maps to ``data=N`` exactly as
    :func:`..workloads.base._run_workload` would build it."""
    if config.mesh_shape:
        from distributed_deep_learning_tpu_torch.runtime.mesh import MeshSpec

        spec = MeshSpec.from_dict(config.mesh_shape).resolve(n_devices)
        mesh = _normalize_mesh(dict(zip(MESH_AXES, spec.sizes())))
    elif config.mode is Mode.DATA:
        n = config.world_size if config.world_size > 1 else n_devices
        mesh = _normalize_mesh({"data": n})
    else:
        mesh = _normalize_mesh({"data": 1})
    return Plan(mesh=mesh, grad_accum=config.grad_accum, remat=config.remat,
                remat_policy=config.remat_policy, zero=config.zero,
                grad_compress=config.grad_compress, comm=config.comm,
                comm_overlap=config.comm_overlap,
                attention=config.attention, dtype=config.dtype,
                paged=config.paged,
                kv_dtype=config.kv_dtype or "none",
                weight_dtype=config.weight_dtype or "none")


def _mesh_candidates(n_devices: int) -> list[tuple[tuple[str, int], ...]]:
    """All (data, fsdp) factorizations of the device count, each validated
    by the trainer's own ``MeshSpec.resolve`` so an illegal shape can never
    enter the lattice."""
    from distributed_deep_learning_tpu_torch.runtime.mesh import MeshSpec

    out = []
    for data in range(1, n_devices + 1):
        if n_devices % data:
            continue
        shape = {"data": data, "fsdp": n_devices // data}
        try:
            spec = MeshSpec.from_dict(shape).resolve(n_devices)
        except ValueError:  # pragma: no cover - factorizations always fit
            continue
        out.append(_normalize_mesh(dict(zip(MESH_AXES, spec.sizes()))))
    return out


def _remat_options() -> list[tuple[bool, str]]:
    """(remat, policy) combos: no remat, plus remat under each policy.
    A policy without remat is illegal (config.py rejects it at the CLI)."""
    return [(False, "nothing")] + [(True, p) for p in sorted(REMAT_POLICIES)]


def enumerate_plans(n_devices: int, batch_size: int, *,
                    dtypes: Sequence[str] = ("float32",),
                    grad_accum_options: Sequence[int] = (1, 2),
                    attention_options: Sequence[str] = ("auto",),
                    zero_options: Sequence[str] = ("none", "1", "fsdp"),
                    compress_options: Sequence[str] = ("none", "bf16",
                                                       "int8"),
                    comm_options: Sequence[str] = ("none", "bf16", "int8"),
                    comm_overlap_options: Sequence[bool] = (False, True),
                    paged_options: Sequence[bool] = (False,),
                    kv_dtype_options: Sequence[str] = ("none",),
                    weight_dtype_options: Sequence[str] = ("none",),
                    ) -> list[Plan]:
    """Enumerate the legal plan lattice, in deterministic order.

    Legality mirrors :mod:`..workloads.base`:

    * batch must divide over dp x grad_accum (loader + accumulation reshape)
    * ``--remat`` with ``--grad-accum`` is rejected (no remat wiring in the
      accumulation scan)
    * ``--grad-compress`` needs pure DP: no ZeRO, no accumulation (it DOES
      compose with remat), and a >1 batch-parallel degree to have any wire
      traffic to compress
    * ZeRO needs a >1 shard axis (fsdp when present, else data) — sharding
      over a size-1 axis is a no-op plan already covered by ``none``
    * ``--comm`` (explicit quantized FSDP collectives) needs ``zero=fsdp``
      with no accumulation; ``--comm-overlap`` needs ``--comm``
    * serving axes (singleton defaults — the training search is
      unchanged unless a serving sweep opts in): ``kv_dtype="int8"``
      needs ``paged=True`` (per-position scales live in the block
      pools; the v1 slot table supports bf16 only), mirroring the
      ``--kv-dtype int8 requires --paged`` CLI rejection
    """
    plans: list[Plan] = []
    for mesh in _mesh_candidates(n_devices):
        md = dict(mesh)
        dp = md.get("data", 1) * md.get("fsdp", 1)
        shard_axis_size = md.get("fsdp", 1) if md.get("fsdp", 1) > 1 \
            else md.get("data", 1)
        if batch_size % dp:
            continue
        for accum in grad_accum_options:
            if accum < 1 or batch_size % (dp * accum):
                continue
            for zero in zero_options:
                if zero != "none" and shard_axis_size <= 1:
                    continue
                for remat, policy in _remat_options():
                    if accum > 1 and remat:
                        continue
                    for compress in compress_options:
                        if compress != "none" and (
                                zero != "none" or accum > 1 or dp <= 1):
                            continue
                        for comm in comm_options:
                            if comm != "none" and (
                                    zero != "fsdp" or accum > 1
                                    or compress != "none"):
                                continue
                            for ring in comm_overlap_options:
                                if ring and comm == "none":
                                    continue
                                for attention in attention_options:
                                    for dtype in dtypes:
                                        for pg in paged_options:
                                            for kv_dt in kv_dtype_options:
                                                if kv_dt == "int8" and not pg:
                                                    continue
                                                for w_dt in \
                                                        weight_dtype_options:
                                                    plans.append(Plan(
                                                        mesh=mesh,
                                                        grad_accum=accum,
                                                        remat=remat,
                                                        remat_policy=policy,
                                                        zero=zero,
                                                        grad_compress=compress,
                                                        comm=comm,
                                                        comm_overlap=ring,
                                                        attention=attention,
                                                        dtype=dtype,
                                                        paged=pg,
                                                        kv_dtype=kv_dt,
                                                        weight_dtype=w_dt))
    return plans
