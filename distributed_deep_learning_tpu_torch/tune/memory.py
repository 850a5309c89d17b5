"""Analytic device-memory model: reject plans that cannot fit BEFORE any
trial.  The port of ``distributed_deep_learning_tpu/tune/memory.py``.

Per-device footprint of one train step under a plan, from first principles:

* params — fp32 master copy, divided by the fsdp shard under ``--zero fsdp``
* gradients — same dtype/shape as params, sharded with them under fsdp
* optimizer — ``opt_slots`` fp32 moments per param (Adam 2, momentum 1,
  adafactor ~sublinear ≈ 1); ZeRO-1 shards them over the shard axis, fsdp
  shards them with the params
* activations — one *microbatch*'s worth (batch / (dp x grad_accum)) of
  per-layer activations, scaled by the fraction each remat policy keeps
  live for the backward

The fractions are a ranking model, not a byte-exact one — their job is a
correct ORDER (no remat > dots > dots_no_batch > full recompute), which the
monotonicity tests pin and each measured trial cross-checks against the
caching allocator's ledger (``utils.profiling.memory_analysis``, see
:mod:`.trial`).  The tables are the JAX package's analytic priors, kept
so that pruning and the search order are its; a card's own constants come
from :mod:`.calibrate`.  The budget is the card's memory
(``torch.cuda.mem_get_info``) and ``None`` on the CPU, in which case
pruning only happens under an explicit override.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

import torch

from distributed_deep_learning_tpu_torch.tune.space import Plan

#: fraction of a layer's forward activations the backward keeps live under
#: each (remat, policy) combo.  No remat keeps everything; 'dots' keeps
#: matmul outputs; 'dots_no_batch' keeps only batch-free matmuls (weights'
#: contractions); policy 'nothing' under remat recomputes all but the layer
#: boundaries.
ACT_FRACTION: dict[tuple[bool, str], float] = {
    (False, "nothing"): 1.00,
    (True, "dots"): 0.60,
    (True, "dots_no_batch"): 0.45,
    (True, "nothing"): 0.15,
}

#: fp32 moment slots per parameter for each optimizer family; the analytic
#: model only needs the right order of magnitude
OPT_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2, "lamb": 2,
             "adafactor": 1, "auto": 2}


@dataclasses.dataclass(frozen=True)
class ModelGeometry:
    """What the memory model needs to know about a workload's model."""

    param_count: int                     # trainable parameter count
    num_layers: int                      # repeated-block depth
    layer_act_elems_per_example: int     # activation elems / layer / example
    extra_act_elems_per_example: int = 0  # embeddings / head / input staging
    opt_slots: int = 2                   # fp32 moments per param


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """Per-device byte estimate for one train step under a plan."""

    params_bytes: int
    gradients_bytes: int
    optimizer_bytes: int
    activations_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.params_bytes + self.gradients_bytes
                + self.optimizer_bytes + self.activations_bytes)

    def to_dict(self) -> dict[str, int]:
        return {**dataclasses.asdict(self), "total_bytes": self.total_bytes}


def _shard_axis_size(plan: Plan) -> int:
    """The axis ZeRO shards over — fsdp when the mesh has one, else data
    (the same rule :mod:`..workloads.base` uses to pick the spec axis)."""
    md = plan.mesh_dict()
    fsdp = md.get("fsdp", 1)
    return fsdp if fsdp > 1 else md.get("data", 1)


def resolve_act_fraction(plan: Plan,
                         act_fraction: Mapping[tuple[bool, str], float]
                         | None = None) -> float:
    """The activation fraction for a plan's remat corner: the measured
    (calibrated) value when one is supplied, the static analytic table
    otherwise.  A calibration that lacks this corner falls back
    per-corner — partial calibrations never lose the analytic model."""
    key = (plan.remat, plan.remat_policy)
    if act_fraction is not None and key in act_fraction:
        return float(act_fraction[key])
    return ACT_FRACTION[key]


def estimate_memory(plan: Plan, geom: ModelGeometry, batch_size: int,
                    *, act_fraction: Mapping[tuple[bool, str], float]
                    | None = None) -> MemoryEstimate:
    """Analytic per-device HBM footprint of one train step.

    ``act_fraction`` optionally replaces the static :data:`ACT_FRACTION`
    table with measured per-corner constants (a
    :class:`~.calibrate.MemoryCalibration`'s ``act_fraction`` map);
    corners it doesn't cover keep the analytic value."""
    dtype_bytes = 2 if plan.dtype == "bfloat16" else 4
    shard = max(1, _shard_axis_size(plan))
    params = geom.param_count * 4          # fp32 master copy
    grads = geom.param_count * 4
    opt = geom.opt_slots * geom.param_count * 4
    if plan.zero == "1":
        opt = -(-opt // shard)             # moments sharded, params whole
    elif plan.zero == "fsdp":
        params = -(-params // shard)
        grads = -(-grads // shard)
        opt = -(-opt // shard)
    micro = max(1, batch_size // (plan.dp * plan.grad_accum))
    frac = resolve_act_fraction(plan, act_fraction)
    act = int(micro * (geom.num_layers * geom.layer_act_elems_per_example
                       * frac + geom.extra_act_elems_per_example)
              * dtype_bytes)
    return MemoryEstimate(params_bytes=params, gradients_bytes=grads,
                          optimizer_bytes=opt, activations_bytes=act)


def hbm_budget(devices: Sequence[Any] | None = None,
               override: int | None = None) -> int | None:
    """Per-device memory budget in bytes, or None when unknown.

    On a card: its total memory as ``torch.cuda.mem_get_info`` reports it
    (the counterpart of the TPU runtime's ``bytes_limit``, the memory the
    device offers one program; free memory would shrink with whatever
    this process already caches, such as the run's own dataset, and
    would rank plans differently from one call to the next).  The CPU
    reports nothing, so CPU searches only prune under an explicit
    ``override`` (tests inject tiny/huge budgets this way)."""
    if override is not None:
        return override
    if not devices:
        return None
    device = torch.device(devices[0])
    if device.type != "cuda":
        return None
    try:
        _, total = torch.cuda.mem_get_info(device)
    except Exception:
        return None
    return int(total) or None


def prune_plans(plans: Iterable[Plan], geom: ModelGeometry, batch_size: int,
                budget_bytes: int | None, *, safety: float = 0.9,
                act_fraction: Mapping[tuple[bool, str], float] | None = None,
                ) -> tuple[list[Plan], list[tuple[Plan, MemoryEstimate]]]:
    """Split plans into (feasible, rejected-with-estimates).

    ``safety`` reserves headroom for XLA temporaries the analytic model
    cannot see (fusion scratch, collective buffers).  With no budget the
    model cannot reject anything — every plan is feasible and the measured
    trials' OOM containment is the backstop.  ``act_fraction`` threads a
    calibration's measured constants into every estimate."""
    feasible: list[Plan] = []
    rejected: list[tuple[Plan, MemoryEstimate]] = []
    for plan in plans:
        est = estimate_memory(plan, geom, batch_size,
                              act_fraction=act_fraction)
        if budget_bytes is not None and est.total_bytes > safety * budget_bytes:
            rejected.append((plan, est))
        else:
            feasible.append(plan)
    return feasible, rejected
