"""Auto-parallelism planner: search the (mesh x microbatch x remat x ZeRO
x compress x attention x dtype) plan lattice for a workload + topology.
The port of ``distributed_deep_learning_tpu/tune/``; a device is a rank
of ``-m data``, and every rank runs a search in lockstep.

The source paper compares execution modes by hand; this package automates
the choice.  Four layers:

* :mod:`.space` — the immutable :class:`~.space.Plan` point and enumeration
  of the legal lattice for a device count (legality mirrors the trainer's
  own flag-composition rules, and mesh shapes are validated by the same
  ``MeshSpec.resolve`` the trainer uses).
* :mod:`.memory` — analytic device-memory model (params + optimizer
  moments + activations under each remat policy, ZeRO sharding factors)
  that prunes infeasible plans before any trial; cross-checked per trial
  against the caching allocator's ledger.
* :mod:`.trial` — OOM-safe measured trials: build the real step, time N
  steps with ``StepTimer`` (sync-honest), ``torch.cuda.OutOfMemoryError``
  → infeasible record instead of a dead search.
* :mod:`.search` + :mod:`.artifact` — successive halving over survivors,
  and the versioned JSON plan artifact keyed by a hash of (workload,
  geometry, topology) that ``--plan`` replays.
* :mod:`.calibrate` — measured calibration of the analytic model's
  constants: run the real step at the remat/ZeRO lattice corners, fit
  ``ACT_FRACTION``/``RECOMPUTE_COST`` from the allocator's measured bytes
  and step rates into a versioned artifact the search consumes.
"""

from distributed_deep_learning_tpu_torch.tune.artifact import (
    PLAN_SCHEMA_VERSION, StalePlanError, load_plan, plan_hash, plan_key,
    save_plan)
from distributed_deep_learning_tpu_torch.tune.calibrate import (
    CALIBRATION_SCHEMA_VERSION, MemoryCalibration, StaleCalibrationError,
    calibration_key, load_calibration, maybe_load_calibration,
    run_calibration, save_calibration)
from distributed_deep_learning_tpu_torch.tune.memory import (
    MemoryEstimate, ModelGeometry, estimate_memory, hbm_budget, prune_plans)
from distributed_deep_learning_tpu_torch.tune.search import (SearchResult,
                                                             run_search)
from distributed_deep_learning_tpu_torch.tune.space import (
    Plan, apply_plan, enumerate_plans, plan_from_config)
from distributed_deep_learning_tpu_torch.tune.trial import (TrialHarness,
                                                            TrialResult)

__all__ = [
    "PLAN_SCHEMA_VERSION", "StalePlanError", "load_plan", "plan_hash",
    "plan_key", "save_plan", "CALIBRATION_SCHEMA_VERSION",
    "MemoryCalibration", "StaleCalibrationError", "calibration_key",
    "load_calibration", "maybe_load_calibration", "run_calibration",
    "save_calibration", "MemoryEstimate", "ModelGeometry",
    "estimate_memory", "hbm_budget", "prune_plans", "SearchResult",
    "run_search", "Plan", "apply_plan", "enumerate_plans",
    "plan_from_config", "TrialHarness", "TrialResult",
]
