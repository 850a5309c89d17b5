"""Measured calibration of the analytic device-memory model.  The port of
``distributed_deep_learning_tpu/tune/calibrate.py``.

The planner's :data:`~.memory.ACT_FRACTION` / :data:`~.search.RECOMPUTE_COST`
tables are hand-guessed ranking constants.  This harness replaces the
guesses with MEASURED per-(workload, remat-policy) values: run the
workload's real train step at each corner of the remat/ZeRO lattice
(the same :class:`~.trial.TrialHarness` path ``--autotune`` uses), read
the caching allocator's ``temp_size_in_bytes`` (the step's peak above
what it holds before and after: activations and scratch) and the
measured step rate, and solve the analytic model's equations backwards
(on the CPU torch reports no allocator peak, so the memory fields are
missing and no fraction is fitted):

* ``act = micro x (L x layer_act x FRAC + extra) x dtype_bytes``
  → ``FRAC`` from the measured temp bytes;
* ``RECOMPUTE_COST[corner] = sps(no-remat) / sps(corner)`` from the
  measured step rates.

The fitted constants land in a versioned JSON artifact mirroring the
plan artifact's gating (:class:`StaleCalibrationError` on foreign
version / key / edited constants); :func:`~.memory.estimate_memory`
consumes them through its ``act_fraction`` override and
:func:`~.search.run_search` through its ``calibration`` parameter — the
static tables remain the fallback for uncalibrated corners and
workloads, so calibration only ever sharpens the model.

Predicted-vs-measured error for both the analytic and the calibrated
model rides in the artifact (and bench.py's ``memory_model``
sub-record), which is what makes "the planner's memory predictions are
trustworthy" a measured, regression-guarded claim.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping, Sequence

from distributed_deep_learning_tpu_torch.tune.artifact import _digest
from distributed_deep_learning_tpu_torch.tune.memory import (
    ACT_FRACTION, estimate_memory)
from distributed_deep_learning_tpu_torch.tune.space import Plan
from distributed_deep_learning_tpu_torch.utils.config import Config

#: v1: constants are {act_fraction, recompute_cost} keyed by remat corner
CALIBRATION_SCHEMA_VERSION = 1

#: the remat corners of the lattice, in analytic-memory order
REMAT_CORNERS: tuple[tuple[bool, str], ...] = (
    (False, "nothing"), (True, "dots"), (True, "dots_no_batch"),
    (True, "nothing"))

#: fitted fractions are clamped here — a degenerate measurement (tiny
#: model where `extra` dominates, backend reporting 0 temp bytes) must
#: not produce a negative or absurd constant
_FRAC_BOUNDS = (0.01, 8.0)
_COST_BOUNDS = (0.5, 4.0)


class StaleCalibrationError(ValueError):
    """The calibration artifact's version or key does not match this
    run (mirrors :class:`~.artifact.StalePlanError`)."""


def corner_name(corner: tuple[bool, str]) -> str:
    remat, policy = corner
    return f"{'remat' if remat else 'noremat'}:{policy}"


def parse_corner(name: str) -> tuple[bool, str]:
    prefix, _, policy = name.partition(":")
    return prefix == "remat", policy


def calibration_key(workload: str, config: Config, n_devices: int,
                    platform: str = "", device_kind: str = "") -> str:
    """What a calibration is valid FOR: the same geometry/topology hash
    inputs as :func:`~.artifact.plan_key`, plus the optimizer and dtype
    (both change the measured byte ledger)."""
    return _digest({
        "workload": workload,
        "num_layers": config.num_layers,
        "size": config.size,
        "batch_size": config.batch_size,
        "optimizer": config.optimizer,
        "dtype": config.dtype,
        "n_devices": n_devices,
        "platform": platform,
        "device_kind": device_kind,
    })


@dataclasses.dataclass(frozen=True)
class MemoryCalibration:
    """Fitted constants for one (workload, geometry, topology)."""

    workload: str
    key: str
    act_fraction: dict[tuple[bool, str], float]
    recompute_cost: dict[tuple[bool, str], float]

    def constants(self) -> dict[str, dict[str, float]]:
        return {
            "act_fraction": {corner_name(k): v
                             for k, v in sorted(self.act_fraction.items())},
            "recompute_cost": {corner_name(k): v
                               for k, v in
                               sorted(self.recompute_cost.items())},
        }

    @classmethod
    def from_record(cls, record: dict[str, Any]) -> "MemoryCalibration":
        consts = record.get("constants", {})
        return cls(
            workload=record.get("workload", ""),
            key=record.get("key", ""),
            act_fraction={parse_corner(k): float(v) for k, v in
                          consts.get("act_fraction", {}).items()},
            recompute_cost={parse_corner(k): float(v) for k, v in
                            consts.get("recompute_cost", {}).items()},
        )


def model_error(predicted: float, measured: float) -> float:
    """Relative prediction error, safe at measured == 0."""
    return abs(float(predicted) - float(measured)) / max(float(measured),
                                                         1.0)


def fit_act_fraction(measured_act_bytes: int, geom, batch_size: int,
                     plan: Plan) -> float:
    """Invert the analytic activation formula for FRAC at one corner."""
    dtype_bytes = 2 if plan.dtype == "bfloat16" else 4
    micro = max(1, batch_size // (plan.dp * plan.grad_accum))
    denom = micro * geom.num_layers * geom.layer_act_elems_per_example \
        * dtype_bytes
    extra = micro * geom.extra_act_elems_per_example * dtype_bytes
    frac = (measured_act_bytes - extra) / max(denom, 1)
    return min(max(frac, _FRAC_BOUNDS[0]), _FRAC_BOUNDS[1])


def _corner_plans(n_devices: int, corners: Sequence[tuple[bool, str]],
                  dtype: str, *, zero_corner: bool) -> list[Plan]:
    plans = [Plan(mesh=(("data", n_devices),), remat=r, remat_policy=p,
                  dtype=dtype)
             for r, p in corners]
    if zero_corner and n_devices > 1:
        # one ZeRO corner rides along: fsdp sharding changes the
        # argument/temp split, and the error stats must cover it
        plans.append(Plan(mesh=(("fsdp", n_devices),), zero="fsdp",
                          dtype=dtype))
    return plans


def run_calibration(spec, config: Config, *, devices=None, dataset=None,
                    corners: Sequence[tuple[bool, str]] = REMAT_CORNERS,
                    steps: int = 2, warmup: int = 1,
                    runner: Callable[[Plan, int], Any] | None = None,
                    zero_corner: bool = True,
                    logger=None) -> dict[str, Any]:
    """Measure the lattice corners and fit the constants.

    Returns the full artifact record (pass it to
    :func:`save_calibration`).  ``runner(plan, steps)`` must return a
    :class:`~.trial.TrialResult`-shaped object (``memory`` dict,
    ``steps_per_sec``, ``infeasible``); the default is a real
    :class:`~.trial.TrialHarness` — tests inject fakes to stay
    build-free."""
    from distributed_deep_learning_tpu_torch.tune.search import \
        model_geometry
    from distributed_deep_learning_tpu_torch.tune.trial import (
        TrialHarness, device_identity, launched_devices)

    if devices is None:
        devices = launched_devices(config)
    devices = list(devices)
    n = len(devices)
    if dataset is None:
        dataset = spec.build_dataset(config)
    if runner is None:
        harness = TrialHarness(spec, config, dataset, devices,
                               warmup=warmup)
        runner = harness.run
    geom = model_geometry(spec, config, dataset)

    plans = _corner_plans(n, corners, config.dtype, zero_corner=zero_corner)
    measured: list[dict[str, Any]] = []
    act_fraction: dict[tuple[bool, str], float] = {}
    base_sps: float | None = None
    for plan in plans:
        result = runner(plan, steps)
        corner = (plan.remat, plan.remat_policy)
        entry: dict[str, Any] = {
            "corner": corner_name(corner),
            "plan": plan.to_dict(),
            "infeasible": bool(result.infeasible),
        }
        if result.infeasible:
            entry["error"] = result.error
            measured.append(entry)
            if logger:
                logger.info(f"calibrate: corner {entry['corner']} "
                            f"infeasible ({result.error})")
            continue
        memory = result.memory or {}
        temp = int(memory.get("temp_size_in_bytes", 0))
        entry["temp_size_in_bytes"] = temp
        entry["argument_size_in_bytes"] = int(
            memory.get("argument_size_in_bytes", 0))
        entry["memory_fields_missing"] = list(
            memory.get("memory_fields_missing", ()))
        entry["steps_per_sec"] = float(result.steps_per_sec)
        analytic = estimate_memory(plan, geom, config.batch_size)
        entry["analytic_act_bytes"] = analytic.activations_bytes
        # the fit reads temp alone: the port's ledger always lists the
        # alias bytes as missing (PyTorch donates no buffers), where JAX
        # fits only on a record missing nothing
        if temp > 0 and "temp_size_in_bytes" not in \
                entry["memory_fields_missing"] and plan.zero == "none":
            frac = fit_act_fraction(temp, geom, config.batch_size, plan)
            entry["fitted_act_fraction"] = round(frac, 6)
            act_fraction[corner] = frac
        if plan.zero == "none" and corner == (False, "nothing"):
            base_sps = entry["steps_per_sec"] or None
        measured.append(entry)

    recompute_cost: dict[tuple[bool, str], float] = {}
    if base_sps:
        for entry in measured:
            sps = entry.get("steps_per_sec")
            if not sps or entry["infeasible"]:
                continue
            corner = parse_corner(entry["corner"])
            if Plan.from_dict(entry["plan"]).zero != "none":
                continue
            cost = base_sps / sps
            recompute_cost[corner] = min(max(cost, _COST_BOUNDS[0]),
                                         _COST_BOUNDS[1])
            entry["fitted_recompute_cost"] = round(recompute_cost[corner],
                                                   4)

    # predicted-vs-measured error, both models, over every measured corner
    errors = {"analytic": [], "calibrated": []}
    for entry in measured:
        temp = entry.get("temp_size_in_bytes")
        if entry["infeasible"] or not temp:
            continue
        plan = Plan.from_dict(entry["plan"])
        analytic_pred = estimate_memory(
            plan, geom, config.batch_size).activations_bytes
        calibrated_pred = estimate_memory(
            plan, geom, config.batch_size,
            act_fraction=act_fraction).activations_bytes
        entry["analytic_error"] = round(model_error(analytic_pred, temp), 4)
        entry["calibrated_error"] = round(
            model_error(calibrated_pred, temp), 4)
        errors["analytic"].append(entry["analytic_error"])
        errors["calibrated"].append(entry["calibrated_error"])

    def _stats(vals: list[float]) -> dict[str, float] | None:
        if not vals:
            return None
        return {"mean": round(sum(vals) / len(vals), 4),
                "max": round(max(vals), 4), "corners": len(vals)}

    platform, device_kind = device_identity(devices)
    calibration = MemoryCalibration(
        workload=spec.name,
        key=calibration_key(spec.name, config, n, platform, device_kind),
        act_fraction=act_fraction, recompute_cost=recompute_cost)
    constants = calibration.constants()
    return {
        "version": CALIBRATION_SCHEMA_VERSION,
        "key": calibration.key,
        "workload": spec.name,
        "constants": constants,
        "constants_hash": _digest(constants),
        "corners": measured,
        "errors": {"analytic": _stats(errors["analytic"]),
                   "calibrated": _stats(errors["calibrated"])},
        "topology": {"n_devices": n, "platform": platform,
                     "device_kind": device_kind},
        "analytic_fallback": {
            "act_fraction": {corner_name(k): v
                             for k, v in sorted(ACT_FRACTION.items())}},
    }


def save_calibration(path: str, record: dict[str, Any]) -> dict[str, Any]:
    """Atomic write of a :func:`run_calibration` record."""
    import json

    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return record


def load_calibration(path: str, expected_key: str | None = None
                     ) -> tuple[MemoryCalibration, dict[str, Any]]:
    """Read and verify an artifact; :class:`StaleCalibrationError` on a
    foreign schema version, a key mismatch, or edited constants."""
    import json

    with open(path) as f:
        record = json.load(f)
    version = record.get("version")
    if version != CALIBRATION_SCHEMA_VERSION:
        raise StaleCalibrationError(
            f"calibration {path}: schema version {version!r} != "
            f"{CALIBRATION_SCHEMA_VERSION} (re-run calibration)")
    if expected_key is not None and record.get("key") != expected_key:
        raise StaleCalibrationError(
            f"calibration {path}: key {record.get('key')!r} was measured "
            f"for a different workload/geometry/topology (this run's "
            f"key: {expected_key!r}); re-run calibration")
    stored = record.get("constants_hash")
    if stored and stored != _digest(record.get("constants", {})):
        raise StaleCalibrationError(
            f"calibration {path}: constants_hash {stored!r} does not "
            "match the stored constants (artifact edited?)")
    return MemoryCalibration.from_record(record), record


def maybe_load_calibration(path: str | None,
                           expected_key: str | None = None
                           ) -> MemoryCalibration | None:
    """The consult-when-present path: None when no artifact exists;
    stale artifacts still raise (silently ignoring one would train the
    planner on constants measured for a different run)."""
    if not path or not os.path.exists(path):
        return None
    return load_calibration(path, expected_key=expected_key)[0]
