"""Versioned plan artifacts: the search result as a replayable JSON file.
The port of ``distributed_deep_learning_tpu/tune/artifact.py``: the same
schema, digests and messages, so an artifact's ``key`` and ``plan_hash``
are the JAX package's for the same inputs.

A plan is only meaningful for the (workload, model geometry, topology) it
was searched on — replaying a gpt/8-device plan on an mlp/1-device run
would silently train the wrong configuration.  So every artifact carries a
``key``: a hash over exactly those inputs, recomputed at load time and
rejected on mismatch (:class:`StalePlanError`), the same way the packed
sample cache rejects a stale source.  ``plan_hash`` fingerprints the plan
itself so bench records can track plan churn across commits.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

from distributed_deep_learning_tpu_torch.tune.space import Plan
from distributed_deep_learning_tpu_torch.utils.config import Config

#: v2: Plan grew the ``comm``/``comm_overlap`` axes (quantized +
#: ring-overlapped FSDP collectives) — v1 artifacts predate them and
#: must re-search, not silently replay without the new knobs
#: v3: Plan grew the serving-surface axes ``paged``/``kv_dtype``/
#: ``weight_dtype`` (quantized serving hot path) — v2 artifacts lack
#: them and must re-search for the same reason
PLAN_SCHEMA_VERSION = 3


class StalePlanError(ValueError):
    """The artifact's schema version or key does not match this run."""


def _digest(payload: Any) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def plan_key(workload: str, config: Config, n_devices: int,
             platform: str = "", device_kind: str = "") -> str:
    """Hash of what a plan is valid FOR: workload + model geometry +
    topology.  Deliberately excludes every knob the search itself sets
    (mesh, remat, zero, ...) — those live in the plan."""
    return _digest({
        "workload": workload,
        "num_layers": config.num_layers,
        "size": config.size,
        "batch_size": config.batch_size,
        "n_devices": n_devices,
        "platform": platform,
        "device_kind": device_kind,
    })


def plan_hash(plan: Plan) -> str:
    """Stable fingerprint of the plan itself (for churn tracking)."""
    return _digest(plan.to_dict())


def save_plan(path: str, plan: Plan, *, key: str, workload: str,
              topology: dict[str, Any] | None = None,
              search: dict[str, Any] | None = None) -> dict[str, Any]:
    """Write the artifact; returns the record written."""
    record = {
        "version": PLAN_SCHEMA_VERSION,
        "key": key,
        "workload": workload,
        "plan": plan.to_dict(),
        "plan_hash": plan_hash(plan),
        "topology": topology or {},
        # search telemetry (trial scores, wall time) — informational only,
        # never part of the key or hash
        "search": search or {},
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return record


def load_plan(path: str, expected_key: str | None = None
              ) -> tuple[Plan, dict[str, Any]]:
    """Read and verify an artifact; returns (plan, full record).

    Raises :class:`StalePlanError` when the schema version is foreign or
    ``expected_key`` (this run's recomputed key) doesn't match — a plan
    searched for a different workload/geometry/topology must not apply.
    """
    with open(path) as f:
        record = json.load(f)
    version = record.get("version")
    if version != PLAN_SCHEMA_VERSION:
        raise StalePlanError(
            f"plan {path}: schema version {version!r} != "
            f"{PLAN_SCHEMA_VERSION} (re-run --autotune)")
    if expected_key is not None and record.get("key") != expected_key:
        raise StalePlanError(
            f"plan {path}: key {record.get('key')!r} was searched for a "
            f"different workload/geometry/topology (this run's key: "
            f"{expected_key!r}); re-run --autotune")
    plan = Plan.from_dict(record["plan"])
    stored = record.get("plan_hash")
    if stored and stored != plan_hash(plan):
        raise StalePlanError(f"plan {path}: plan_hash {stored!r} does not "
                             "match the stored plan (artifact edited?)")
    return plan, record
