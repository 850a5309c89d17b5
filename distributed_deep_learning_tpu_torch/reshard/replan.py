"""Re-plan for the surviving topology before a resharding restore.
The port of ``distributed_deep_learning_tpu/reshard/replan.py``; a device
is a launched rank.

When an elastic restart comes up on fewer (or differently-arranged)
devices than the checkpoint was written on, *something* has to pick the
new mesh.  This module delegates that to the existing ``tune/`` machinery
instead of inventing a second planner: :func:`choose_plan` enumerates the
legal lattice for the surviving device count (same legality rules as
``--tune``), prunes with the analytic memory model when a geometry is
available, and ranks by the analytic cost score; :func:`replan_config` can
optionally confirm the analytic pick with a couple of measured trial steps
(``run_search``) before committing.

The global batch size is held fixed across the re-plan — convergence
math (LR schedule, steps/epoch, accumulation) must not silently change
because hardware died.  If the surviving count cannot divide the batch
(e.g. batch 64 on 6 devices), the planner steps down to the largest
device subset that can, which is exactly what a human operator would do.
The port runs one process a rank, so the ranks beyond such a plan sit the
run out (:func:`..workloads.base._step_down`).
"""

from __future__ import annotations

import glob
import json
import os
import re

from distributed_deep_learning_tpu_torch.reshard.manifest import Topology
from distributed_deep_learning_tpu_torch.tune.artifact import plan_hash
from distributed_deep_learning_tpu_torch.tune.memory import (hbm_budget,
                                                             prune_plans)
from distributed_deep_learning_tpu_torch.tune.search import (
    analytic_score, model_geometry, run_search)
from distributed_deep_learning_tpu_torch.tune.space import (
    Plan, apply_plan, enumerate_plans)
from distributed_deep_learning_tpu_torch.utils.config import Config


def _pinned_options(config: Config) -> dict:
    """Restrict the lattice to the knobs the run was already using — a
    restart should change the mesh, not the numerics."""
    return {
        "dtypes": (config.dtype,),
        "grad_accum_options": (config.grad_accum,),
        "attention_options": (config.attention,),
        "zero_options": (config.zero,),
        "compress_options": (config.grad_compress,),
    }


def choose_plan(n_devices: int, batch_size: int, *, geom=None,
                budget_bytes: int | None = None, allow_fewer: bool = True,
                space_options: dict | None = None) -> Plan:
    """Best legal plan for at most ``n_devices`` devices at ``batch_size``.

    Walks device counts downward (``allow_fewer``) so a batch that cannot
    divide over the survivors still finds a home on the largest usable
    subset — 6 survivors at batch 64 re-plan onto 4.  Raises ``ValueError``
    when no subset admits a legal plan.
    """
    opts = dict(space_options or {})
    counts = range(n_devices, 0, -1) if allow_fewer else (n_devices,)
    for m in counts:
        plans = enumerate_plans(m, batch_size, **opts)
        if plans and geom is not None:
            plans, _ = prune_plans(plans, geom, batch_size, budget_bytes)
        if not plans:
            continue
        # Rank: analytic cost, then widest data axis, then stable hash.
        return min(plans, key=lambda p: (analytic_score(p),
                                         -p.mesh_dict().get("data", 1),
                                         plan_hash(p)))
    raise ValueError(
        f"no legal plan for <= {n_devices} device(s) at batch {batch_size}"
        f" under {opts or 'default lattice options'}")


def replan_config(spec, config: Config, devices, *, dataset=None,
                  logger=None, measure_trials: bool = False,
                  ) -> tuple[Config, Plan]:
    """Pick a plan for ``devices`` and realise it on ``config``.

    Analytic by default (restart latency matters more than the last few
    percent of throughput); ``measure_trials=True`` runs a tiny
    ``run_search`` (2 steps, <=4 trials, knobs pinned) and falls back to
    the analytic pick if measurement fails for any reason — a re-plan
    must never strand the restart it exists to save.
    """
    geom = None
    try:
        if spec is not None:
            if dataset is None:
                dataset = spec.build_dataset(config)
            geom = model_geometry(spec, config, dataset)
    except Exception:
        geom = None  # analytic model is an optimisation, never a blocker
    budget = hbm_budget(list(devices))

    if measure_trials and spec is not None:
        try:
            result = run_search(spec, config, devices=list(devices),
                                dataset=dataset, logger=logger,
                                trial_steps=2, max_trials=4,
                                space_options=_pinned_options(config))
            plan = result.best
            if logger:
                logger.info(f"reshard: measured re-plan picked "
                            f"{plan.describe()} ({plan_hash(plan)})")
            return apply_plan(config, plan), plan
        except Exception as exc:
            if logger:
                logger.info(f"reshard: measured re-plan failed "
                            f"({type(exc).__name__}: {exc}); "
                            "using the analytic planner")

    try:
        plan = choose_plan(len(list(devices)), config.batch_size, geom=geom,
                           budget_bytes=budget,
                           space_options=_pinned_options(config))
    except ValueError:
        # Pinned knobs admitted nothing (e.g. zero=fsdp on a 1-wide shard
        # axis): relax to the default lattice rather than refuse to restart.
        plan = choose_plan(len(list(devices)), config.batch_size, geom=geom,
                           budget_bytes=budget)
    if logger:
        logger.info(f"reshard: re-planned for {len(list(devices))} "
                    f"device(s): {plan.describe()} ({plan_hash(plan)})")
    return apply_plan(config, plan), plan


_MANIFEST_RE = re.compile(r"manifest-(\d+)\.json$")


def latest_topology(checkpoint_dir: str) -> tuple[int | None,
                                                  Topology | None]:
    """Newest saved step's topology, read straight from the sidecar files —
    no checkpointer, safe to call before any mesh exists.

    Returns ``(step, Topology)``; ``(step, None)`` when the newest sidecar
    predates topology manifests (legacy); ``(None, None)`` when nothing
    readable is saved."""
    candidates = []
    for path in glob.glob(os.path.join(checkpoint_dir, "manifest-*.json")):
        m = _MANIFEST_RE.search(os.path.basename(path))
        if m:
            candidates.append((int(m.group(1)), path))
    for step, path in sorted(candidates, reverse=True):
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        return step, Topology.from_json(payload.get("topology"))
    return None, None


def resolve_restart_topology(spec, config: Config, devices, logger, *,
                             dataset=None) -> Config:
    """The ``--reshard`` startup hook: decide this restart's mesh *before*
    the trainer builds it.

    * ``--target-mesh`` wins outright (operator knows best).
    * Nothing saved yet, or a legacy checkpoint with no topology manifest:
      leave the config alone (warn for legacy — the restore will treat it
      as same-topology).
    * Saved topology matches what this run would build anyway: no-op.
    * Otherwise: re-plan for the surviving devices via ``tune/``.
    """
    if config.target_mesh:
        if logger:
            logger.info("reshard: explicit --target-mesh "
                        f"{config.target_mesh}; skipping re-plan")
        return config.replace(mesh_shape=dict(config.target_mesh))
    if not config.checkpoint_dir:
        return config
    step, topo = latest_topology(config.checkpoint_dir)
    if step is None:
        return config  # fresh run: nothing to reshard from
    if topo is None:
        if logger:
            logger.info(f"reshard: checkpoint step {step} predates topology "
                        "manifests; assuming same topology (legacy)")
        return config
    if config.mesh_shape:
        # Operator pinned a mesh with --mesh; the resharding restore
        # handles any mismatch against the saved topology.
        return config
    n = len(list(devices))
    saved = dict(topo.normalized_mesh())
    if topo.n_devices == n and saved == {"data": n}:
        return config  # the default data=N mesh — same topology, no re-plan
    if logger:
        logger.info(f"reshard: saved topology {topo.describe()} != "
                    f"{n} surviving device(s); re-planning via tune/")
    new_config, _plan = replan_config(spec, config, list(devices),
                                     dataset=dataset, logger=logger)
    return new_config
