"""The planner's driver: enumerate → prune → rank → successive halving.
The port of ``distributed_deep_learning_tpu/tune/search.py``.

Pipeline: :func:`~.space.enumerate_plans` builds the legal lattice;
:func:`~.memory.prune_plans` drops analytically infeasible points before
any compile; survivors are ranked by a deterministic analytic cost score
(recompute/traffic multipliers — the pre-trial stand-in for the FLOP
count each trial records once it HAS run) and
capped to ``max_trials`` (the dropped count is logged — a silent cap would
read as full coverage); then successive halving measures the pool with
:class:`~.trial.TrialHarness`, keeping the top ``1/eta`` by steps/sec and
doubling the measured steps per rung.

The hand-default config's own plan rides through every rung, so the final
rung always contains an apples-to-apples baseline measurement and the
winner is ≥ it by construction of the argmax.  The whole search is
deterministic under a seed: enumeration order is fixed, ties break on
``plan_hash``, and wall-clock fields are excluded from the deterministic
record (:meth:`SearchResult.record`).  Under ``-m data`` every rank runs
the search in lockstep and takes the same decisions (the trials' rates
are rank 0's, :mod:`.trial`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.tune.artifact import plan_hash
from distributed_deep_learning_tpu_torch.tune.memory import (
    OPT_SLOTS, ModelGeometry, estimate_memory, hbm_budget, prune_plans)
from distributed_deep_learning_tpu_torch.tune.space import (
    Plan, enumerate_plans, plan_from_config)
from distributed_deep_learning_tpu_torch.tune.trial import (
    TrialHarness, TrialResult, launched_devices)
from distributed_deep_learning_tpu_torch.utils.config import Config

#: analytic step-cost multiplier per (remat, policy): remat trades FLOPs
#: for memory, so heavier recompute ranks later when the trial pool is
#: capped (the measured rungs have the final word)
RECOMPUTE_COST = {
    (False, "nothing"): 1.00,
    (True, "dots"): 1.15,
    (True, "dots_no_batch"): 1.25,
    (True, "nothing"): 1.35,
}

#: transformer-family workloads — their activation geometry scales with
#: sequence length, not feature count
_SEQ_WORKLOADS = ("gpt", "bert", "transformer", "moe", "lstm")


def analytic_score(plan: Plan, recompute_cost: dict[tuple[bool, str], float]
                   | None = None) -> float:
    """Lower = expected faster; a coarse pre-compile ranking only.

    ``recompute_cost`` optionally replaces the static table with a
    calibration's measured per-corner step-cost ratios; corners it
    doesn't cover keep the analytic value."""
    key = (plan.remat, plan.remat_policy)
    if recompute_cost is not None and key in recompute_cost:
        score = float(recompute_cost[key])
    else:
        score = RECOMPUTE_COST[key]
    score *= 1.0 + 0.05 * (plan.grad_accum - 1)   # scan overhead
    if plan.zero == "1":
        score *= 1.05                             # moment allgather
    elif plan.zero == "fsdp":
        score *= 1.10                             # param+moment allgather
    if plan.grad_compress != "none":
        score *= 1.02                             # quantize/dequantize work
    if plan.comm != "none":
        score *= 1.02                             # quantize/dequantize work
        if plan.comm_overlap:
            score *= 0.99                         # ring hides wire time
    return score


def model_geometry(spec, config: Config, dataset) -> ModelGeometry:
    """Analytic geometry for the memory model.  The parameter count comes
    from the model built on the ``meta`` device — exact and free (no
    arrays are materialised; BatchNorm statistics are buffers, not
    parameters, as flax keeps them out of ``params``); activation terms
    are per-family formulas, good to ordering (the trials cross-check
    bytes)."""
    with torch.device("meta"):
        model = spec.build_model(config, dataset)
    param_count = sum(p.numel() for p in model.parameters())
    x, _ = dataset.batch(np.arange(1))
    width = max(1, config.size)
    if spec.name in _SEQ_WORKLOADS and np.ndim(x) > 1:
        seq = int(np.shape(x)[1])
        # attention scores + MLP intermediates dominate: ~8 x d_model
        # elems per token per layer
        layer_act = seq * width * 8
        extra = seq * width * 2                   # embeddings + head staging
    else:
        layer_act = width * 4                     # dense + norm + nonlin
        extra = int(np.prod(np.shape(x)[1:]))     # input staging
    return ModelGeometry(param_count=param_count,
                         num_layers=max(1, config.num_layers),
                         layer_act_elems_per_example=layer_act,
                         extra_act_elems_per_example=extra,
                         opt_slots=OPT_SLOTS.get(config.optimizer, 2))


@dataclasses.dataclass
class SearchResult:
    best: Plan
    best_sps: float
    baseline: Plan
    baseline_sps: float
    n_devices: int
    n_candidates: int
    n_pruned: int
    n_capped: int
    n_infeasible: int
    rungs: int
    budget_bytes: int | None
    trials: list[TrialResult]
    search_seconds: float

    def record(self, *, deterministic_only: bool = False) -> dict[str, Any]:
        """JSON-able summary.  ``deterministic_only`` keeps exactly the
        fields that must be bit-identical across seeded runs (no wall
        clocks, no backend-dependent analyses)."""
        d = {
            "best_plan": self.best.to_dict(),
            "best_plan_hash": plan_hash(self.best),
            "best_steps_per_sec": self.best_sps,
            "baseline_plan": self.baseline.to_dict(),
            "baseline_plan_hash": plan_hash(self.baseline),
            "baseline_steps_per_sec": self.baseline_sps,
            "n_devices": self.n_devices,
            "n_candidates": self.n_candidates,
            "n_pruned_analytic": self.n_pruned,
            "n_capped": self.n_capped,
            "n_infeasible": self.n_infeasible,
            "rungs": self.rungs,
            "trials": [t.to_dict(deterministic_only=deterministic_only)
                       for t in self.trials],
        }
        if not deterministic_only:
            d["budget_bytes"] = self.budget_bytes
            d["search_seconds"] = self.search_seconds
        return d


def run_search(spec, config: Config, *, devices=None, dataset=None,
               logger=None, trial_steps: int = 4, warmup: int = 2,
               eta: int = 2, max_trials: int | None = 16,
               max_rungs: int = 6, budget_bytes: int | None = None,
               measure: Callable[[Plan, int], float] | None = None,
               oom_hook: Callable[[Plan], None] | None = None,
               space_options: dict[str, Sequence] | None = None,
               calibration=None,
               ) -> SearchResult:
    """Search the plan lattice for `spec` under `config`'s geometry.

    ``space_options`` forwards to :func:`~.space.enumerate_plans` (restrict
    dtypes / zero / compress / accumulation for cheap searches);
    ``max_trials=None`` lifts the pool cap.  ``measure`` / ``oom_hook``
    are the deterministic / chaos injection points (see
    :class:`~.trial.TrialHarness`).  ``calibration`` is an optional
    :class:`~.calibrate.MemoryCalibration`: its measured ``act_fraction``
    constants replace the analytic table in pruning and memory-ranked
    ordering, its ``recompute_cost`` the static step-cost multipliers in
    the analytic score — corners a calibration doesn't cover fall back to
    the tables per-corner."""
    t_start = time.perf_counter()
    if devices is None:
        devices = launched_devices(config)
    devices = list(devices)
    n = len(devices)
    if dataset is None:
        dataset = spec.build_dataset(config)
    opts = dict(space_options or {})
    opts.setdefault("dtypes", (config.dtype,))
    plans = enumerate_plans(n, config.batch_size, **opts)
    geom = model_geometry(spec, config, dataset)
    budget = hbm_budget(devices, override=budget_bytes)
    act_fraction = getattr(calibration, "act_fraction", None)
    recompute_cost = getattr(calibration, "recompute_cost", None)
    feasible, rejected = prune_plans(plans, geom, config.batch_size, budget,
                                     act_fraction=act_fraction)
    if not feasible:
        raise ValueError(
            f"memory model pruned all {len(plans)} candidate plans "
            f"(budget {budget} bytes); nothing to measure")

    order = sorted(feasible, key=lambda p: (
        analytic_score(p, recompute_cost),
        estimate_memory(p, geom, config.batch_size,
                        act_fraction=act_fraction).total_bytes,
        plan_hash(p)))
    n_capped = 0
    if max_trials is not None and len(order) > max_trials:
        n_capped = len(order) - max_trials
        order = order[:max_trials]
        if logger:
            logger.info(f"autotune: trial pool capped at {max_trials} of "
                        f"{len(feasible)} feasible plans ({n_capped} "
                        "dropped by analytic rank)")
    baseline = plan_from_config(config, n)
    if baseline not in order:
        order = order + [baseline]

    harness = TrialHarness(spec, config, dataset, devices, warmup=warmup,
                           oom_hook=oom_hook, measure=measure)
    trials: list[TrialResult] = []
    survivors = order
    steps = trial_steps
    rungs = 0
    while True:
        rung = [harness.run(p, steps) for p in survivors]
        trials.extend(rung)
        rungs += 1
        alive = sorted((r for r in rung if not r.infeasible),
                       key=lambda r: (-r.steps_per_sec, plan_hash(r.plan)))
        if not alive:
            raise RuntimeError(
                "no plan survived measured trials (every candidate "
                "infeasible) — see the trial errors in the search record")
        if len(alive) <= 2 or rungs >= max_rungs:
            final = alive
            break
        keep = max(2, len(alive) // eta)
        nxt = [r.plan for r in alive[:keep]]
        if baseline not in nxt:
            # the hand default rides every rung: the final comparison must
            # be measured in the same rung as the winner
            nxt.append(baseline)
        if set(nxt) == {r.plan for r in rung}:
            final = alive   # halving reached a fixpoint
            break
        if logger:
            logger.info(f"autotune rung {rungs}: {len(alive)} alive, "
                        f"keeping {len(nxt)}; next rung {steps * 2} steps")
        survivors = nxt
        steps *= 2

    best = final[0]
    baseline_result = next((r for r in final if r.plan == baseline), None)
    if baseline_result is None:   # baseline went infeasible mid-search
        baseline_result = next(
            (r for r in reversed(trials)
             if r.plan == baseline and not r.infeasible), None)
    baseline_sps = baseline_result.steps_per_sec if baseline_result else 0.0
    return SearchResult(
        best=best.plan, best_sps=best.steps_per_sec,
        baseline=baseline, baseline_sps=baseline_sps,
        n_devices=n, n_candidates=len(plans), n_pruned=len(rejected),
        n_capped=n_capped,
        n_infeasible=sum(1 for r in trials if r.infeasible),
        rungs=rungs, budget_bytes=budget, trials=trials,
        search_seconds=time.perf_counter() - t_start)
