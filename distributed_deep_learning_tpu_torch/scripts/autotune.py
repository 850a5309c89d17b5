"""Execution-plan search: the counterpart of ``scripts/autotune.py``.
Search the plan lattice for one workload and write the artifact that a
training run replays with ``--plan FILE``.

Wraps :func:`..tune.search.run_search`: enumerate the legal (mesh x
microbatch x remat x ZeRO x compress) lattice for the launched ranks,
prune with the analytic memory model against the card's memory
(:func:`..tune.memory.hbm_budget`), measure the survivors with successive
halving, and write the winner as a versioned JSON artifact.  Prints ONE
JSON line (the search record).

    python -m distributed_deep_learning_tpu_torch.scripts.autotune mlp \
        -b 32 --out mlp.plan.json
    python -m distributed_deep_learning_tpu_torch.scripts.autotune gpt \
        -l 2 -s 64 -b 16 --trials 8
    python -m distributed_deep_learning_tpu_torch.scripts.autotune mlp \
        --dry-run                    # enumerate + prune only

``--dry-run`` builds and measures nothing (lattice size, analytic prune
counts, budget).  Unknown flags pass through to the workload's own CLI
(``-b``, ``-l``, ``--dtype``, ``-d cpu``, ...): the search runs on the
card unless ``-d cpu``.  Under a torchrun environment every rank runs the
search in lockstep and rank 0 writes the artifact, as ``--autotune``
does.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="search mesh x microbatch x remat x ZeRO plans for a "
                    "workload and write a --plan artifact")
    p.add_argument("workload", help="mlp|cnn|lstm|mnist|resnet|transformer|"
                                    "bert|moe|gpt")
    p.add_argument("--out", default=None,
                   help="plan artifact path (default: "
                        "autotune_<workload>.plan.json)")
    p.add_argument("--dry-run", action="store_true",
                   help="enumerate + analytic prune only; no compiles, no "
                        "trials")
    p.add_argument("--trials", type=int, default=16,
                   help="trial-pool cap after analytic ranking (0 = no cap)")
    p.add_argument("--trial-steps", type=int, default=4,
                   help="measured steps in the first halving rung "
                        "(doubles per rung)")
    p.add_argument("--budget-bytes", type=int, default=None,
                   help="override the per-device HBM budget (backends "
                        "without memory_stats, e.g. the CPU test mesh, "
                        "never prune without this)")
    p.add_argument("--full-space", action="store_true",
                   help="search ZeRO/compress/accumulation too (default: "
                        "mesh x remat only — the cheap, always-relevant "
                        "axes)")
    p.add_argument("--calibration", default=None, metavar="FILE",
                   help="measured memory-model calibration artifact "
                        "(tune.calibrate) — its fitted ACT_FRACTION/"
                        "RECOMPUTE_COST constants replace the analytic "
                        "tables for pruning and ranking; stale artifacts "
                        "(foreign schema/key) are an error, a missing "
                        "file falls back to the analytic model")
    args, rest = p.parse_known_args(argv)

    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.tune import (artifact, memory,
                                                          space)
    from distributed_deep_learning_tpu_torch.tune.trial import (
        device_identity, launched_devices)
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    spec = get_spec(args.workload)
    config = parse_args(rest, workload=args.workload)
    space_options = None if args.full_space else dict(
        zero_options=("none", "fsdp"), compress_options=("none",),
        grad_accum_options=(1,))

    devices = launched_devices(config)
    n = len(devices)
    platform, device_kind = device_identity(devices)

    if args.dry_run:
        # no model build, no compile: the lattice + the analytic model only
        plans = space.enumerate_plans(
            n, config.batch_size,
            **(space_options or {"dtypes": (config.dtype,)}))
        geom = memory.ModelGeometry(
            param_count=config.size * config.size * config.num_layers,
            num_layers=max(1, config.num_layers),
            layer_act_elems_per_example=config.size * 4)
        budget = memory.hbm_budget(devices, override=args.budget_bytes)
        feasible, rejected = memory.prune_plans(
            plans, geom, config.batch_size, budget)
        print(json.dumps({
            "workload": args.workload, "dry_run": True, "n_devices": n,
            "n_candidates": len(plans), "n_feasible": len(feasible),
            "n_pruned_analytic": len(rejected), "budget_bytes": budget,
        }))
        return 0

    from distributed_deep_learning_tpu_torch.tune.search import run_search

    calibration = None
    if args.calibration:
        from distributed_deep_learning_tpu_torch.tune import calibrate

        cal_key = calibrate.calibration_key(spec.name, config, n, platform,
                                            device_kind)
        calibration = calibrate.maybe_load_calibration(
            args.calibration, expected_key=cal_key)

    result = run_search(
        spec, config, devices=devices, trial_steps=args.trial_steps,
        max_trials=args.trials or None, budget_bytes=args.budget_bytes,
        space_options=space_options, calibration=calibration)
    key = artifact.plan_key(spec.name, config, n, platform, device_kind)
    out = args.out or f"autotune_{spec.name}.plan.json"
    if bootstrap.is_coordinator():
        artifact.save_plan(out, result.best, key=key, workload=spec.name,
                           topology={"n_devices": n, "platform": platform,
                                     "device_kind": device_kind},
                           search=result.record())
    record = result.record()
    record["artifact"] = out
    if args.calibration:
        record["calibration"] = {"path": args.calibration,
                                 "loaded": calibration is not None}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
