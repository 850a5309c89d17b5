"""Chaos drill: the counterpart of ``scripts/chaos_drill.py``.  Rehearse
the detect -> contain -> recover chain and print one JSON line; the exit
code is 0 only when the record's ``drill_passed`` is true.

Five scenarios, selected with ``--scenario``, each the port's library
drill on ``--device`` (``cuda`` unless ``cpu``):

* ``resilience`` (default): :func:`..utils.chaos.run_resilience_drill`, a
  NaN'd batch contained by the anomaly sentinel (bit-identical
  parameters), a truncated latest checkpoint quarantined with fallback to
  the verified save, an injected worker failure recovered by elastic
  restart; detection latency, recovery wall time, restarts used and the
  sentinel's step-time overhead.
* ``shrink``: :func:`..reshard.drill.run_shrink_drill`, gloo ranks on the
  CPU as the library launches them: seed-kill 2 of 8 workers, re-plan for
  the survivors through ``tune/``, restore the epoch checkpoint onto the
  new layout and continue, gated on the restored state's bytes and an
  epoch-2 loss matching the uninterrupted run's.
* ``serve``: :func:`..utils.chaos.run_serve_resilience_drill`, engine
  crash / NaN logits / corrupted KV block / stalled tick injected
  mid-decode under the supervisor (zero requests lost), slow ticks under
  admission control, and the hot weight-swap gauntlet, on ONE engine.
* ``fleet``: :func:`..utils.chaos.run_fleet_resilience_drill`, three
  router-fronted paged replicas: a replica killed mid-decode, a
  straggler, a flaky router, priority preemption with KV spill and
  resume, and a ``migrate_drop`` caught by the payload's digest.
* ``rebalance``: :func:`..utils.chaos.run_rebalance_drill`, live slot
  evacuation (f32 and int8 pools), a corrupted evacuation, a target crash
  mid-move, the autoscaler's drain and hysteresis, and a disaggregated
  engine's worker moved between its pools over four devices: the one
  device repeated (card 0 on the card), the stand-in for the JAX script's
  forced four-device host.

    python -m distributed_deep_learning_tpu_torch.scripts.chaos_drill \\
        [--seed N] [--scenario resilience|shrink|serve|fleet|rebalance] \\
        [--device cpu]
"""

import argparse
import json
import sys

SCENARIOS = ("resilience", "shrink", "serve", "fleet", "rebalance")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="chaos plan seed (same seed = same faults, "
                        "bit-identical poison masks / kill sets)")
    p.add_argument("--scenario", choices=SCENARIOS, default="resilience",
                   help="resilience: sentinel/corruption/restart chain; "
                        "shrink: kill workers, re-plan, reshard, continue; "
                        "serve: engine supervisor replay + hot weight "
                        "swap + SLO admission under injected serve faults; "
                        "fleet: multi-replica failover, straggler "
                        "degradation, router flake, priority preemption "
                        "with KV spill/resume; rebalance: mid-request "
                        "slot evacuation, elastic autoscaling with drain "
                        "protocol, rebalance fault gauntlet")
    p.add_argument("--device", default="cuda",
                   help="cuda (card 0) or cpu; the shrink scenario's ranks "
                        "run on the CPU, as the library launches them")
    args = p.parse_args(argv)

    import torch

    from distributed_deep_learning_tpu_torch import resolve_device
    from distributed_deep_learning_tpu_torch.utils import chaos

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    if args.scenario == "shrink":
        from distributed_deep_learning_tpu_torch.reshard.drill import \
            run_shrink_drill

        record = run_shrink_drill(seed=args.seed)
    elif args.scenario == "fleet":
        record = chaos.run_fleet_resilience_drill(seed=args.seed,
                                                  device=device)
    elif args.scenario == "rebalance":
        record = chaos.run_rebalance_drill(seed=args.seed, device=device,
                                           disagg_devices=[device] * 4)
    elif args.scenario == "serve":
        record = chaos.run_serve_resilience_drill(seed=args.seed,
                                                  device=device)
    else:
        record = chaos.run_resilience_drill(seed=args.seed, device=device)
        record["drill_passed"] = bool(
            record["containment_bit_identical"]
            and record["corrupt_restore_fell_back"]
            and record["recovered_bit_identical"])
        record = {"metric": "resilience drill", **record}
    print(json.dumps(record))
    return 0 if record["drill_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
