"""Mixture-of-experts LM with expert parallelism: one ``--mesh`` flag.

The ``moe`` workload trains a decoder LM whose MLPs are a fixed-capacity
top-2-routed expert bank, with the router's load-balance auxiliary loss
added to the step's loss.  ``--mesh data=D,expert=E`` splits the expert
bank over the ``expert`` ranks: each holds its experts' weights, and the
tokens reach them through all-to-alls.

    python -m distributed_deep_learning_tpu_torch.examples.07_moe_expert_parallel_cli
    python -m distributed_deep_learning_tpu_torch.examples.07_moe_expert_parallel_cli --cpu --ranks 2

Equivalent shell command (2 ranks):

    python -m distributed_deep_learning_tpu_torch moe -l 2 -s 64 -e 2 \\
        -b 16 -m data --mesh data=1,expert=2 --spawn -r 2

The expert degree is 4, as in the JAX example, when the ranks divide by
4, else the largest of 2 and 4 that divides them (2 ranks: expert=2);
``data`` spans the rest.  The pass condition is the JAX example's: the
last train phase's loss below the first's.
"""

import math
import os
import sys
import tempfile

from distributed_deep_learning_tpu_torch.examples import _bootstrap

MODULE = "distributed_deep_learning_tpu_torch.examples." \
    "07_moe_expert_parallel_cli"


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__, ranks=True).parse_args(argv)
    if not _bootstrap.in_rank():
        if args.ranks % 2:
            sys.exit(f"need an even rank count for an expert axis, have "
                     f"{args.ranks}")
        return _bootstrap.launch(MODULE, args, argv)
    n, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    experts = math.gcd(n, 4)
    mesh = f"data={n // experts},expert={experts}"
    saved = os.environ.get("DDL_DATA_LIMIT")
    os.environ.setdefault("DDL_DATA_LIMIT", "256")  # keep the demo quick
    try:
        with tempfile.TemporaryDirectory() as tmp:
            metrics = os.path.join(tmp, f"metrics.{rank}.jsonl")
            _bootstrap.run_cli([
                "moe", "-l", "2", "-s", "64", "-e", "2", "-b", "16",
                "-m", "data", "--mesh", mesh, "-d", _bootstrap.device(args),
                "--metrics-file", metrics])
            trains = _bootstrap.train_phase_ends(metrics)
    finally:
        if saved is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
    assert trains[-1]["loss"] < trains[0]["loss"], "MoE run did not learn"
    if rank == 0:
        print(f"expert-parallel ({mesh}) MoE train loss: "
              f"{trains[0]['loss']:.4f} -> {trains[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
