"""Hybrid data x tensor parallelism through the CLI: one ``--mesh`` flag.

``--mesh data=N,model=2`` lays the ranks out as an N x 2 mesh: the batch
splits over ``data``, and the workload's tensor-parallel rules split the
attention heads, the MLP's hidden units and the embedding table over
``model`` (Megatron-style; the all-reduces are the rules' own).  The
training math is unchanged.

    python -m distributed_deep_learning_tpu_torch.examples.05_tensor_parallel_gpt_cli
    python -m distributed_deep_learning_tpu_torch.examples.05_tensor_parallel_gpt_cli --cpu --ranks 2

Equivalent shell command (2 ranks):

    python -m distributed_deep_learning_tpu_torch gpt -l 2 -s 64 -e 2 \\
        -b 16 -m data --mesh data=1,model=2 --spawn -r 2

Each rank runs the CLI in its process (``--ranks`` even; ``data`` spans
the rest); the pass condition is the JAX example's: the last train
phase's loss below the first's.
"""

import os
import sys
import tempfile

from distributed_deep_learning_tpu_torch.examples import _bootstrap

MODULE = "distributed_deep_learning_tpu_torch.examples." \
    "05_tensor_parallel_gpt_cli"


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__, ranks=True).parse_args(argv)
    if not _bootstrap.in_rank():
        if args.ranks % 2:
            sys.exit(f"need an even rank count for model=2, have "
                     f"{args.ranks}")
        return _bootstrap.launch(MODULE, args, argv)
    n, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    # TP degree 2 (the tiny demo model has 2 attention heads); data spans
    # the other ranks
    mesh = f"data={n // 2},model=2"
    saved = os.environ.get("DDL_DATA_LIMIT")
    os.environ.setdefault("DDL_DATA_LIMIT", "256")  # keep the demo quick
    try:
        with tempfile.TemporaryDirectory() as tmp:
            metrics = os.path.join(tmp, f"metrics.{rank}.jsonl")
            _bootstrap.run_cli([
                "gpt", "-l", "2", "-s", "64", "-e", "2", "-b", "16",
                "-m", "data", "--mesh", mesh, "-d", _bootstrap.device(args),
                "--metrics-file", metrics])
            trains = _bootstrap.train_phase_ends(metrics)
    finally:
        if saved is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
    assert trains[-1]["loss"] < trains[0]["loss"], "TP run did not learn"
    if rank == 0:
        print(f"tensor-parallel ({mesh}) train loss: "
              f"{trains[0]['loss']:.4f} -> {trains[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
