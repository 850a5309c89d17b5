"""Pipeline-parallel GPT training through the CLI: one command.

``-m pipeline`` runs the decoder trunk as a pipeline: ``--nstages`` cuts
the layers into stages, and microbatches flow through a 1F1B schedule
(``--pipeline-schedule interleaved --virtual-stages 2`` interleaves
virtual stages; ``gpipe`` is plain fill-drain).  In one process the
stages share the device and one process walks them all; launched as
``dp x S`` ranks it becomes the data x stage grid.

    python -m distributed_deep_learning_tpu_torch.examples.04_pipelined_gpt_cli
    python -m distributed_deep_learning_tpu_torch.examples.04_pipelined_gpt_cli --cpu

Equivalent shell command:

    python -m distributed_deep_learning_tpu_torch gpt -l 4 -s 64 -e 2 \\
        -b 16 -m pipeline --nstages 4 --pipeline-schedule 1f1b

The pass condition is the JAX example's: the last train phase's loss
below the first's.
"""

import os
import sys
import tempfile

from distributed_deep_learning_tpu_torch.examples import _bootstrap


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__).parse_args(argv)
    device = _bootstrap.device(args)
    saved = os.environ.get("DDL_DATA_LIMIT")
    os.environ.setdefault("DDL_DATA_LIMIT", "256")  # keep the demo quick
    try:
        with tempfile.TemporaryDirectory() as tmp:
            metrics = os.path.join(tmp, "metrics.jsonl")
            _bootstrap.run_cli([
                "gpt", "-l", "4", "-s", "64", "-e", "2", "-b", "16",
                "-m", "pipeline", "--nstages", "4",
                "--pipeline-schedule", "1f1b", "-d", device,
                "--metrics-file", metrics])
            trains = _bootstrap.train_phase_ends(metrics)
    finally:
        if saved is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
    assert trains[-1]["loss"] < trains[0]["loss"], \
        "pipeline run did not learn"
    print(f"pipelined train loss on {device}: {trains[0]['loss']:.4f} -> "
          f"{trains[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
