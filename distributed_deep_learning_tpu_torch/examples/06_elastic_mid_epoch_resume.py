"""Elastic training: survive a mid-epoch failure, resume at the step.

``--elastic`` wraps the run in checkpointed-restart recovery;
``--checkpoint-every N`` saves every N global steps (a step checkpoint
plus the loader's position), so a failure costs at most N steps, not an
epoch.  Here the built-in chaos hook kills the run after global step 5 on
its first attempt; recovery restores the last step checkpoint, rewinds
the loader to the exact batch and finishes the run.

    python -m distributed_deep_learning_tpu_torch.examples.06_elastic_mid_epoch_resume
    python -m distributed_deep_learning_tpu_torch.examples.06_elastic_mid_epoch_resume --cpu

Equivalent shell command:

    DDL_INJECT_STEP_FAILURE=all:5 python -m distributed_deep_learning_tpu_torch \\
        mlp -e 2 -b 32 -m data --elastic --checkpoint-dir "$(mktemp -d)" \\
        --checkpoint-every 2

The pass condition is the JAX example's: the hook fired, the test phase
ran, and the last train phase's loss is below the first's.
"""

import json
import os
import sys
import tempfile

from distributed_deep_learning_tpu_torch.examples import _bootstrap


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__).parse_args(argv)
    device = _bootstrap.device(args)
    from distributed_deep_learning_tpu_torch.utils import failures

    saved = {k: os.environ.get(k) for k in ("DDL_DATA_LIMIT",
                                            "DDL_INJECT_STEP_FAILURE")}
    # forced, not setdefault: the step-5 injection needs more than 5
    # global steps of data
    os.environ["DDL_DATA_LIMIT"] = "512"
    os.environ["DDL_INJECT_STEP_FAILURE"] = "all:5"   # die after step 5
    failures._step_injected = False
    try:
        with tempfile.TemporaryDirectory() as workdir:
            metrics = os.path.join(workdir, "metrics.jsonl")
            _bootstrap.run_cli([
                "mlp", "-e", "2", "-b", "32", "-m", "data", "-d", device,
                "--elastic", "--checkpoint-dir",
                os.path.join(workdir, "ck"), "--checkpoint-every", "2",
                "--metrics-file", metrics])
            events = [json.loads(line) for line in open(metrics)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert failures._step_injected, \
        "chaos hook never fired: nothing was tested"
    assert any(e["event"] == "phase_end" and e.get("phase") == "test"
               for e in events), "run did not finish"
    trains = [e for e in events
              if e["event"] == "phase_end" and e.get("phase") == "train"]
    assert trains[-1]["loss"] < trains[0]["loss"], \
        "did not learn through restart"
    print(f"survived the injected step-5 failure on {device}; train loss "
          f"{trains[0]['loss']:.4f} -> {trains[-1]['loss']:.4f}, test "
          "complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
