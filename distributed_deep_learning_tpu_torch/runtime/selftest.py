"""Distributed smoke test of the sharded state: the port of
``distributed_deep_learning_tpu/runtime/selftest.py``.

Run one copy per rank (``launch_local(N, argv,
module="distributed_deep_learning_tpu_torch.runtime.selftest")``, or
under a launcher): each rank joins the process group, trains ``gpt`` at a
small size for a few ``-m data`` steps under the sharding flags it is
given (``--zero 1|fsdp``, ``--mesh ...``), and prints one line::

    SELFTEST rank=R world=W loss=<f> checksum=<f>

``loss`` (the last step's, over the global batch) and ``checksum`` (the
sum of |param| over the whole parameters, gathered) must be IDENTICAL on
every rank: ranks whose gradients or shards fell out of step (the
reference's quirk Q1) print different ones.  The model is ``gpt``, not
the JAX selftest's MLP, because an MLP has no tensor-parallel rules.
"""

from __future__ import annotations

import sys

#: the model and batch every rank trains (``-d`` and the sharding flags
#: come from the command line; ``-d cpu`` runs it on gloo)
BASE = ["-m", "data", "-l", "2", "-s", "64", "-b", "8", "--seed", "3"]


def main(argv: list[str] | None = None, steps: int = 3) -> str:
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        whole_state_dict
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        train_setup

    argv = sys.argv[1:] if argv is None else list(argv)
    config = parse_args(BASE + argv, workload="gpt")
    env, created = bootstrap.initialize(config.device)
    try:
        state, train_step, _, (train, _, _), *_ = train_setup(
            get_spec("gpt"), config, env, None, PhaseLogger(verbose=False))
        train.set_epoch(1)
        done, loss = 0, 0.0
        while done < steps:
            for x, y in train:
                state, metrics = train_step(state, x, y)
                loss, done = float(metrics["loss"]), done + 1
                if done >= steps:
                    break
        checksum = float(sum(v.float().abs().sum() for v in
                             whole_state_dict(state.model).values()))
    finally:
        if created:
            bootstrap.shutdown()
    line = (f"SELFTEST rank={env.rank} world={env.world} loss={loss:.6f} "
            f"checksum={checksum:.6f}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
