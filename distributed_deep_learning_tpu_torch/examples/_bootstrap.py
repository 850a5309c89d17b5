"""Shared example bootstrap: the device, the rank count, the launch.

The JAX examples emulate an 8-device CPU mesh; these run on the card
(``cuda``), or on the CPU under ``--cpu``.  The examples that need ranks
(02, 03, 05, 07) launch ``--ranks N`` of them (default 2) through
:func:`..runtime.launch.launch_local`: on the card one card a rank, the
launcher refusing more ranks than cards; on the CPU gloo ranks.  Under a
torchrun environment (``WORLD_SIZE`` set, as ``chip_smoke.py`` phase 41
sets it for ranks that share one card over gloo) an example runs as the
rank it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: seconds a launch's ranks may take
RANK_TIMEOUT = 600.0


def parser(doc: str, ranks: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    if ranks:
        p.add_argument("--ranks", type=int, default=2,
                       help="ranks to launch (without a torchrun "
                            "environment)")
    return p


def device(args) -> str:
    """``cpu`` under ``--cpu``, else ``cuda`` (raises without a card)."""
    from distributed_deep_learning_tpu_torch import resolve_device

    return str(resolve_device("cpu" if args.cpu else "cuda"))


def in_rank() -> bool:
    """Whether this process is one rank of a launch."""
    return "WORLD_SIZE" in os.environ


def launch(module: str, args, argv) -> int:
    """Run ``module`` as ``args.ranks`` ranks on this example's argv;
    prints each rank's output, rank 0's last."""
    from distributed_deep_learning_tpu_torch.runtime.launch import \
        launch_local

    argv = list(sys.argv[1:] if argv is None else argv)
    results = launch_local(args.ranks, argv, device=device(args),
                           timeout=RANK_TIMEOUT, module=module)
    for res in reversed(results):
        sys.stdout.write(res.stdout)
    return 0


def process_group(args):
    """This rank's ``(env, created)`` (:func:`..runtime.bootstrap.
    initialize` on the example's device: a gloo group that the caller made
    serves the card too)."""
    from distributed_deep_learning_tpu_torch.runtime import bootstrap

    return bootstrap.initialize(device(args))


def run_cli(argv: list[str]) -> None:
    """The port's training CLI in this process, on ``argv`` (as the JAX
    examples run theirs through ``runpy``)."""
    import runpy

    saved = sys.argv
    sys.argv = ["ddl", *argv]
    try:
        runpy.run_module("distributed_deep_learning_tpu_torch",
                         run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise
    finally:
        sys.argv = saved


def train_phase_ends(metrics_path):
    """The train-phase ``phase_end`` events of a ``--metrics-file`` JSONL,
    in order (shared by the CLI examples' asserts)."""
    events = [json.loads(line) for line in open(metrics_path)]
    return [e for e in events
            if e["event"] == "phase_end" and e.get("phase") == "train"]
