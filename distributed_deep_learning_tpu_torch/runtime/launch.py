"""Local multi-process launcher: the port of
``distributed_deep_learning_tpu/runtime/launch.py`` (the reference's
``torch.multiprocessing.spawn`` over ``-r N``, ``CNN/main.py:202``).

``--spawn -r N`` starts N ``python -m distributed_deep_learning_tpu_torch``
processes with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` on loopback and a
free ``MASTER_PORT``), which :mod:`.bootstrap` reads.  On ``cuda`` each
rank takes one card, so N beyond the visible cards is refused.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Sequence

import torch

from distributed_deep_learning_tpu_torch.runtime.bootstrap import free_port


def launch_local(n_processes: int, argv: Sequence[str], *,
                 device: str = "cuda", timeout: float | None = None,
                 module: str = "distributed_deep_learning_tpu_torch"
                 ) -> list[subprocess.CompletedProcess]:
    """Run ``python -m <module> <argv>`` (the CLI by default; the
    sharded-state selftest is ``runtime.selftest``) as
    ``n_processes`` ranks; returns
    their CompletedProcess list in rank order, each with its stdout and
    stderr combined.  Raises ``ValueError`` for fewer than 2 ranks,
    ``RuntimeError`` for more ranks than cards on ``cuda`` or when any
    rank exits non-zero (with that rank's tail), and
    ``subprocess.TimeoutExpired`` after ``timeout`` seconds; every rank
    still running is killed before it raises."""
    if n_processes < 2:
        raise ValueError(f"--spawn needs -r N with N >= 2, got "
                         f"{n_processes}")
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if n_processes > cards:
            raise RuntimeError(f"--spawn -r {n_processes} on cuda needs "
                               f"{n_processes} cards, {cards} visible "
                               "(one rank per card)")
    port = str(free_port())
    procs: list[subprocess.Popen] = []
    outputs = [""] * n_processes

    def drain(rank: int) -> None:
        outputs[rank] = procs[rank].stdout.read()

    try:
        for rank in range(n_processes):
            env = dict(os.environ, RANK=str(rank),
                       WORLD_SIZE=str(n_processes), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(n_processes),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            env.setdefault("OMP_NUM_THREADS", "1")   # as torchrun sets it
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # drain every pipe at once: a rank blocked on a full pipe would
        # stall the collective its peers wait in
        drainers = [threading.Thread(target=drain, args=(r,), daemon=True)
                    for r in range(n_processes)]
        for t in drainers:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in procs:
            p.wait(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        for t in drainers:
            t.join(timeout=10)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [subprocess.CompletedProcess(p.args, p.returncode,
                                           stdout=outputs[r])
               for r, p in enumerate(procs)]
    bad = [(r, res) for r, res in enumerate(results) if res.returncode]
    if bad:
        tails = "\n---\n".join(f"rank {r} (exit {res.returncode}):\n"
                               f"{res.stdout[-2000:]}" for r, res in bad)
        raise RuntimeError(f"{len(bad)}/{n_processes} ranks failed:\n{tails}")
    return results
