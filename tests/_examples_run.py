"""Shared by ``test_torch_examples*.py``: run the port's examples with
``--cpu`` as subprocesses, all at once."""

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_all(names, extra=(), timeout=240.0) -> dict:
    """``{name: (exit code, output, seconds)}`` of ``python -m
    distributed_deep_learning_tpu_torch.examples.<name> --cpu *extra``,
    every example started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("DDL_DATA_LIMIT", None)
    started = {}
    for name in names:
        started[name] = (time.monotonic(), subprocess.Popen(
            [sys.executable, "-m",
             f"distributed_deep_learning_tpu_torch.examples.{name}", "--cpu",
             *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    try:
        for name, (t0, proc) in started.items():
            text = proc.communicate(timeout=timeout)[0]
            out[name] = (proc.returncode, text, time.monotonic() - t0)
    finally:
        for _, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out
