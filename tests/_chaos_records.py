"""Shared by ``test_torch_scripts_chaos*.py``: run a ``chaos_drill``
scenario through the JAX script and through the port's, and the record
fields that may differ by design (times and the sentinel's time
overhead, checkpoint file names, compile counts that the port counts as
graph captures)."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _timed(key: str) -> bool:
    last = key.rsplit(".", 1)[-1]
    return last.endswith(("_s", "seconds", "_ms_mean", "seconds_max",
                          "overhead_frac")) or last.startswith("recovery")


#: JAX's compile counts and the port's graph captures (0 on the CPU):
#: different counts by design (ROADMAP.md §3)
COUNTS = ("decode_compiles", "chunk_compiles", "decode_captures")


def comparable(record: dict) -> dict:
    """The record's fields that do not depend on the clock; the checkpoint
    file names of ``quarantined`` and the compile or capture counts
    aside."""
    return {key: value for key, value in _flat(record).items()
            if not (_timed(key) or key == "quarantined"
                    or any(c in key for c in COUNTS))}


def jax_record(scenario: str, monkeypatch) -> tuple[int, dict]:
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_drill", ROOT / "scripts" / "chaos_drill.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["chaos_drill.py", "--scenario",
                                      scenario])
    return _run(mod.main)


def port_record(scenario: str) -> tuple[int, dict]:
    from distributed_deep_learning_tpu_torch.scripts import chaos_drill

    return _run(chaos_drill.main, ["--scenario", scenario, "--device",
                                   "cpu"])


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(*args)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])
