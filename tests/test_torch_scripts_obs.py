"""``scripts.obs_report`` against ``scripts/obs_report.py``, on the CPU.

Two telemetry streams, each with its span trace: one written by the JAX
serving bench's ``--obs`` run, one by the port's ``scripts.serve_bench
--obs`` run on the same argv.  For each stream and each mode (the
default report, ``--phases``, ``--prom``, ``--trace``, ``--window``,
``--memory``) the port's text is the JAX script's, character for
character, and so is the exit code.  A stream without the events a mode
reads prints the JAX script's own ``n/a`` or "no ... events" form.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from distributed_deep_learning_tpu_torch.scripts import obs_report
from distributed_deep_learning_tpu_torch.scripts import serve_bench
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--layers", "1", "--d-model", "32", "--heads", "2", "--mlp-dim",
        "64", "--vocab", "61", "--max-len", "96", "--paged", "--requests",
        "6", "--prompt-max", "16", "--new-max", "8", "--shared-prefix-len",
        "8", "--skip-v1"]
MODES = [[], ["--phases"], ["--prom"], ["--trace"], ["--window"],
         ["--memory"]]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    out = {}
    for side, main, extra in (
            ("jax", _jax_script("serve_bench").main, []),
            ("port", serve_bench.main, ["--device", "cpu"])):
        events, trace = tmp / f"{side}.jsonl", tmp / f"{side}_trace.json"
        rc, _ = _out(main, ARGV + extra + ["--obs", "--obs-file",
                                           str(events), "--obs-trace",
                                           str(trace)])
        assert rc == 0
        out[side] = str(events)
    # a stream of no serving run: the modes' empty forms
    empty = tmp / "empty.jsonl"
    empty.write_text(json.dumps({"event": "obs_goodput", "t": 1.0,
                                 "scope": "run", "wall_seconds": 2.0,
                                 "steps": 3, "seconds": {"productive": 1.5},
                                 "fractions": {"productive": 0.75}})
                     + "\n")
    out["empty"] = str(empty)
    return out


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m[0] if m else "report")
@pytest.mark.parametrize("stream", ["jax", "port", "empty"])
def test_report_text_equals_jaxs(streams, stream, mode):
    jax_main = _jax_script("obs_report").main
    theirs = _out(jax_main, [streams[stream], *mode])
    mine = _out(obs_report.main, [streams[stream], *mode])
    assert mine == theirs
    if stream != "empty":
        assert mine[0] == 0 and mine[1].strip()


def test_port_stream_reports_its_requests(streams):
    _, text = _out(obs_report.main, [streams["port"], "--trace"])
    assert text.startswith("== span trace (") and \
        ", 6 request traces) ==" in text.splitlines()[0]
    _, text = _out(obs_report.main, [streams["port"]])
    assert "MFU             n/a" in text and "requests 6" in text
