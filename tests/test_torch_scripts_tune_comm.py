"""``scripts.autotune`` and ``scripts.comm_bench`` against the JAX
package's scripts, on the CPU.

* ``autotune --dry-run`` (``mlp``; ``gpt -l 2 -s 64``) prints JAX's
  record for the same device count (JAX's script on one CPU device); a
  real ``autotune mlp`` at world 1 writes an artifact that the training
  CLI's ``--plan`` replays.
* ``comm_bench`` over two gloo ranks: the wire bytes equal JAX's record
  on its 2-device CPU topology exactly, the ring collectives are bit-equal
  to the plain ones on integer-valued blocks (JAX's exactness gate) with
  JAX's relative errors for the quantized wires, and the explicit FSDP
  step's losses stay within JAX's limits of FSDP2's (``method="none"``
  to 1e-5, the int8 step still learning).
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from distributed_deep_learning_tpu_torch.scripts import autotune, comm_bench
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
COMM = ["--rows", "64", "--cols", "128", "--inner", "32", "--steps", "1"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue()
    return json.loads(text[text.index("{"):])


@pytest.mark.parametrize("argv", [["mlp"], ["gpt", "-l", "2", "-s", "64"],
                                  ["mlp", "--full-space", "-b", "16"]])
def test_dry_run_record_equals_jaxs(argv, monkeypatch):
    from distributed_deep_learning_tpu.workloads import base as jbase

    monkeypatch.setattr(jbase, "_devices", lambda config: jax.devices()[:1])
    theirs = _record(_jax_script("autotune").main,
                     argv + ["--dry-run", "-d", "cpu"])
    mine = _record(autotune.main, argv + ["--dry-run", "-d", "cpu"])
    assert mine == theirs and mine["n_candidates"] > 0


def test_search_writes_an_artifact_that_plan_replays(tmp_path, monkeypatch):
    from distributed_deep_learning_tpu_torch.__main__ import main as cli
    from distributed_deep_learning_tpu_torch.tune.artifact import load_plan

    monkeypatch.setenv("DDL_DATA_LIMIT", "128")
    out = tmp_path / "mlp.plan.json"
    rec = _record(autotune.main, ["mlp", "-d", "cpu", "-b", "32",
                                  "--trials", "2", "--trial-steps", "1",
                                  "--out", str(out)])
    assert rec["artifact"] == str(out) and out.exists()
    _, saved = load_plan(str(out))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, hist = cli(["mlp", "-d", "cpu", "-b", "32", "-e", "1",
                           "--plan", str(out)])
    assert f"plan {saved['plan_hash']} [" in buf.getvalue()
    assert f"applied from {out}" in buf.getvalue()
    assert hist and all(h.loss == h.loss for h in hist)


@pytest.fixture(scope="module")
def comm_records():
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "comm_bench.py"), *COMM],
                          capture_output=True, text=True, timeout=240,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = json.loads(proc.stdout[proc.stdout.index("{"):])
    mine = _record(comm_bench.main, COMM + ["--device", "cpu", "--ranks",
                                            "2"])
    return theirs, mine


def test_comm_bench_wire_bytes_equal_jaxs(comm_records):
    theirs, mine = comm_records
    assert mine["n_devices"] == theirs["n_devices"] == 2
    assert mine["bytes"] == theirs["bytes"]
    assert set(mine) - set(theirs) == {"device"}
    assert mine["device"] == "cpu"


def test_comm_bench_rings_are_exact(comm_records):
    theirs, mine = comm_records
    assert mine["numerics"] == theirs["numerics"]
    assert mine["numerics"]["ring_all_gather_exact"]
    assert mine["numerics"]["ring_reduce_scatter_exact"]


def test_comm_bench_fsdp_parity_within_jaxs_limits(comm_records):
    theirs, mine = comm_records
    losses = mine["parity"]["losses"]
    assert set(mine["parity"]) == set(theirs["parity"])
    for a, b in zip(losses["explicit_none"], losses["annotation"]):
        assert a == pytest.approx(b, rel=1e-5)
    assert losses["explicit_int8_ef"][-1] < losses["explicit_int8_ef"][0]
    assert set(mine["overlap"]) - set(theirs["overlap"]) == {"host_staged"}
    assert mine["overlap"]["host_staged"] is False   # CPU tensors
