"""The port's serving scripts against the JAX package's, on the CPU.

``scripts.serve_bench`` (slot engine and ``--paged``) runs in this
process on the argv that ``scripts/serve_bench.py`` runs on, the port's
bench building its model from the JAX bench's weights: the record's keys
are JAX's but for the ones listed below (ROADMAP.md §3, By design), its
deterministic fields equal JAX's, and every request's tokens equal
JAX's.  ``--obs`` writes a stream and a span trace with JAX's event and
span names; ``--buckets`` is refused with its reason.
``scripts.disagg_bench`` over the CPU twice gives the deterministic
fields of JAX's script on its 2-device CPU topology (a subprocess: the
script sets ``XLA_FLAGS`` before JAX starts).
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
import numpy as np
import pytest

from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.obs import trace as ttrace
from distributed_deep_learning_tpu_torch.scripts import disagg_bench
from distributed_deep_learning_tpu_torch.scripts import serve_bench
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]

MICRO = ["--layers", "1", "--d-model", "32", "--heads", "2", "--mlp-dim",
         "64", "--vocab", "61", "--max-len", "96"]
#: the SLOs far above the CPU's latencies: attainment is then the trace's
SLO = ["--slo-ttft-ms", "600000", "--slo-e2e-ms", "600000"]
ARGV = {"slot": MICRO + ["--requests", "5", "--prompt-max", "12",
                         "--new-max", "8"],
        "paged": MICRO + ["--paged", "--requests", "6", "--prompt-max",
                          "16", "--new-max", "8", "--shared-prefix-len",
                          "8", *SLO],
        "spec": MICRO[2:] + ["--layers", "2", "--paged", "--requests", "4", "--prompt-max", "12",
                         "--new-max", "8", "--shared-prefix-len", "4",
                         "--draft", "1", "--spec-k", "2", "--skip-v1",
                         *SLO]}

#: the record's keys that differ by design: JAX's compile counts and
#: prefill buckets (the port counts graph captures and has no buckets),
#: and what the port adds (its device, error count, weight drift, and the
#: engines' token, capture and launch counts)
ONLY_JAX = {
    "slot": {"engine.buckets", "engine.decode_compiles",
             "engine.prefill_compiles", "naive.compiles"},
    "paged": {"engine_v1.prefill_compiles", "paged_engine.chunk_compiles",
              "paged_engine.decode_compiles", "paged_engine.draft_compiles",
              "paged_engine.verify_compiles"}}
ONLY_PORT = {
    "slot": {"device", "errors", "weight_drift", "engine.decode_captures",
             "engine.generated_tokens", "engine.nonfinite_tokens",
             "engine.prefill_calls", "engine.total_seconds",
             "engine.weight_bytes"},
    "paged": {"decode_attention", "device", "weight_drift",
              "engine_v1.decode_captures", "engine_v1.decode_seconds",
              "engine_v1.decode_ticks", "engine_v1.errors",
              "engine_v1.generated_tokens", "engine_v1.kv_cache_bytes",
              "engine_v1.mean_slot_occupancy", "engine_v1.nonfinite_tokens",
              "engine_v1.prefill_calls", "engine_v1.total_seconds",
              "engine_v1.weight_bytes", "paged_engine.decode_captures",
              "paged_engine.draft_captures", "paged_engine.generated_tokens",
              "paged_engine.nonfinite_tokens",
              "paged_engine.paged_decode_launches",
              "paged_engine.total_seconds", "paged_engine.verify_captures",
              "paged_engine.weight_bytes"}}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_model(seed=0, device="cuda", **kw):
    """The port's bench model with the JAX bench's weights for ``seed``."""
    _, params = jbench.build_model(seed, **kw)
    model = ttr.CausalLM(**{**tbench.DEFAULT_MODEL, **kw})
    model.load_state_dict(ttr.load_flax_params(
        jax.tree.map(np.asarray, params)))
    return model.to(device).eval()


def _capture(mp, bench, tokens):
    """Record every engine run's tokens (in call order) of ``bench``."""
    for name in ("run_engine", "run_paged"):
        real = getattr(bench, name)

        def run(*a, _real=real, **kw):
            out = _real(*a, **kw)
            tokens.append({int(u): [int(t) for t in v]
                           for u, v in out["results"].items()})
            return out
        mp.setattr(bench, name, run)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    jsb = _jax_script("serve_bench")
    mp = pytest.MonkeyPatch()
    mp.setattr(tbench, "build_model", _port_model)
    out = {}
    try:
        for case, argv in ARGV.items():
            got = {}
            for side, main, bench, extra in (
                    ("jax", jsb.main, jbench, []),
                    ("port", serve_bench.main, tbench, ["--device", "cpu"])):
                tokens = []
                obs = ["--obs", "--obs-file", str(tmp / f"{side}-{case}.jsonl"),
                       "--obs-trace", str(tmp / f"{side}-{case}.json")] \
                    if case == "paged" else []
                with pytest.MonkeyPatch.context() as m2:
                    _capture(m2, bench, tokens)
                    got[side] = (_run(main, argv + obs + extra), tokens)
            out[case] = got
    finally:
        mp.undo()
    return out, tmp


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k not in ("model", "load", "latency"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("case", ["slot", "paged"])
def test_record_keys_are_jaxs_but_by_design(records, case):
    jax_rec, port_rec = (_flat(records[0][case][s][0])
                         for s in ("jax", "port"))
    assert set(jax_rec) - set(port_rec) == ONLY_JAX[case]
    assert set(port_rec) - set(jax_rec) == ONLY_PORT[case]


@pytest.mark.parametrize("case", list(ARGV))
def test_tokens_and_deterministic_fields_equal_jax(records, case):
    (jrec, jtok), (trec, ttok) = (records[0][case][s]
                                  for s in ("jax", "port"))
    assert jtok == ttok and jtok[0]          # every request's tokens
    for key in ("requests", "prompt_lens", "new_tokens", "max_slots",
                "model", "load", "kv_block_size", "prefill_chunk",
                "kv_dtype", "weight_dtype"):
        assert trec.get(key) == jrec.get(key), key
    if case == "slot":
        e, f = jrec["engine"], trec["engine"]
        assert f["decode_ticks"] == e["decode_ticks"]
        assert round(f["mean_slot_occupancy"], 3) == \
            e["mean_slot_occupancy"]
        assert trec["naive"]["wasted_fraction"] == pytest.approx(
            jrec["naive"]["wasted_fraction"])
        return
    e, f = jrec["paged_engine"], trec["paged_engine"]
    for key in ("prefill_chunks", "decode_ticks", "prefix_hit_rate",
                "slo_attainment", "spec_acceptance", "paged", "spec", "slo"):
        assert f[key] == e[key], key
    assert f["latency"]["measured_requests"] == \
        e["latency"]["measured_requests"]


def test_obs_writes_jaxs_events_and_spans(records):
    _, tmp = records
    names = {}
    for side in ("jax", "port"):
        events = [json.loads(line) for line in
                  (tmp / f"{side}-paged.jsonl").read_text().splitlines()]
        spans = ttrace.read_chrome_trace(str(tmp / f"{side}-paged.json"))
        names[side] = ({e["event"] for e in events},
                       sorted({s["name"] for s in spans}),
                       sum(s["name"] == "request" for s in spans))
    assert names["port"] == names["jax"]
    assert names["port"][2] == 6 and "obs_trace" in names["port"][0]


def test_buckets_are_refused_with_the_reason(capsys):
    with pytest.raises(SystemExit):
        serve_bench.main(["--device", "cpu", "--buckets", "8,16"])
    assert "has no prefill buckets" in capsys.readouterr().err


def test_serve_module_is_the_script():
    from distributed_deep_learning_tpu_torch.serve import __main__ as entry

    assert entry.main is serve_bench.main


def test_disagg_bench_equals_jaxs_script():
    argv = ["--requests", "6", "--max-slots", "4", "--kv-block-size", "8",
            "--prefill-chunk", "8", "--prefill-streams", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "disagg_bench.py"), *argv],
                          capture_output=True, text=True, timeout=240,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])
    mine = _run(disagg_bench.main, argv + ["--device", "cpu"])
    for key in ("prefill_workers", "decode_workers", "prefill_streams",
                "max_slots", "kv_block_size", "kv_dtype", "decode_passes",
                "errors", "wire_bytes_per_block", "int8_wire_shrink_x",
                "model", "load"):
        assert mine[key] == theirs[key], key
    assert mine["token_agreement"] == 1.0 == theirs["token_agreement"]
    for key in ("prefill_util", "prefill_chunk_calls"):
        assert mine["disagg"][key] == theirs["disagg"][key], key
    assert mine["device"] == "cpu"
