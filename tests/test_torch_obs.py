"""The port's observability stack against the JAX package's.

Driven by the same calls under the same fake clock, the event stream
(with rotation), the Prometheus exposition, the timeline's goodput, the
tracer's Chrome trace and the flight recorder's dump are equal to JAX's,
byte for byte or key for key, and the MFU record is JAX's for the same
step FLOPs, seconds and peak.  A served trace with telemetry, a tracer
and a recorder leaves JAX's span tree, recorder events and metrics.  The
FLOP counter counts a ``gpt`` step's products as an analytic count does,
flash and dense alike.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu import obs as jobs
from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.obs import export as jexport
from distributed_deep_learning_tpu.obs import memory as jmemory
from distributed_deep_learning_tpu.obs import mfu as jmfu
from distributed_deep_learning_tpu.obs import recorder as jrecorder
from distributed_deep_learning_tpu.obs import trace as jtrace
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import load as jload
from distributed_deep_learning_tpu.utils import profiling as jprof
from distributed_deep_learning_tpu_torch import obs as tobs
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.obs import export as texport
from distributed_deep_learning_tpu_torch.obs import memory as tmemory
from distributed_deep_learning_tpu_torch.obs import mfu as tmfu
from distributed_deep_learning_tpu_torch.obs import recorder as trecorder
from distributed_deep_learning_tpu_torch.obs import trace as ttrace
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import load as tload
from distributed_deep_learning_tpu_torch.utils import bench_records
from distributed_deep_learning_tpu_torch.utils import profiling as tprof
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=64, num_heads=4,
             mlp_dim=128, max_len=64)
ENGINE = dict(max_slots=4, kv_block_size=8, prefill_chunk=8, max_len=64)
LOAD = dict(n_requests=8, arrival="poisson", rate=1.5,
            prompt_short=(3, 10), prompt_long=(14, 24), long_frac=0.3,
            shared_prefix_len=12, shared_frac=0.6, new_tokens=(2, 8),
            slo_ttft_ms=0.001, slo_e2e_ms=60000.0)


class FakeClock:
    def __init__(self, step=0.25):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _both(fn):
    """``fn(package)`` for JAX's modules and the port's."""
    return (fn(dict(export=jexport, recorder=jrecorder, trace=jtrace,
                    obs=jobs, mfu=jmfu)),
            fn(dict(export=texport, recorder=trecorder, trace=ttrace,
                    obs=tobs, mfu=tmfu)))


def _files(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_event_stream_and_rotation_equal_jax(tmp_path):
    def run(m):
        d = tmp_path / m["export"].__name__.split(".")[0]
        d.mkdir()
        w = m["export"].EventWriter(str(d / "ev.jsonl"), clock=FakeClock(),
                                    max_bytes=300, keep=2,
                                    fsync_on_rollover=True)
        for i in range(12):
            w.emit("obs_step", i=i, loss=float("nan") if i == 3 else i / 7,
                   arr=np.arange(3) * i, f32=np.float32(i) / 3)
        w.close()
        rotated = list(m["export"].read_rotated(str(d / "ev.jsonl")))
        return _files(d), rotated, w.rollovers

    (jf, jr, jn), (tf, tr, tn) = _both(run)
    assert jf == tf and jr == tr and jn == tn > 0


def test_prometheus_text_equals_jax():
    def run(m):
        tel = m["obs"].RunTelemetry(path=None, clock=FakeClock())
        reg = tel.registry
        reg.counter("comm_bytes", op="all_gather", method="int8").inc(4096)
        reg.counter("elastic_restarts", cause="RuntimeError").inc()
        reg.gauge("serve_queue_depth").set(3)
        h = reg.histogram("serve_ttft_seconds")
        for v in (0.001, 0.02, 0.3, 0.3, 4.0):
            h.observe(v)
        snap = reg.snapshot()
        return snap, m["export"].prometheus_text(snap)

    j, t = _both(run)
    assert j == t


def test_timeline_goodput_equals_jax():
    def run(m):
        tel = m["obs"].RunTelemetry(path=None, clock=FakeClock(0.5))
        tl = tel.timeline
        for kind in ("compile", "dispatch", "dispatch", "data_wait"):
            tl.add(kind, 0.75)
            tl.step()
        mark = tl.snapshot()
        with tl.span("checkpoint"):
            pass
        tl.add("device_sync", 2.0)
        with tl.span("recovery"):
            pass
        return tl.goodput(), tl.goodput(since=mark), tel.dispatch_kind(run)

    j, t = _both(run)
    assert j == t


def test_tracer_chrome_trace_equals_jax(tmp_path):
    def run(m):
        tr = m["trace"].Tracer(clock=FakeClock(), capacity=8)
        root = tr.begin("request", m["trace"].request_trace_id(3),
                        track="req3", prompt_len=7)
        a = tr.add("admit", 1.0, 1.5, "req-3", parent=root, track="req3",
                   slot=0)
        tr.add("prefix_match", 1.0, 1.5, "req-3", parent=a, hit=True)
        with tr.span("decode_tick", "engine", track="engine", slots=2):
            pass
        for i in range(8):                  # past the capacity: drops
            tr.add("decode", 2.0 + i, 2.5 + i, "req-3", parent=root)
        tr.end(root, t1=20.0)
        path = tmp_path / (m["trace"].__name__.split(".")[0] + ".json")
        n = tr.export(str(path))
        return (n, tr.dropped, path.read_bytes(),
                m["trace"].read_chrome_trace(str(path)))

    j, t = _both(run)
    assert j == t


def test_flight_recorder_dump_equals_jax(tmp_path):
    def run(m):
        rec = m["recorder"].FlightRecorder(capacity=4, clock=None)
        path = tmp_path / m["recorder"].__name__.split(".")[0] / "bb.json"
        path.parent.mkdir()
        rec.arm(str(path))
        for i in range(6):
            rec.record("kv_evict", freed=i, need=2)
        rec.record("slo_breach", uid=4, which="ttft", measured_ms=12.5,
                   slo_ms=10.0)
        out = rec.trip("slo_breach")
        return (os.path.basename(out), rec.dropped, path.read_bytes(),
                m["recorder"].FlightRecorder.read(str(path)))

    j, t = _both(run)
    assert j == t


@pytest.mark.parametrize("peak", [None, 2.5e14])
def test_mfu_record_equals_jax(peak, monkeypatch):
    monkeypatch.setenv("DDL_OBS_PEAK_FLOPS", "1e12")
    for flops, steps, secs in ((3.2e9, 40, 2.0), (None, 4, 1.0),
                               (1e9, 0, 0.0)):
        assert tmfu.mfu_record(flops, steps, secs, 1, "cpu", peak) == \
            jmfu.mfu_record(flops, steps, secs, 1, "cpu", peak)


def test_h100_peak_table(monkeypatch):
    monkeypatch.delenv("DDL_OBS_PEAK_FLOPS", raising=False)
    assert tmfu.chip_peak_flops_sourced("NVIDIA H100 80GB HBM3") == \
        (989.4e12, "table")
    assert tmfu.chip_peak_flops("NVIDIA H100 PCIe") == 756.5e12
    assert tmfu.chip_peak_flops("NVIDIA H100 NVL") == 835.5e12
    assert tmfu.chip_peak_flops("cpu") is None
    assert tmfu.chip_peak_flops("TPU v5 lite") is None   # no TPU figures
    monkeypatch.setenv("DDL_OBS_PEAK_FLOPS", "5e13")
    assert tmfu.chip_peak_flops_sourced("cpu") == (5e13, "env_override")


def test_run_telemetry_summary_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_OBS_PEAK_FLOPS", "1e12")

    def run(m):
        d = tmp_path / m["obs"].__name__.split(".")[0]
        d.mkdir()
        tel = m["obs"].RunTelemetry(str(d / "ev.jsonl"), clock=FakeClock(),
                                    trace_path=str(d / "tr.json"))
        tel.step_flops, tel.n_devices = 2.0e9, 1
        tel.timeline.add("dispatch", 0.5)
        tel.timeline.step()
        gp = tel.phase_rollup("train_epoch_1")
        tel.note_train(gp["steps"], gp["wall_seconds"], 32)
        summary = tel.close()
        assert tel.close() == {}
        return summary, [json.loads(line) for line in
                         (d / "ev.jsonl").read_text().splitlines()]

    (js, jev), (ts, tev) = _both(run)
    js["trace"].pop("path"), ts["trace"].pop("path")
    for e in jev + tev:
        e.pop("path", None)
    assert js == ts and jev == tev


# --- a served trace under telemetry, tracer and recorder ------------------

@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(11), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm


def _shape(spans):
    """Each span's name, trace id, parent's name and attributes (times
    and ids excepted), in order."""
    by_id = {s["args"]["span_id"]: s for s in spans}
    out = []
    for s in spans:
        a = dict(s["args"])
        parent = by_id.get(a.pop("parent_id", None))
        a.pop("span_id")
        out.append((s["name"], a.pop("trace_id"),
                    parent["name"] if parent else None,
                    json.dumps(a, sort_keys=True)))
    return out


@functools.lru_cache(maxsize=None)
def _served(tmp):
    jm, params, tm = _models()
    out = {}
    for name, eng, load in (
            ("jax", lambda: jeng.PagedEngine(jm, params, **ENGINE), jload),
            ("port", lambda: teng.PagedEngine(tm, device="cpu", **ENGINE),
             tload)):
        trace = load.make_load(load.LoadSpec(**LOAD), MODEL["vocab_size"], 0)
        rec = (jrecorder if name == "jax" else trecorder).FlightRecorder()
        rec.arm(os.path.join(tmp, f"{name}_bb.json"))
        tel = (jobs if name == "jax" else tobs).RunTelemetry(
            os.path.join(tmp, f"{name}.jsonl"),
            trace_path=os.path.join(tmp, f"{name}_trace.json"), recorder=rec)
        res = eng().run(trace, telemetry=tel)
        tel.close()
        events = [json.loads(line) for line in
                  open(os.path.join(tmp, f"{name}.jsonl"))]
        spans = (jtrace if name == "jax" else ttrace).read_chrome_trace(
            os.path.join(tmp, f"{name}_trace.json"))
        out[name] = (res, rec, events, spans, tel.registry.snapshot())
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _served(str(tmp_path_factory.mktemp("served")))


def test_served_tokens_and_spans_equal_jax(served):
    (jres, _, _, jsp, _), (tres, _, _, tsp, _) = served["jax"], \
        served["port"]
    assert {u: list(v) for u, v in jres["results"].items()} == \
        {u: [int(t) for t in v] for u, v in tres["results"].items()}
    assert _shape(tsp) == _shape(jsp)
    assert {s["name"] for s in tsp} >= {
        "request", "queued", "admit", "prefix_match", "prefill_chunk",
        "decode_tick", "decode", "retire"}


def test_served_recorder_and_metrics_equal_jax(served):
    (_, jrec, jev, _, jsnap), (_, trec, tev, _, tsnap) = served["jax"], \
        served["port"]
    timing = ("t", "measured_ms")
    strip = [[{k: v for k, v in e.items() if k not in timing}
              for e in r.events] for r in (jrec, trec)]
    assert strip[0] == strip[1]
    assert trec.trips == jrec.trips == ["slo_breach"]
    assert [e["event"] for e in tev] == [e["event"] for e in jev] or \
        [e["event"] for e in tev if e["event"] != "obs_window"] == \
        [e["event"] for e in jev if e["event"] != "obs_window"]
    assert set(tsnap["gauges"]) == set(jsnap["gauges"])
    for k in ("serve_kv_blocks_in_use", "serve_prefix_hit_rate"):
        assert tsnap["gauges"][k] == jsnap["gauges"][k], k
    for k, h in jsnap["histograms"].items():
        assert tsnap["histograms"][k]["count"] == h["count"], k
    assert tsnap["histograms"]["serve_chunks_per_tick"] == \
        jsnap["histograms"]["serve_chunks_per_tick"]


# --- FLOP accounting, memory, profiling ------------------------------------

def _gpt_step(attention):
    from distributed_deep_learning_tpu_torch.ops.attention import \
        make_attention_fn
    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns

    torch.manual_seed(0)
    kw = {} if attention == "dense" else dict(
        attention=make_attention_fn(causal=True))
    model = ttr.CausalLM(**MODEL, with_logits=True, **kw)
    state = create_train_state(model, 0, Optimizer("adamw", 1e-3),
                               device="cpu")
    step, _ = make_step_fns(TokenCrossEntropy())
    g = np.random.default_rng(0)
    x = torch.as_tensor(g.integers(1, MODEL["vocab_size"], (2, 32)))
    return step, state, x, torch.roll(x, -1, 1)


def _analytic_step_flops(B, T):
    """The step's products: forward 2·(params in products)·tokens plus
    attention's Q·Kᵀ and P·V, backward twice the forward."""
    d, L, V, f = (MODEL["d_model"], MODEL["num_layers"],
                  MODEL["vocab_size"], MODEL["mlp_dim"])
    per_layer = 2 * B * T * (4 * d * d + 2 * d * f) + 4 * B * T * T * d
    fwd = L * per_layer + 2 * B * T * d * V
    return 3 * fwd


def test_step_flops_are_analytic_and_flash_equals_dense():
    counts = {}
    for attention in ("dense", "flash"):
        step, state, x, y = _gpt_step(attention)
        counts[attention], (counted, m) = tmfu.measure_step_flops(
            step, state, x, y)
        step, state, x, y = _gpt_step(attention)
        plain, m0 = step(state, x, y)
        assert torch.equal(m["loss"], m0["loss"])
        for (k, v), w in zip(counted.model.state_dict().items(),
                             plain.model.state_dict().values()):
            assert torch.equal(v, w), k     # the counter changes nothing
    want = _analytic_step_flops(2, 32)
    assert counts["dense"] == pytest.approx(want, rel=1e-9)
    assert counts["flash"] == pytest.approx(counts["dense"], rel=0.01)
    assert tprof.cost_analysis(lambda: _gpt_step("flash")[0](
        *_gpt_step("flash")[1:]))["flops"] == pytest.approx(want, rel=1e-9)


def test_memory_helpers():
    step, state, x, y = _gpt_step("dense")
    rows = tmemory.top_leaves(state, n=3)
    assert [r["bytes"] for r in rows] == sorted(
        (r["bytes"] for r in rows), reverse=True)
    assert rows[0]["path"].startswith(".model[")
    assert tmemory.pytree_bytes(state.model) == sum(
        t.numel() * t.element_size()
        for t in state.model.state_dict().values())
    assert tmemory.is_oom_error(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert not tmemory.is_oom_error(ValueError("shape"))
    tracker = tmemory.MemoryTracker(tobs.MetricsRegistry(),
                                    device=torch.device("cpu"), every=2)
    for _ in range(4):
        tracker.on_step()
    assert not tracker.enabled and tracker.samples == 0
    assert tprof.memory_analysis(step, state, x, y, device="cpu") == {}
    fields = {"argument_size_in_bytes": 10, "output_size_in_bytes": 4,
              "temp_size_in_bytes": 7, "alias_size_in_bytes": 0,
              "memory_fields_missing": ["alias_size_in_bytes"]}
    for donated in (None, 8, 10 ** 9):
        assert tmemory.buffer_attribution(fields, donated_bytes=donated) == \
            jmemory.buffer_attribution(fields, donated_bytes=donated)
    rec = trecorder.FlightRecorder()
    assert tmemory.record_oom_postmortem(
        rec, error=torch.cuda.OutOfMemoryError("out of memory"),
        top_buffers=rows)
    assert rec.trips == ["oom_postmortem"]


def test_profiling_helpers(tmp_path):
    jt, tt = jprof.StepTimer(2, clock=FakeClock()), \
        tprof.StepTimer(2, clock=FakeClock())
    for t in (jt, tt):
        for n in (8, 8, 16, 16):
            t.tick(n)
    assert tt.summary() == jt.summary() and tt.measured_steps == 2
    for fn in (tprof.hlo_text, tprof.compiled_text):
        with pytest.raises(NotImplementedError, match="By design"):
            fn(len, [])
    with tprof.trace(str(tmp_path / "prof")), tprof.annotate("region"):
        torch.ones(8).sum()
    assert os.path.exists(tprof.trace_file(str(tmp_path / "prof")))
    out = tprof.measure_async_overlap(torch.ones(64, 64).matmul,
                                      torch.ones(64, 64))
    assert set(out) == {"dispatch_s", "total_s", "overlap_fraction"}


def test_bench_records_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("DDL_TORCH_BENCH_RECORDS", str(tmp_path / "r.json"))
    assert bench_records.read_flash_speedup() is None
    bench_records.record_flash_speedup(1.23456)
    bench_records.record_flash_blocks(64, 32)
    assert bench_records.read_flash_speedup() == 1.2346
    assert bench_records.read_flash_blocks() == (64, 32)
    assert all(k.startswith("cuda:") for k in bench_records.read_records())


def test_overhead_benches_have_jax_keys():
    from distributed_deep_learning_tpu_torch.obs import bench as tbench

    kw = dict(steps=4, repeats=1, dim=16, depth=2, batch=8, device="cpu")
    a = tbench.overhead_bench(**kw)
    b = tbench.trace_overhead_bench(**kw)
    mine = {"device", "per_step_overhead_us_quartiles"}
    assert set(a) - mine == {
        "metric", "steps", "repeats", "step_geometry", "steps_per_sec_off",
        "steps_per_sec_on", "obs_overhead_fraction", "per_step_overhead_us"}
    assert b["steps_per_sec_plain"] > 0 and b["steps_per_sec_traced"] > 0
    for rec in (a, b):
        q = rec["per_step_overhead_us_quartiles"]
        assert len(q) == 3 and q == sorted(q)


def test_step_flops_against_jax_cost_analysis(capsys):
    """XLA's cost model of JAX's step on the same model counts the
    products and the elementwise work (softmax, norms, AdamW); the port's
    counter the products only: a little less, never more."""
    import functools as ft

    import optax

    from distributed_deep_learning_tpu.runtime.mesh import build_mesh
    from distributed_deep_learning_tpu.train.objectives import \
        token_cross_entropy
    from distributed_deep_learning_tpu.train.state import create_train_state
    from distributed_deep_learning_tpu.train.step import make_step_fns

    jm = jtr.CausalLM(**MODEL)
    x = jnp.asarray(np.random.default_rng(0).integers(
        1, MODEL["vocab_size"], (2, 32)), jnp.int32)
    state = create_train_state(jm, jax.random.key(0), x, optax.adamw(1e-3))
    step, _ = make_step_fns(build_mesh({"data": 1}, jax.devices()[:1]),
                            ft.partial(token_cross_entropy))
    xla = jprof.cost_analysis(step, state, x, jnp.roll(x, -1, 1))["flops"]
    mine = _analytic_step_flops(2, 32)
    with capsys.disabled():
        print(f"\nstep FLOPs: port {mine}, XLA's CPU cost_analysis {xla:.0f}"
              f", ratio {mine / xla:.4f}")
    assert 0.8 * xla <= mine <= xla
