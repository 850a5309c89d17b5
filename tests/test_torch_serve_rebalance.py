"""The port's KV migration, slot evacuation and autoscaling against JAX's.

``BlockMigrator`` at rest must round-trip f32, bf16 and int8+scales pools
bit-exactly, and a payload corrupted in flight must raise before anything
is scattered.  A cloned prefix and an evacuated slot move the same blocks
as JAX's on the same weights (the drills' small ``gpt``, carried across
from JAX); the autoscaler and the hot-spot detector decide as
JAX's on the same signals; and the rebalance drill (evacuation, its
rollback under ``evac_drop``, a target crashing mid-move, the
autoscaler's grow and drain, ``scale_thrash``) matches JAX's record.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.serve import autoscaler as jauto
from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import migrate as jmig
from distributed_deep_learning_tpu.serve import rebalance as jreb
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.obs.metrics import MetricsRegistry
from distributed_deep_learning_tpu_torch.serve import autoscaler as tauto
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import migrate as tmig
from distributed_deep_learning_tpu_torch.serve import paged as tpaged
from distributed_deep_learning_tpu_torch.serve import rebalance as treb
from distributed_deep_learning_tpu_torch.utils import chaos as tchaos
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

def _tokens(out):
    return {uid: np.asarray(t).tolist() for uid, t in out["results"].items()}


def _pools(kv_dtype, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    pools = tpaged.build_pools(2, 9, 4, 2, 8, dtype=dtype, device="cpu",
                               kv_dtype=kv_dtype)
    for layer in pools:
        for t in layer.values():
            for x in ((t.q, t.s) if hasattr(t, "q") else (t,)):
                if x.dtype == torch.bool:
                    x.copy_(torch.rand(x.shape, generator=g) > 0.3)
                elif x.dtype == torch.int8:
                    x.copy_(torch.randint(-127, 128, x.shape, generator=g))
                else:
                    x.copy_(torch.randn(x.shape, generator=g).to(x.dtype))
    return pools


def _leaves(pools, ids):
    return [x[ids].clone() for layer in pools for t in layer.values()
            for x in ((t.q, t.s) if hasattr(t, "q") else (t,))]


@pytest.mark.parametrize("kv_dtype,dtype", [
    (None, torch.float32), (None, torch.bfloat16), ("bf16", torch.float32),
    ("int8", torch.float32)], ids=["f32", "bf16", "bf16_kv", "int8"])
def test_migrator_at_rest_round_trip_is_bit_exact(kv_dtype, dtype):
    src, dst = _pools(kv_dtype, dtype, 0), _pools(kv_dtype, dtype, 1)
    reg = MetricsRegistry()
    mig = tmig.BlockMigrator(4, registry=reg)
    before = _leaves(dst, [1, 2, 6, 7, 8])
    out = mig.migrate(src, dst, [3, 5, 8], [4, 3, 5], verify=True)
    assert out is dst
    for a, b in zip(_leaves(src, [3, 5, 8]), _leaves(dst, [4, 3, 5])):
        assert torch.equal(a, b)
    for a, b in zip(before, _leaves(dst, [1, 2, 6, 7, 8])):
        assert torch.equal(a, b)                # only the targets moved
    snap = reg.snapshot()
    assert snap["counters"]["comm_bytes{method=none,op=kv_migrate}"] == \
        mig.stats.wire_bytes > 0
    assert mig.stats.as_dict()["verified"] == 1


def test_registry_snapshots_merge_as_jax():
    """The migrator's counters land in a registry whose snapshots merge
    as JAX's: counters add, gauges keep the later value, histograms add
    bucket-wise (and refuse other bounds)."""
    from distributed_deep_learning_tpu.obs import metrics as jmetrics
    from distributed_deep_learning_tpu_torch.obs import metrics as tmetrics

    snaps = []
    for mod in (jmetrics, tmetrics):
        a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
        for reg, k in ((a, 1.0), (b, 2.0)):
            reg.counter("comm_bytes", op="kv_migrate").inc(100 * k)
            reg.gauge("depth").set(k)
            for v in (1e-4 * k, 3e-3, 0.2 / k):
                reg.histogram("serve_migration_s").observe(v)
        snaps.append(mod.merge_snapshots(a.snapshot(), b.snapshot()))
        bad = mod.MetricsRegistry()
        bad.histogram("serve_migration_s", lo=1e-3).observe(1.0)
        with pytest.raises(ValueError, match="bounds"):
            mod.merge_snapshots(a.snapshot(), bad.snapshot())
    assert snaps[0] == snaps[1]
    h = tmetrics.Histogram.from_dict(snaps[1]["histograms"][
        "serve_migration_s"])
    assert h.count == 6 and h.to_dict() == snaps[1]["histograms"][
        "serve_migration_s"]


def test_int8_wire_is_lossy_within_a_step_and_smaller():
    src, dst = _pools(None, torch.float32, 0), _pools(None, torch.float32, 1)
    at_rest = tmig.BlockMigrator(3)
    wire = tmig.BlockMigrator(3, wire="int8")
    copy = _pools(None, torch.float32, 1)
    at_rest.migrate(src, copy, [1, 2], [1, 2])
    wire.migrate(src, dst, [1, 2], [1, 2])
    assert wire.stats.wire_bytes < at_rest.stats.wire_bytes / 2
    for a, b in zip(_leaves(dst, [1, 2]), _leaves(copy, [1, 2])):
        if a.is_floating_point():
            step = b.abs().amax() / 127
            assert float((a - b).abs().max()) <= float(step)
        else:
            assert torch.equal(a, b)


def test_corrupted_payload_raises_before_any_scatter():
    src, dst = _pools("int8", seed=0), _pools("int8", seed=1)
    plan = tchaos.ChaosPlan([tchaos.ChaosEvent(step=1, kind="evac_drop")])
    before = _leaves(dst, list(range(9)))
    with pytest.raises(tmig.MigrationError, match="digest mismatch"):
        tmig.BlockMigrator(4).migrate(src, dst, [1, 2], [3, 4], verify=True,
                                      chaos=plan.evac_corruptor())
    for a, b in zip(before, _leaves(dst, list(range(9)))):
        assert torch.equal(a, b)
    assert plan.fired == [(1, "evac_drop")]
    with pytest.raises(ValueError, match="exceeds migrator width"):
        tmig.BlockMigrator(1).migrate(src, dst, [1, 2], [3, 4])


def test_clone_prefix_and_evacuate_slot_match_jax():
    """A prefix prefilled on one engine is cloned into another, and a
    request's committed blocks are evacuated: the same blocks and tokens
    move as in JAX, and the destination serves the same tokens."""
    _, _, kw, jengines, tm = _drill_fleet()
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, tm.vocab_size, 27).astype(np.int64)
    req = jbench.Request(uid=0, prompt=prompt, max_new_tokens=6)
    moved = []
    for a, b, mig, reb, clone in (
            (*jengines[:2], jmig.BlockMigrator(jengines[0].blocks_per_slot),
             jreb, jmig.clone_prefix),
            (*(teng.PagedEngine(tm, device="cpu", **kw) for _ in range(2)),
             tmig.BlockMigrator(jengines[0].blocks_per_slot), treb,
             tmig.clone_prefix)):
        a.reset()
        b.reset()
        first = a.run([req])
        n = clone(a, b, prompt, mig)
        second = b.run([req])
        # the committed stream (prompt and the first 3 tokens) evacuated
        # back into the first engine after a reset
        a.reset()
        rec = reb.evacuate_slot(b, a, np.concatenate(
            [prompt, first["results"][0][:3]]), mig)
        moved.append((n, rec["blocks"], rec["tokens"], rec["ok"],
                      second["stats"]["paged"]["shared_tokens"],
                      _tokens(first), _tokens(second)))
    assert moved[0] == moved[1]
    assert moved[1][0] > 0 and moved[1][1] > 0


def test_autoscaler_and_hotspot_match_jax():
    rng = np.random.default_rng(9)
    kw = dict(min_replicas=1, max_replicas=4, patience=2, cool=2,
              grow_itl_p99_s=0.5)
    ja, ta = jauto.FleetAutoscaler(**kw), tauto.FleetAutoscaler(**kw)
    n = 2
    for _ in range(80):
        sig = {"queue_depth": float(rng.choice([0, 3, 20])),
               "occupancy": float(rng.random()),
               "itl_p99_s": float(rng.random())}
        acts = (ja.observe(sig, n), ta.observe(sig, n))
        assert acts[0] == acts[1]
        n += {"grow": 1, "shrink": -1}.get(acts[1], 0)
    assert ta.events == ja.events and ta.events
    assert ta.stats() == ja.stats()
    jh, th = jreb.HotspotDetector(), treb.HotspotDetector()
    for k in range(200):
        rid = k % 3
        dt = float(rng.random()) * (5.0 if rid == 2 and k > 90 else 1.0)
        assert jh.observe(rid, dt) == th.observe(rid, dt)
    assert th.detections == jh.detections


@functools.lru_cache(maxsize=None)
def _drill_fleet():
    """JAX's drill model and three of its engines at the drill's
    geometry, and the port's model on the same weights: built once, the
    engines reset by each user."""
    jm, params = jbench.build_model(0, **tchaos.DRILL_MODEL)
    cap = jbench.paged_max_len(jm.max_len, 8, False, 0)
    kw = dict(max_slots=4, max_len=cap, kv_block_size=8, prefill_chunk=16)
    tm = ttr.CausalLM(**tchaos.DRILL_MODEL)
    tm.load_state_dict(ttr.load_flax_params(jax.tree.map(np.asarray,
                                                         params)))
    engines = [jeng.PagedEngine(jm, params, **kw) for _ in range(3)]
    return jm, params, kw, engines, tm.eval()


def _jax_rebalance_scenarios():
    """JAX's rebalance drill, its f32 scenarios, on one warm fleet of its
    engines (the drill's geometry, weights, trace and plans): the record
    the port's drill must reproduce.  (JAX's drill builds a fresh fleet
    for every section, about half a minute of compiling on the CPU.)"""
    from distributed_deep_learning_tpu.serve import fleet as jfleet
    from distributed_deep_learning_tpu.serve.load import LoadSpec, make_load

    jm, params, kw, engines, _ = _drill_fleet()
    for e in engines:
        e.reset()

    def engine():
        return jeng.PagedEngine(jm, params, **kw)

    spec = LoadSpec(n_requests=14, arrival="poisson", rate=2.0,
                    prompt_short=(4, 12), prompt_long=(16, 24),
                    long_frac=0.25, shared_prefix_len=16, shared_frac=0.5,
                    new_tokens=(6, 14), slo_ttft_ms=30000.0,
                    slo_e2e_ms=30000.0,
                    priority_classes=jbench.DEFAULT_PRIORITY_CLASSES)
    trace = make_load(spec, vocab_size=jm.vocab_size, seed=0)
    ref = jfleet.FleetRouter(engines).run(list(trace))
    evac_kw = dict(slow_tick_s=1.0, degrade_after=1, evacuate_on="degraded")

    def plan(extra=(), target=2):
        return jchaos.ChaosPlan([jchaos.ChaosEvent(
            step=2, kind="replica_straggler", target=target,
            magnitude=5.0), *extra], seed=0)

    out = {}
    for name, p in (("evacuation_fp32", plan()),
                    ("evac_drop", plan([jchaos.ChaosEvent(
                        step=1, kind="evac_drop")], target=None)),
                    ("target_crash_mid_evac", plan([jchaos.ChaosEvent(
                        step=1, kind="target_crash_mid_evac")],
                        target=None))):
        got = jfleet.FleetRouter(engines, chaos=p, **evac_kw).run(
            list(trace))
        rb = got["stats"]["rebalance"]
        out[name] = {"fired": list(p.fired),
                     "health": dict(got["stats"]["health"]),
                     "requests_lost": got["stats"]["requests_lost"],
                     "bit_identical": _tokens(got) == _tokens(ref),
                     **{k: rb[k] for k in (
                         "evacuations", "evacuated_slots",
                         "evacuated_blocks", "evacuated_tokens",
                         "rolled_back", "aborted")}}
    auto = jauto.FleetAutoscaler(min_replicas=3, max_replicas=4, patience=2,
                                 cool=2)
    rt = jfleet.FleetRouter(engines, autoscaler=auto, engine_factory=engine)
    for override in ("hot", "hot", "cold", "cold"):
        rt._autoscale_round(override=override)
    got = rt.run(list(trace))
    out["autoscaler_drain"] = {
        "scale_events": got["stats"]["autoscaler"]["scale_events"],
        "replicas_retired": got["stats"]["autoscaler"]["replicas_retired"],
        "requests_lost": got["stats"]["requests_lost"],
        "bit_identical": _tokens(got) == _tokens(ref)}
    return params, out


def test_rebalance_drill_matches_jax():
    """The rebalance drill on JAX's drill weights and trace: evacuation
    over f32 (and int8, against the port's own int8 reference) pools,
    ``evac_drop``, a target crashing mid-move and the autoscaler's grow
    and drain — the same faults fired, health states, evacuated blocks
    and tokens, rollbacks, aborts and scale events as JAX's fleet in the
    same scenarios; ``scale_thrash`` (host decisions, held against JAX's
    by ``test_autoscaler_and_hotspot_match_jax``) as the drill asks."""
    _, jrec = _jax_rebalance_scenarios()
    trec = tchaos.run_rebalance_drill(0, "cpu", model=_drill_fleet()[4])
    assert trec["drill_passed"], trec
    compared = 0
    for name, js in jrec.items():
        ts = trec["scenarios"][name]
        for key in sorted(set(js) & set(ts)):
            assert ts[key] == js[key], (name, key)
            compared += 1
    assert compared >= 20
    assert trec["scenarios"]["evacuation_int8"]["passed"]
    th = trec["scenarios"]["scale_thrash"]
    assert th["passed"] and th["scale_events"] == 0 and th["fired"]
