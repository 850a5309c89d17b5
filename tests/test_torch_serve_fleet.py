"""The port's fleet router, priority preemption and the fleet CLI against
JAX's.

Three replicas a package serve the same seeded shared-prefix trace with a
priority mix, on the same weights (a small ``gpt``, 2 layers of d 32 over
a vocabulary of 64, carried across from JAX), under the same
``ChaosPlan``.  What must match exactly: the tokens, the faults fired and
where, the health states, the rounds, the routing placements and the
predicted hits; preemption's victims and resumes, and the spilled KV's
round trip (host and device paths, f32 and int8 pools) bit-exact against
uncontended runs; the fleet drill's record against those runs (the
drill's replicas, trace and faults); and the CLI's parse-time checks,
with JAX's messages.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import fleet as jfleet
from distributed_deep_learning_tpu.serve import load as jload
from distributed_deep_learning_tpu.serve import paged as jpaged
from distributed_deep_learning_tpu.serve import supervisor as jsup
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import fleet as tfleet
from distributed_deep_learning_tpu_torch.serve import load as tload
from distributed_deep_learning_tpu_torch.serve import paged as tpaged
from distributed_deep_learning_tpu_torch.serve import supervisor as tsup
from distributed_deep_learning_tpu_torch.utils import chaos as tchaos
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)
#: the fleet drill's replicas, trace and faults (``utils/chaos.py``), so
#: that the drill's record can be held against these JAX runs
ENGINE = dict(max_slots=4, max_len=48, kv_block_size=8, prefill_chunk=16)
LOAD = dict(n_requests=14, arrival="poisson", rate=2.0,
            prompt_short=(4, 12), prompt_long=(16, 24), long_frac=0.25,
            shared_prefix_len=16, shared_frac=0.5, new_tokens=(6, 14),
            slo_ttft_ms=30000.0, slo_e2e_ms=30000.0,
            priority_classes=((0, 0.25), (1, 0.5), (2, 0.25)))


@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(4), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _fleets():
    """Three replicas a package, reused by every fleet test (a crashed
    replica is warm-reset by the router)."""
    jm, params, tm = _models()
    return ([jeng.PagedEngine(jm, params, **ENGINE) for _ in range(3)],
            [teng.PagedEngine(tm, device="cpu", **ENGINE)
             for _ in range(3)])


def _traces():
    return (jload.make_load(jload.LoadSpec(**LOAD), MODEL["vocab_size"], 0),
            tload.make_load(tload.LoadSpec(**LOAD), MODEL["vocab_size"], 0))


def _tokens(out):
    return {uid: np.asarray(t).tolist() for uid, t in out["results"].items()}


def _plans(events):
    return (jchaos.ChaosPlan([jchaos.ChaosEvent(**e) for e in events]),
            tchaos.ChaosPlan([tchaos.ChaosEvent(**e) for e in events]))


FLEET_CASES = {
    "clean": ([], {}),
    "replica_crash": ([{"step": 3, "kind": "replica_crash", "target": 1}],
                      {}),
    "replica_straggler": ([{"step": 2, "kind": "replica_straggler",
                            "target": 2, "magnitude": 5.0}],
                          {"slow_tick_s": 1.0, "degrade_after": 1}),
    "router_flake": ([{"step": 1, "kind": "router_flake",
                       "magnitude": 6.0}], {}),
}


@functools.lru_cache(maxsize=None)
def _jax_fleet(case):
    """JAX's fleet on ``case``, run once (its engines warm from the
    clean run before): the output and the faults fired."""
    if case != "clean":
        _jax_fleet("clean")
    events, kw = FLEET_CASES[case]
    jplan = _plans(events)[0]
    return jfleet.FleetRouter(_fleets()[0], chaos=jplan, **kw).run(
        _traces()[0]), jplan.fired


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_matches_jax(case):
    events, kw = FLEET_CASES[case]
    tplan, tt = _plans(events)[1], _traces()[1]
    jout, jfired = _jax_fleet(case)
    tout = tfleet.FleetRouter(_fleets()[1], chaos=tplan, **kw).run(tt)
    js, ts = jout["stats"], tout["stats"]
    assert tplan.fired == jfired
    assert bool(tplan.fired) == bool(events)
    assert ts["health"] == js["health"]
    for key in ("rounds", "requests", "completed", "errored",
                "requests_lost"):
        assert ts[key] == js[key], key
    assert ts["requests_lost"] == 0 and tout["errors"] == {}
    assert ts["routing"] == js["routing"]
    assert [(f["replica"], f["kind"], f["tick"], f["round"])
            for f in ts["faults"]] == \
        [(f["replica"], f["kind"], f["tick"], f["round"])
         for f in js["faults"]]
    for rid, jr in js["per_replica"].items():
        tr = ts["per_replica"][rid]
        for key in ("health", "ticks", "slow_ticks", "crashes",
                    "placements", "restarts"):
            assert tr[key] == jr[key], (rid, key)
        assert tr["decode_captures"] == 0          # the CPU
    assert ts["slo"]["by_priority"].keys() == js["slo"]["by_priority"]\
        .keys()
    assert _tokens(tout) == _tokens(jout)


def test_predict_shared_len_and_summary_match_jax():
    rng = np.random.default_rng(0)
    stream = rng.integers(1, 64, 30)
    mgrs = (jpaged.BlockManager(16, 4, 2, 8), tpaged.BlockManager(16, 4, 2,
                                                                  8))
    for m in mgrs:
        m.admit(0, m.match_prefix(stream), 30)
        m.register_committed(0, stream, 21)
    assert mgrs[0].prefix_summary() == mgrs[1].prefix_summary()
    for n in (0, 5, 9, 17, 22, 30):
        probe = np.concatenate([stream[:n], rng.integers(1, 64, 6)])
        assert tpaged.predict_shared_len(mgrs[1].prefix_summary(), probe,
                                         4) == jpaged.predict_shared_len(
            mgrs[0].prefix_summary(), probe, 4)
    # adopt, unadopt and flush keep both managers' books equal
    other = rng.integers(1, 64, 17)
    got = [m.adopt_prefix(other, 4) for m in mgrs]
    assert got[0] == got[1] and got[1][1]
    assert [m.unadopt(got[1][1]) for m in mgrs] == [4, 4]
    assert [m.flush_index() for m in mgrs] == [5, 5]
    for m in mgrs:
        m.release(0)
    assert mgrs[0].stats() == mgrs[1].stats()
    assert sorted(mgrs[0].free) == sorted(mgrs[1].free)


def _preempt_reqs():
    return tchaos.preemption_requests(MODEL["vocab_size"], 0)


@functools.lru_cache(maxsize=None)
def _solo(kv_dtype=None):
    """Each preemption request served alone (the port's)."""
    _, _, tm = _models()
    out = {}
    for r in _preempt_reqs():
        eng = teng.PagedEngine(tm, device="cpu", max_slots=2, max_len=48,
                               kv_block_size=8, prefill_chunk=8,
                               kv_dtype=kv_dtype)
        out[r.uid] = eng.run([tsup.Request(
            uid=r.uid, prompt=r.prompt,
            max_new_tokens=r.max_new_tokens)])["results"][r.uid].tolist()
    return out


@functools.lru_cache(maxsize=None)
def _jax_preempted(kv_dtype):
    jm, params, _ = _models()
    return jeng.PagedEngine(
        jm, params, max_slots=2, max_len=48, kv_block_size=8,
        prefill_chunk=8, preempt=True, kv_dtype=kv_dtype).run(
        [jsup.Request(uid=r.uid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens,
                      arrival_tick=r.arrival_tick, priority=r.priority)
         for r in _preempt_reqs()], keep_timeline=True)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("migrate", ["host", "device"])
def test_preemption_matches_jax_and_round_trips_exactly(migrate, kv_dtype,
                                                        tmp_path):
    """The 2-slot priority-pressure trace: the same victims, spills and
    resumes as JAX's engine (host path), and every output equal to its
    uncontended run: the spilled slot returns bit-exactly, through pinned
    host memory or a tensor on the device, f32 or int8 pools."""
    _, _, tm = _models()
    kw = dict(max_slots=2, max_len=48, kv_block_size=8, prefill_chunk=8,
              preempt=True, kv_dtype=kv_dtype)
    spill = str(tmp_path / "spill") if migrate == "host" else None
    tout = teng.PagedEngine(tm, device="cpu", migrate=migrate,
                            spill_dir=spill, **kw).run(
        _preempt_reqs(), keep_timeline=True)
    jout = _jax_preempted(kv_dtype)
    ps, js = tout["stats"]["preempt"], jout["stats"]["preempt"]
    for key in ("preemptions", "resumes", "still_spilled"):
        assert ps[key] == js[key], key
    assert ps["preemptions"] > 0 and ps["still_spilled"] == 0
    assert [(e["preempted"], e["resumed"]) for e in tout["timeline"]] == \
        [(e["preempted"], e["resumed"]) for e in jout["timeline"]]
    if kv_dtype is None:
        # (int8 KV: the two packages' quantized decodes part at a near-tie
        # of this trace's request 1, uncontended as much as preempted;
        # test_torch_serve_quant holds their int8 parity)
        assert _tokens(tout) == _tokens(jout)
    assert _tokens(tout) == _solo(kv_dtype)
    assert ps["spill_path"] == migrate
    assert (ps["migration_moves"] > 0) == (migrate == "device")
    if spill is not None:
        assert len(os.listdir(spill)) == ps["preemptions"]


@functools.lru_cache(maxsize=None)
def _jax_migrate_drop():
    """JAX's device-path spill with its first transfer corrupted, under
    its supervisor (the fleet drill's scenario): the output and the
    faults fired."""
    jm, params, _ = _models()
    jplan = _plans([{"step": 1, "kind": "migrate_drop"}])[0]
    jengine = jeng.PagedEngine(jm, params, max_slots=2, max_len=48,
                               kv_block_size=8, prefill_chunk=8,
                               preempt=True, migrate="device")
    jengine._migrate_chaos = jplan.migrate_corruptor()
    return jsup.ServeSupervisor(jengine, retries=2).run(
        [jsup.Request(uid=r.uid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens,
                      arrival_tick=r.arrival_tick, priority=r.priority)
         for r in _preempt_reqs()]), jplan.fired


def test_migrate_drop_trips_the_digest_and_replays_as_jax():
    _, _, tm = _models()
    tplan = _plans([{"step": 1, "kind": "migrate_drop"}])[1]
    tengine = teng.PagedEngine(tm, device="cpu", max_slots=2, max_len=48,
                               kv_block_size=8, prefill_chunk=8,
                               preempt=True, migrate="device")
    tengine._migrate_chaos = tplan.migrate_corruptor()
    jout, jfired = _jax_migrate_drop()
    tout = tsup.ServeSupervisor(tengine, retries=2).run(_preempt_reqs())
    assert tplan.fired == jfired
    assert [f["kind"] for f in tout["stats"]["faults"]] == \
        [f["kind"] for f in jout["stats"]["faults"]] == ["MigrationError"]
    assert tout["stats"]["restarts"] == jout["stats"]["restarts"]
    assert tout["stats"]["requests_lost"] == 0
    assert _tokens(tout) == _tokens(jout) == _solo()


def test_fleet_drill_matches_jax():
    """The fleet drill on this file's weights: its crash, straggler,
    flake, preemption and ``migrate_drop`` scenarios are the runs above,
    and its record holds what JAX's fleet did in them (the JAX drill
    builds nine engines of its own, minutes of compiling here)."""
    trec = tchaos.run_fleet_resilience_drill(0, "cpu", model=_models()[2])
    assert trec["drill_passed"], trec
    sc = trec["scenarios"]
    names = {"replica_crash": "replica_crash",
             "replica_straggler": "replica_straggler",
             "router_flake": "router_flake"}
    for name, case in names.items():
        jout, jfired = _jax_fleet(case)
        js = jout["stats"]
        assert sc[name]["fired"] == jfired
        assert sc[name]["requests_lost"] == js["requests_lost"] == 0
        for key in ("health", "rounds"):
            if key in sc[name]:
                assert sc[name][key] == js[key], (name, key)
    crash = _jax_fleet("replica_crash")
    assert sc["replica_crash"]["detection_ticks"] == \
        crash[0]["stats"]["faults"][0]["tick"] - crash[1][0][0]
    assert sc["replica_straggler"]["slow_ticks"] == _jax_fleet(
        "replica_straggler")[0]["stats"]["per_replica"][2]["slow_ticks"]
    assert sc["router_flake"]["flake_degraded"] == _jax_fleet(
        "router_flake")[0]["stats"]["routing"]["flake_degraded"]
    jp = _jax_preempted(None)
    assert (sc["preemption"]["preemptions"], sc["preemption"]["resumes"],
            sc["preemption"]["preempted_uids"]) == (
        jp["stats"]["preempt"]["preemptions"],
        jp["stats"]["preempt"]["resumes"],
        [u for ev in jp["timeline"] for u in ev["preempted"]])
    jm_out, jm_fired = _jax_migrate_drop()
    assert sc["migrate_drop"]["fired"] == jm_fired
    assert sc["migrate_drop"]["faults"] == [
        f["kind"] for f in jm_out["stats"]["faults"]]
    assert sc["migrate_drop"]["restarts"] == jm_out["stats"]["restarts"]
    jref = _jax_fleet("clean")[0]["stats"]["slo"]
    assert trec["slo_by_priority"] == {
        p: v["slo_attainment"] for p, v in jref["by_priority"].items()}


BAD_FLAGS = [
    ["--replicas", "0"], ["--replicas", "3"], ["--priority-classes",
                                               "0=1.0"],
    ["--paged", "--priority-classes", "0=0.25,1=0.5"],
    ["--paged", "--priority-classes", "x=0.5,1=0.5"],
    ["--paged", "--priority-classes", "0=0.5,0=0.5"],
    ["--paged", "--priority-classes", "0=zz,1=1.0"],
    ["--paged", "--priority-classes", "0"],
    ["--spill-dir", "/tmp/sp"], ["--publish-weights", "/tmp/pub"],
    ["--autoscale", "min=1,max=4"],
    ["--paged", "--replicas", "3", "--autoscale", "depth=4"],
    ["--paged", "--replicas", "3", "--autoscale", "min=1,min=2"],
    ["--paged", "--replicas", "3", "--autoscale", "min=zz"],
    ["--paged", "--replicas", "3", "--autoscale", "min=0"],
    ["--paged", "--replicas", "3", "--autoscale", "min=4,max=2"],
    ["--evacuate-on", "degraded"], ["--serve-deadline-ms", "0"],
    ["--serve-retries", "-1"], ["--canary-slots", "-1"],
    ["--serve", "--reload-watch", "w", "--canary-slots", "8"],
    ["--serve", "--admission", "bogus=1"],
    ["--serve", "--admission", "depth=0"],
    ["--serve", "--admission", "depth=zz"],
    ["--serve", "--admission", "depth=4,depth=5"],
    ["--admission", "depth=4"], ["--reload-watch", "w"],
]


@pytest.mark.parametrize("argv", BAD_FLAGS, ids=" ".join)
def test_bad_fleet_flags_raise_jax_parse_messages(argv):
    base = ["-l", "1", "-s", "32", "-e", "1", "-b", "16"]
    with pytest.raises(SystemExit) as theirs:
        jconfig.parse_args(base + argv, workload="gpt")
    with pytest.raises(SystemExit) as mine:
        tconfig.parse_args(base + argv, workload="gpt")
    assert str(mine.value) == str(theirs.value)


def test_fleet_flags_parse_as_jax():
    argv = ["--serve", "--paged", "--replicas", "3", "--priority-classes",
            "0=0.25,1=0.5,2=0.25", "--spill-dir", "/tmp/sp",
            "--checkpoint-dir", "/tmp/ck", "--publish-weights", "/tmp/pub",
            "--autoscale", "min=1,max=4,patience=2,cool=3", "--evacuate-on",
            "hotspot", "--serve-deadline-ms", "500", "--serve-retries",
            "3", "--reload-watch", "w", "--canary-slots", "1",
            "--admission", "depth=16,itl-p99-ms=200,shed-priority=2",
            "--migrate", "host"]
    mine, theirs = (tconfig.parse_args(argv, "gpt"),
                    jconfig.parse_args(argv, "gpt"))
    for field in ("replicas", "priority_classes", "spill_dir",
                  "publish_weights", "autoscale", "evacuate_on",
                  "serve_deadline_ms", "serve_retries", "reload_watch",
                  "canary_slots", "admission", "migrate"):
        assert getattr(mine, field) == getattr(theirs, field), field
    for flag in (["--disagg"], ["--prefill-workers", "2"],
                 ["--pool-elastic"]):
        with pytest.raises(SystemExit) as theirs_exit:
            jconfig.parse_args(flag, "gpt")
        with pytest.raises(SystemExit, match="disagg") as mine_exit:
            tconfig.parse_args(flag, "gpt")
        assert str(mine_exit.value) == str(theirs_exit.value)
