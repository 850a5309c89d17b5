"""The port's supervisor, admission control and engine seams against JAX's.

Both packages serve the same seeded trace on the same weights (a small
``gpt``, 2 layers of d 32 over a vocabulary of 64, carried across with
``load_flax_params``) under the same ``ChaosPlan``; the port runs on the
CPU, where its decode attention is the kernel's plain version.  What must
match exactly: the faults fired and where, the restarts, the detection
ticks, the requests lost, the ledger's contents and the errors; the
admission ladder's levels and sheds; the serving drill's record against
those runs (the drill's engine, trace and faults).  Both supervisors
read an injected clock and the stall kinds advance it, so nothing here
sleeps.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.obs.window import LiveSignals as JLive
from distributed_deep_learning_tpu.serve import admission as jadm
from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import supervisor as jsup
from distributed_deep_learning_tpu.utils import chaos as jchaos
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.obs.window import LiveSignals
from distributed_deep_learning_tpu_torch.serve import admission as tadm
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve import supervisor as tsup
from distributed_deep_learning_tpu_torch.serve.scheduler import Request
from distributed_deep_learning_tpu_torch.utils import chaos as tchaos
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)
#: the serving drill's engine and trace (``utils/chaos.py``), so that the
#: drill's record can be held against these JAX runs
ENGINE = dict(max_slots=4, max_len=48, kv_block_size=8, prefill_chunk=16)


class Clock:
    """An injected clock: every reading advances it 1 ms, ``sleep``
    advances it without sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t

    def sleep(self, dt):
        self.t += dt


@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(1), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _engines(kind="paged"):
    """One engine a package for the whole file: reset, swap and canary
    must reuse it (JAX: its compiled programs; the port: its tick)."""
    jm, params, tm = _models()
    if kind == "slot":
        return (jeng.ServeEngine(jm, params, max_slots=4),
                teng.ServeEngine(tm, device="cpu", max_slots=4,
                                 max_len=MODEL["max_len"]))
    return (jeng.PagedEngine(jm, params, **ENGINE),
            teng.PagedEngine(tm, device="cpu", **ENGINE))


def _traces(n=8, seed=0):
    kw = dict(vocab_size=MODEL["vocab_size"], seed=seed,
              prompt_lens=(4, 12), new_tokens=(6, 14))
    return jbench.make_trace(n, **kw), tbench.make_trace(n, **kw)


def _tokens(out):
    return {uid: np.asarray(t).tolist() for uid, t in out["results"].items()}


def _both(events, monkeypatch, kind="paged", **sup_kw):
    """The same plan under each package's supervisor; returns the two
    outputs and the two plans."""
    jt, tt = _traces()
    outs, plans = [], []
    for pkg_chaos, sup, eng, trace in (
            (jchaos, jsup, _engines(kind)[0], jt),
            (tchaos, tsup, _engines(kind)[1], tt)):
        clock = Clock()
        if pkg_chaos is jchaos:
            monkeypatch.setattr(time, "sleep", clock.sleep)
            plan = pkg_chaos.ChaosPlan(
                [pkg_chaos.ChaosEvent(**e) for e in events], seed=0)
        else:
            plan = pkg_chaos.ChaosPlan(
                [pkg_chaos.ChaosEvent(**e) for e in events], seed=0,
                sleep=clock.sleep)
        outs.append(sup.ServeSupervisor(eng, chaos=plan, clock=clock,
                                        **sup_kw).run(list(trace)))
        monkeypatch.undo()
        plans.append(plan)
    return outs, plans


@functools.lru_cache(maxsize=None)
def _references(kind):
    """Each package's fault-free supervised tokens on ``kind``'s engine."""
    (jref, tref), _ = _both([], pytest.MonkeyPatch(), kind)
    return jref, tref


def _detection(out, plan):
    fault = out["stats"]["faults"][0]
    return fault["tick"] - plan.fired[0][0]


#: the serving drill's faults: kind -> (supervisor options, the fault)
FAULTS = {"engine_crash": ({}, "EngineCrash"),
          "nan_logits": ({}, "TickAnomaly"),
          "corrupt_block": ({}, "TickAnomaly"),
          "stalled_tick": ({"stall_timeout_s": 0.1}, "TickStall")}


def _event(kind):
    return {"step": 5, "kind": kind,
            "magnitude": 0.3 if kind == "stalled_tick" else 0.0}


@functools.lru_cache(maxsize=None)
def _faulted(kind, engine):
    (jout, tout), (jplan, tplan) = _both([_event(kind)], pytest.MonkeyPatch(),
                                         engine, **FAULTS[kind][0])
    return jout, tout, jplan, tplan


@pytest.mark.parametrize("kind", sorted(FAULTS))
@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_fault_replay_matches_jax(kind, engine):
    expect = FAULTS[kind][1]
    jout, tout, jplan, tplan = _faulted(kind, engine)
    jref, tref = _references(engine)
    js, ts = jout["stats"], tout["stats"]
    assert tplan.fired == jplan.fired and tplan.fired
    assert [f["kind"] for f in ts["faults"]] == \
        [f["kind"] for f in js["faults"]] == [expect]
    assert _detection(tout, tplan) == _detection(jout, jplan)
    for key in ("restarts", "requests_lost", "completed", "errored",
                "ticks", "deadline_misses"):
        assert ts[key] == js[key], key
    assert ts["restarts"] == 1 and ts["requests_lost"] == 0
    assert tout["errors"] == jout["errors"] == {}
    # the ledger: every committed token, the fault-free run's and JAX's
    assert _tokens(tout) == _tokens(jout) == _tokens(tref) == _tokens(jref)
    assert ts["engine"]["decode_captures"] == 0     # the CPU: never captured


@pytest.mark.parametrize("sup_kw,prefix", [
    ({"deadline_ms": 1e-6}, "deadline:"), ({"retries": 0}, "retries:")],
    ids=["deadline", "retries"])
def test_deadline_and_retry_budget_match_jax(sup_kw, prefix, monkeypatch):
    (jout, tout), _ = _both([{"step": 2, "kind": "engine_crash"}],
                            monkeypatch, **sup_kw)
    assert set(tout["errors"]) == set(jout["errors"]) and tout["errors"]
    assert all(m.startswith(prefix) for m in tout["errors"].values())
    for key in ("restarts", "requests_lost", "completed", "errored"):
        assert tout["stats"][key] == jout["stats"][key], key
    assert _tokens(tout) == _tokens(jout)


def test_ledger_matches_jax():
    """Commit, retirement on EOS and budget, snapshot and truncate: the
    same sequence through both ledgers."""
    rng = np.random.default_rng(3)
    reqs = [Request(u, rng.integers(1, 9, 4).astype(np.int32), 5)
            for u in range(4)]
    ledgers = (jsup.RequestLedger(eos_id=7), tsup.RequestLedger(eos_id=7))
    for led in ledgers:
        for r in reqs:
            led.add(r)
    snap = None
    for step, tok in enumerate(rng.integers(1, 9, 40)):
        uid = step % 4
        got = [led.commit(uid, int(tok)) for led in ledgers]
        assert got[0] == got[1]
        if step == 10:
            snap = [led.snapshot() for led in ledgers]
            assert snap[0] == snap[1]
    dropped = [led.truncate(s) for led, s in zip(ledgers, snap)]
    assert dropped[0] == dropped[1] > 0
    for a, b in zip(ledgers[0].entries.values(),
                    ledgers[1].entries.values()):
        assert (a.committed, a.retired) == (b.committed, b.retired)
    assert {u: v.tolist() for u, v in ledgers[0].results().items()} == \
        {u: v.tolist() for u, v in ledgers[1].results().items()}


def _feed(adm, live, signals):
    for now, itl, depth in signals:
        if itl is not None:
            live.observe_itl(itl, now=now)
        adm.observe(live, depth, now=now)
    return adm


def test_admission_ladder_matches_jax():
    """The same live signals into both controllers: the same levels,
    the same knob projections and the same sheds."""
    rng = np.random.default_rng(5)
    itls = (0.001, 0.5, None)     # fast, slow, no token this tick
    signals = [(1.0 + 0.5 * k, itls[int(rng.integers(0, 3))],
                int(rng.integers(0, 80))) for k in range(60)]
    kw = dict(itl_p99_ms=10.0, max_queue_depth=64, patience=2, cool=3)
    jc = _feed(jadm.AdmissionController(**kw), JLive(window_s=5.0),
               signals)
    tc = _feed(tadm.AdmissionController(**kw), LiveSignals(window_s=5.0),
               signals)
    assert tc.level_changes == jc.level_changes and tc.level_changes
    reqs = [Request(u, np.ones(3, np.int32), 2, priority=u % 3)
            for u in range(9)]
    for depth in (0, 63, 65, 999):
        assert [tc.should_shed(r, depth) for r in reqs] == \
            [jc.should_shed(r, depth) for r in reqs]
    assert tc.stats() == jc.stats()


def test_admission_sheds_on_the_engine_as_jax():
    """A hard queue cap under a burst on both engines: the same requests
    shed with the same messages, the rest served identically; priority 0
    never shed."""
    jm, params, tm = _models()
    rng = np.random.default_rng(7)
    reqs = [Request(0, rng.integers(1, 64, 5).astype(np.int32), 6,
                    arrival_tick=0, priority=0)]
    reqs += [Request(u, rng.integers(1, 64, 5).astype(np.int32), 4,
                     arrival_tick=1, priority=1) for u in range(1, 8)]
    kw = dict(max_queue_depth=2, shed_priority=1)
    jout = jeng.PagedEngine(jm, params, max_slots=2, kv_block_size=8,
                            prefill_chunk=8).run(
        list(reqs), admission=jadm.AdmissionController(**kw))
    tout = teng.PagedEngine(tm, device="cpu", max_slots=2, kv_block_size=8,
                            prefill_chunk=8).run(
        list(reqs), admission=tadm.AdmissionController(**kw))
    assert tout["errors"] == jout["errors"] and tout["errors"]
    assert 0 not in tout["errors"]
    assert _tokens(tout) == _tokens(jout)


def test_reset_keeps_the_tick_and_zeroes_the_pools():
    _, _, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", **ENGINE)
    _, tt = _traces(3)
    first = eng.run(list(tt))
    assert any(bool(layer["cached_valid"].any()) for layer in eng.pools)
    pools = [layer["cached_key"].data_ptr() for layer in eng.pools]
    eng.reset()
    assert pools == [layer["cached_key"].data_ptr() for layer in eng.pools]
    assert not any(bool(layer["cached_valid"].any()) for layer in eng.pools)
    assert eng.manager.stats()["indexed_blocks"] == 0
    again = eng.run(list(tt))
    assert _tokens(again) == _tokens(first)
    assert again["stats"]["restarts"] == 1


def test_swap_params_copies_in_place_and_checks_geometry():
    _, params, tm = _models()
    eng = teng.PagedEngine(tm, device="cpu", **ENGINE)
    live = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    new = {k: torch.zeros_like(v)
           for k, v in eng.model.state_dict().items()}
    eng.swap_params(new)
    assert {k: v.data_ptr() for k, v in eng.model.state_dict().items()} \
        == live
    assert all(not v.any() for v in eng.model.state_dict().values())
    bad = dict(new)
    k0 = next(iter(bad))
    bad[k0] = torch.zeros(3)
    with pytest.raises(ValueError, match="hot swap requires identical"):
        eng.swap_params(bad)
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params(dict(list(new.items())[1:]))
    # restore the carried weights for the rest of the file
    eng.swap_params(ttr.load_flax_params(params))


def test_serve_drill_matches_jax():
    """The serving drill on this file's weights: its fault scenarios are
    the runs above (its engine, trace and faults), and its record holds
    what JAX's supervisor did in them: the faults fired, the detection
    ticks, the restarts, zero lost and the fault-free tokens.  Its swap
    section holds JAX's drill's verdicts (promote, roll back, reject)."""
    trec = tchaos.run_serve_resilience_drill(0, "cpu", model=_models()[2],
                                             clock=Clock())
    assert trec["drill_passed"], trec
    jref = _references("paged")[0]
    for kind in FAULTS:
        jout, _, jplan, _ = _faulted(kind, "paged")
        ts = trec["scenarios"][kind]
        assert ts["fired"] == jplan.fired
        assert ts["detection_ticks"] == _detection(jout, jplan)
        assert ts["restarts"] == jout["stats"]["restarts"] == 1
        assert ts["requests_lost"] == jout["stats"]["requests_lost"] == 0
        assert ts["bit_identical"] == (_tokens(jout) == _tokens(jref))
    sw = trec["swap"]
    assert (sw["promote"]["swaps"], sw["promote"]["rollbacks"]) == (1, 0)
    assert (sw["rollback"]["swaps"], sw["rollback"]["rollbacks"],
            sw["rollback"]["restarts"]) == (0, 1, 1)
    assert (sw["reject"]["rejected"], sw["reject"]["swaps"]) == (1, 0)
    assert sw["reject"]["torn_publish_invisible"]
    assert trec["requests_lost_total"] == 0
