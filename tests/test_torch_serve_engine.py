"""The port's slot engine and ``generate()`` against the JAX package's.

Both packages serve the same seeded ``make_trace`` on the same weights,
carried across with ``load_flax_params``; the port runs on the CPU, where
its decode tick runs eagerly (``decode_captures == 0``; the CUDA graph is
checked on the card by ``chip_smoke.py``).  Greedy tokens must be
identical and the scheduling counters equal.  In bf16 a stream may part
where the two frameworks' roundings flip an argmax between two near-equal
logits: there the logits of both, on the same tokens, must agree within
2e-2 of max|logit| (the limit of ``tests/test_torch_bf16.py``) and the two
picks must lie within that limit of each other (:func:`_same_or_tie`).
Also: the port's engine equals its own ``generate()`` token for token,
EOS retirement reuses slots, an invalid request does not abort the batch,
a free slot's position is clamped into its row, and the slot and paged
engines agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.serve import cache as tcache
from distributed_deep_learning_tpu_torch.serve import engine as teng
from distributed_deep_learning_tpu_torch.serve.scheduler import Request
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)


@functools.lru_cache(maxsize=None)
def _models(bf16=False, **kw):
    """The JAX model, its params and the port's model on them; ``bf16``:
    both compute in bf16 over f32 parameters."""
    jm = jtr.CausalLM(**MODEL, **kw,
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    params = jm.init(jax.random.key(1), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL, **kw,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm.eval()


def _same_or_tie(jm, params, tm, prompt, got, want, bf16):
    """``got`` equals ``want``, or (bf16 only) parts from it first where
    the JAX logits of the two picks are within 2e-2 of max|logit|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.flatnonzero(got != want)
    if not bf16 or not diff.size:
        np.testing.assert_array_equal(got, want)
        return
    j = diff[0]
    seq = np.concatenate([prompt, want[:j]])[None].astype(np.int32)
    jl = np.asarray(jm.clone(with_logits=True).apply(
        {"params": params}, jnp.asarray(seq)))[0, -1]
    with torch.no_grad():
        tl = tm.logits_from(tm(torch.from_numpy(seq).long()))[0, -1]
    tol = 2e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=tol)
    assert abs(jl[got[j]] - jl[want[j]]) <= tol, (j, got[j], want[j])


def _trace(n=7, seed=0, plens=(3, 20), new=(1, 12), stagger=3,
           pad_inside=False):
    reqs = jbench.make_trace(n, vocab_size=MODEL["vocab_size"], seed=seed,
                             prompt_lens=plens, new_tokens=new,
                             stagger=stagger)
    if pad_inside:
        # pad id 0 inside two prompts: masked through cached_valid
        reqs[1].prompt[1] = 0
        reqs[4].prompt[len(reqs[4].prompt) // 2] = 0
    return reqs


def _free_slot_past_max_len():
    """Request 0 fills its row to the last position and retires while
    request 1, arriving later, keeps decoding: slot 0's position runs
    past max_len (16) while it is free."""
    return [Request(0, np.arange(1, 11, dtype=np.int32), 6),
            Request(1, np.arange(5, 7, dtype=np.int32), 14, arrival_tick=4)]


CASES = {
    "learned": ({}, {}),
    "rope_gqa": ({"pos_embedding": "rope", "num_kv_heads": 2}, {}),
    "window": ({"attention_window": 5}, {}),
    "pad_inside_prompt": ({}, {"pad_inside": True}),
    "bf16": ({"bf16": True}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine(case):
    model_kw, trace_kw = CASES[case]
    jm, params, tm = _models(**model_kw)
    trace = _trace(**trace_kw)
    jout = jeng.ServeEngine(jm, params, max_slots=3).run(trace)
    tout = teng.ServeEngine(tm, device="cpu", max_slots=3).run(trace)
    assert jout["errors"] == tout["errors"] == {}
    assert sorted(jout["results"]) == sorted(tout["results"])
    for r in trace:
        _same_or_tie(jm, params, tm, r.prompt, tout["results"][r.uid],
                     jout["results"][r.uid], model_kw.get("bf16", False))
    js, ts = jout["stats"], tout["stats"]
    for key in ("decode_ticks", "generated_tokens", "mean_slot_occupancy",
                "prefill_calls", "requests"):
        assert ts[key] == js[key], key
    assert ts["decode_captures"] == 0 and ts["nonfinite_tokens"] == 0


def test_free_slot_position_is_clamped_into_its_row():
    jm, params, tm = _models()
    trace = _free_slot_past_max_len()
    jout = jeng.ServeEngine(jm, params, max_slots=2, max_len=16).run(trace)
    eng = teng.ServeEngine(tm, device="cpu", max_slots=2, max_len=16)
    tout = eng.run(trace)
    for uid, toks in jout["results"].items():
        np.testing.assert_array_equal(tout["results"][uid], toks)
    assert eng.slots["index"][0] > 16            # slot 0 ran on while free
    assert tcache.tick_positions(eng.slots).max() == 15


def _check_parity(tm, out, reqs):
    for r in reqs:
        ref = ttr.generate(tm, torch.from_numpy(r.prompt)[None],
                           max_new_tokens=r.max_new_tokens)
        np.testing.assert_array_equal(out["results"][r.uid], ref[0].numpy(),
                                      err_msg=f"request {r.uid}")


@pytest.mark.parametrize("model_kw", [{}, {"pos_embedding": "rope"},
                                      {"num_kv_heads": 2}],
                         ids=["learned", "rope", "gqa"])
def test_engine_matches_generate_greedy(model_kw):
    """Engine tokens == the port's generate() per request: slot decode at
    per-slot positions is the model's own cached decode, batched."""
    _, _, tm = _models(**model_kw)
    reqs = _trace(n=4, new=(1, 10))
    eng = teng.ServeEngine(tm, device="cpu", max_slots=2)
    _check_parity(tm, eng.run(reqs), reqs)
    # a second trace through the same engine: the table is rewritten row
    # by row as requests are placed, so nothing of the first run leaks
    reqs2 = _trace(n=3, seed=11, new=(1, 8))
    _check_parity(tm, eng.run(reqs2), reqs2)
    assert eng.run([])["stats"]["decode_captures"] == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_generate_matches_jax_generate(bf16):
    jm, params, tm = _models(bf16=bf16)
    prompts = np.random.default_rng(3).integers(1, 61, (2, 9)).astype(
        np.int32)
    prompts[0, 4] = 0                                     # a pad inside
    want = np.asarray(jtr.generate(jm, params, jnp.asarray(prompts),
                                   max_new_tokens=12))
    got = ttr.generate(tm, torch.from_numpy(prompts), max_new_tokens=12)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    for p, g, w in zip(prompts, got.numpy(), want):
        _same_or_tie(jm, params, tm, p, g, w, bf16)


def test_generate_checks_and_sampling():
    _, _, tm = _models()
    prompt = torch.ones(1, 40, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_new_tokens"):
        ttr.generate(tm, prompt, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_len"):
        ttr.generate(tm, prompt, max_new_tokens=9)
    with pytest.raises(ValueError, match="top_k"):
        ttr.generate(tm, prompt, max_new_tokens=2, top_k=0)
    a, b = (ttr.generate(tm, prompt[:, :6], max_new_tokens=8,
                         temperature=1.0, top_k=7,
                         generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b)                              # seeded
    assert ((a > 0) & (a < 61)).all()                     # pad never picked


def test_eos_retires_early_and_slot_is_reused():
    _, _, tm = _models()
    eng = teng.ServeEngine(tm, device="cpu", max_slots=3)
    reqs = _trace(n=6, new=(6, 10))
    ref = eng.run(reqs)
    eos = int(ref["results"][0][2])
    first = int(np.where(ref["results"][0] == eos)[0][0])
    eng.eos_id = eos
    out = eng.run(reqs)
    assert len(out["results"]) == len(reqs)
    assert len(out["results"][0]) == first + 1 < len(ref["results"][0])
    assert out["results"][0][-1] == eos
    for r in reqs:
        assert len(out["results"][r.uid]) <= r.max_new_tokens
    # a row that retires on EOS frees its slot for the queue
    assert out["stats"]["decode_ticks"] <= ref["stats"]["decode_ticks"]


def test_sampled_serving_shape_and_range():
    _, _, tm = _models()
    eng = teng.ServeEngine(tm, device="cpu", max_slots=2, temperature=1.0,
                           top_k=7, generator=torch.Generator().manual_seed(9))
    out = eng.run(_trace(n=3, seed=5, new=(1, 8)))
    for toks in out["results"].values():
        assert ((toks > 0) & (toks < 61)).all()


def test_invalid_request_does_not_abort_batch():
    _, _, tm = _models()
    eng = teng.ServeEngine(tm, device="cpu", max_slots=3)
    reqs = [Request(0, np.arange(1, 5, dtype=np.int32), 4),
            Request(1, np.arange(1, 47, dtype=np.int32), 5),   # oversize
            Request(2, np.arange(1, 9, dtype=np.int32), 3),
            Request(3, np.arange(1, 3, dtype=np.int32), 2)]
    out = eng.run(reqs)
    assert set(out["results"]) == {0, 2, 3}
    assert set(out["errors"]) == {1} and "max_len" in out["errors"][1]
    assert out["stats"]["requests"] == 3 and out["stats"]["rejected"] == 1
    for r in (reqs[0], reqs[2], reqs[3]):
        assert len(out["results"][r.uid]) == r.max_new_tokens
    with pytest.raises(ValueError, match="max_len"):
        teng.ServeEngine(tm, device="cpu", max_len=4096)


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_dropped_engine_is_freed_without_gc(engine):
    """An engine and its decode tick form no reference cycle: the last
    reference gone, the engine and its caches go with it, before any
    cyclic collection."""
    import gc
    import weakref

    _, _, tm = _models()
    eng = (teng.ServeEngine(tm, device="cpu", max_slots=2) if engine == "slot"
           else teng.PagedEngine(tm, device="cpu", max_slots=2, max_len=48,
                                 kv_block_size=8, prefill_chunk=8))
    eng.run(_trace(n=3, new=(2, 4)))
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kv_cache_bytes_is_exact(bf16):
    _, _, tm = _models(bf16=bf16)
    eng = teng.ServeEngine(tm, device="cpu", max_slots=3, max_len=40)
    item = 2 if bf16 else 4
    kv = 2 * 3 * 40 * 4 * 8 * item + 3 * 40       # K and V, valid (bool)
    assert eng.kv_cache_bytes == MODEL["num_layers"] * kv
    layer = eng.slots["layers"][0]
    assert layer["cached_key"].dtype == tm.dtype


def test_slot_and_paged_engines_agree():
    _, _, tm = _models()
    trace = _trace(n=8, plens=(3, 24), new=(2, 12))
    slot = teng.ServeEngine(tm, device="cpu", max_slots=4).run(trace)
    paged = teng.PagedEngine(tm, device="cpu", max_slots=4, max_len=48,
                             kv_block_size=8, prefill_chunk=8).run(trace)
    assert slot["errors"] == paged["errors"] == {}
    for uid, toks in slot["results"].items():
        np.testing.assert_array_equal(paged["results"][uid], toks)
    assert slot["stats"]["decode_captures"] == 0
    assert paged["stats"]["decode_captures"] == 0
    assert paged["stats"]["paged_decode_launches"] == 0


def test_bench_records_on_cpu():
    model_kw = dict(MODEL, max_len=64)
    rec = tbench.serving_bench(device="cpu", n_requests=6, model_kw=model_kw,
                               prompt_lens=(2, 10), new_tokens=(2, 8),
                               max_slots=3)
    assert rec["errors"] == 0 and rec["engine"]["decode_captures"] == 0
    assert rec["naive"]["tokens_per_sec"] > 0 and rec["speedup"] > 0
    assert 0 <= rec["naive"]["wasted_fraction"] < 1
    for uid, n in rec["budgets"].items():
        assert len(rec["results"][uid]) == n
    paged = tbench.paged_serving_bench(
        device="cpu", model_kw=model_kw, max_slots=3, kv_block_size=8,
        prefill_chunk=8, load_kw=dict(n_requests=6, prompt_short=(3, 8),
                                      prompt_long=(12, 20),
                                      shared_prefix_len=8,
                                      new_tokens=(2, 8)))
    v1 = paged["engine_v1"]
    assert v1["errors"] == 0 and paged["speedup_vs_v1"] > 0
    assert "prefill_tokens_saved_frac" in paged
    for uid, toks in paged["results"].items():            # same tokens
        assert paged["results_v1"][uid] == toks


def test_naive_baseline_counts_and_results():
    """Equal prompt lengths: the naive batch path is generate(), so rows
    equal the per-request reference (trimmed to budget)."""
    _, _, tm = _models()
    reqs = jbench.make_trace(3, vocab_size=61, seed=2, prompt_lens=(4, 4),
                             new_tokens=(3, 6))
    out = tbench.run_naive(tm, reqs, batch_size=2)
    s = out["stats"]
    assert s["generated_tokens"] == sum(r.max_new_tokens for r in reqs)
    assert 0 <= s["wasted_fraction"] < 1
    _check_parity(tm, out, reqs)


@pytest.mark.parametrize("kw,match", [
    ({"kv_dtype": "int8"}, "requires the paged engine"),
    ({"weight_dtype": "int4"}, "unknown weight_dtype"),
])
def test_unported_options_raise(kw, match):
    """What the slot engine refuses, with the JAX engine's messages: int8
    KV (its scales live in the paged pools) and an unknown dtype."""
    _, _, tm = _models()
    with pytest.raises(ValueError, match=match):
        teng.ServeEngine(tm, device="cpu", **kw)


def _hook_on_tick(e):
    reports = []
    out = e.run(_trace()[:3], on_tick=reports.append)
    assert [r.kind for r in reports].count("prefill") == 3
    assert sum(len(r.emitted) for r in reports) == sum(
        len(t) for t in out["results"].values())
    assert all(all(r.finite.values()) for r in reports)


def _hook_admission(e):
    from distributed_deep_learning_tpu_torch.serve.admission import \
        AdmissionController

    adm = AdmissionController(max_queue_depth=1, shed_priority=1)
    out = e.run(_trace(stagger=0), admission=adm)
    assert out["errors"] and all(m.startswith("shed: ")
                                 for m in out["errors"].values())


def _hook_reset(e):
    e.run(_trace()[:2])
    e.reset()
    assert not any(bool(t.any()) for layer in e.slots["layers"]
                   for t in layer.values())
    assert e.restarts == 1


def _hook_swap(e):
    live = {k: v.data_ptr() for k, v in e.model.state_dict().items()}
    e.swap_params({k: v.clone() for k, v in e.model.state_dict().items()})
    assert {k: v.data_ptr() for k, v in e.model.state_dict().items()} \
        == live
    assert e.weight_swaps == 1
    with pytest.raises(ValueError, match="tree structure"):
        e.swap_params({})


def _telemetry():
    from distributed_deep_learning_tpu_torch.obs import RunTelemetry

    return RunTelemetry(path=None)


@pytest.mark.parametrize("call,match", [
    (lambda e: e.run([], telemetry=_telemetry()), None),
    (_hook_on_tick, None), (_hook_admission, None), (_hook_reset, None),
    (_hook_swap, None),
], ids=["telemetry", "on_tick", "admission", "reset", "swap_params"])
def test_unported_hooks_raise(call, match):
    """Telemetry (item 14(a)) and the supervision seams (item 13) work on
    the slot engine: telemetry's run, tick reports before the commit,
    admission shedding, an in-place reset and an in-place weight swap."""
    _, _, tm = _models()
    eng = teng.ServeEngine(tm, device="cpu", max_slots=2)
    if match is None:
        call(eng)
        return
    with pytest.raises(NotImplementedError, match=match):
        call(eng)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: nothing to refuse")
    _, _, tm = _models()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        teng.ServeEngine(tm, max_slots=2)
