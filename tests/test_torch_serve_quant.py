"""Quantized serving in the port (``serve/quant.py``, the engines'
``kv_dtype``/``weight_dtype``) against the JAX package's.

The cases of ``tests/test_serve_quant.py`` that concern the port, on the
same model (vocab 61, 2 layers, d 32, the JAX init from key 1 carried over
with ``load_flax_params``) and the same seeded traces:

* the int8 rule: round-trip error within half a step, scale shapes, and
  payloads and scales BIT-EQUAL to JAX's ``quantize_rows`` and
  ``quantize_weights`` on the same inputs (the weights through the
  bridge: the port quantizes each ``Dense`` per channel of the flax
  kernel's last axis);
* ``check_dtype``; bytes that shrink (KV >= 3.5x at head_dim 32, weights
  > 2.5x); a float write into an int8 pool raises;
* prefix reuse on int8 pools; the draft's pools inherit ``kv_dtype``;
* bf16 KV greedy parity with full precision, exact, on both engines; int8
  weights: the calibrated drift within its declared bound (<= 0.05), probe
  agreement >= 0.9, engine agreement >= 0.5; the slot engine refuses int8
  KV with JAX's message;
* the port's engines give the JAX engines' greedy tokens, exactly, with
  the same ``kv_dtype``/``weight_dtype`` (the port on the CPU, its decode
  attention the kernel's plain version reading the same at-rest pools).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models.transformer import CausalLM as JLM
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import quant as jquant
from distributed_deep_learning_tpu.serve.scheduler import Request as JReq
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, load_flax_params)
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.serve import paged, quant
from distributed_deep_learning_tpu_torch.serve.engine import (PagedEngine,
                                                              ServeEngine)
from distributed_deep_learning_tpu_torch.serve.scheduler import Request
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)
ENGINE = dict(max_slots=3, kv_block_size=8, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _shared(**kw):
    jm = JLM(**{**MODEL, **kw})
    params = jm.init(jax.random.key(1), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = CausalLM(**{**MODEL, **kw})
    tm.load_state_dict(load_flax_params(params))
    return jm, params, tm.eval()


def _engine(**kw):
    return PagedEngine(_shared()[2], device="cpu", **{**ENGINE, **kw})


def _trace(seed=0, n=5, max_new=(1, 8), plens=(3, 16), stagger=3,
           cls=Request):
    rng = np.random.default_rng(seed)
    reqs, tick = [], 0
    for uid in range(n):
        p = int(rng.integers(*plens))
        reqs.append(cls(uid, rng.integers(1, 61, p).astype(np.int32),
                        int(rng.integers(*max_new)), arrival_tick=tick))
        tick += int(rng.integers(0, stagger + 1))
    return reqs


def _agreement(a, b):
    total = same = 0
    for uid, toks in a.items():
        toks, other = np.asarray(toks), np.asarray(b[uid])
        total += len(toks)
        same += int(np.sum(toks == other))
    return same / total


# --- the int8 rule ----------------------------------------------------------


def test_roundtrip_error_bounds():
    x = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(24, 16)) * 3.0)
        .astype(np.float32))
    for qt in (quant.quantize_channels(x), quant.quantize_rows(x)):
        assert quant.is_quant(qt) and qt.q.dtype == torch.int8
        back = quant.dequant(qt, torch.float32)
        assert float((back - x).abs().max()) <= float(x.abs().max()) / 127
    assert quant.quantize_channels(x).s.shape == (16,)
    assert quant.quantize_rows(x).s.shape == (24, 1)


def test_quant_tensor_indexes_payload_and_scales():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 4, 8))
                         .astype(np.float32))
    qt = quant.quantize_rows(x)
    picked = qt[torch.tensor([4, 0])]
    assert picked.q.shape == (2, 4, 8) and picked.s.shape == (2, 4, 1)
    assert torch.equal(picked.q, qt.q[[4, 0]])
    qt[torch.tensor([1])] = picked[torch.tensor([0])]
    assert torch.equal(qt.q[1], qt.q[4]) and torch.equal(qt.s[1], qt.s[4])


def test_int8_rows_are_bit_equal_to_jax():
    x = (np.random.default_rng(2).normal(size=(5, 8, 2, 16)) * 2.5
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero row: scale 1e-30
    want = jquant.quantize_rows(jnp.asarray(x))
    got = quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


def test_int8_weights_are_bit_equal_to_jax():
    """Through the bridge: each ``Dense`` payload is the JAX kernel's in
    the torch layout, its scales JAX's per flax-last-axis channel (per
    head-dim index for q/k/v), and the tables' per model-dim column."""
    jm, params, tm = _shared()
    jq = jquant.quantize_weights(params, "int8")
    qm = quant.quantize_weights(tm, "int8")
    payload = load_flax_params(jax.tree.map(
        lambda leaf: np.asarray(leaf.q if jquant.is_quant(leaf) else leaf),
        jq, is_leaf=jquant.is_quant))
    sd = qm.state_dict()
    for name, mod in qm.named_modules():
        if isinstance(mod, quant.QuantDense):
            want = payload[f"{name}.weight"].numpy()
            np.testing.assert_array_equal(mod.q.numpy(), want.astype(
                np.int8), err_msg=name)
            if hasattr(mod, "bias_q"):         # the q/k/v heads' biases
                np.testing.assert_array_equal(
                    mod.bias_q.numpy(),
                    payload[f"{name}.bias"].numpy().astype(np.int8))
    layer = jq["layer_0"]
    for mine, theirs in (
            (sd["layers.0.self_attn.q.s"], layer["self_attn"]["q"]["kernel"]),
            (sd["layers.0.self_attn.k.bias_s"],
             layer["self_attn"]["k"]["bias"]),
            (sd["layers.0.self_attn.out.s"],
             layer["self_attn"]["out"]["kernel"]),
            (sd["layers.0.mlp_in.s"], layer["Dense_0"]["kernel"]),
            (sd["tok.s"], jq["embed"]["tok"]["embedding"]),
            (sd["pos.s"], jq["embed"]["pos"])):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs.s))
    np.testing.assert_array_equal(sd["tok.q"].numpy(),
                                  np.asarray(jq["embed"]["tok"]["embedding"]
                                             .q))
    # vectors stay full precision; the at-rest bytes are JAX's
    assert sd["layers.0.mlp_in.bias_f"].dtype == torch.float32
    assert quant.weight_bytes(qm) == jquant.weight_bytes(jq)
    # the caller's model is left as it was
    assert isinstance(tm.layers[0].mlp_in.weight, torch.nn.Parameter)


def test_dequantized_weights_equal_jax():
    jm, params, tm = _shared()
    want = load_flax_params(jax.tree.map(np.asarray, jquant.
                                         dequantize_weights(jquant.
                                         quantize_weights(params, "int8"),
                                         jnp.float32)))
    got = quant.dequantize_weights(quant.quantize_weights(tm, "int8"))
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                      err_msg=name)


def test_check_dtype_rejects_unknown():
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        quant.check_dtype("kv_dtype", "fp4")
    assert quant.check_dtype("kv_dtype", None) is None
    assert quant.check_dtype("kv_dtype", "int8") == "int8"


def test_scatter_span_rejects_bare_float_into_int_pool():
    pools = paged.build_pools(1, 4, 8, 2, 3, device="cpu", kv_dtype="int8")
    rows = torch.ones(1, 2, 3)
    with pytest.raises(TypeError, match="quantize"):
        paged.scatter_span(pools[0], rows, rows, torch.ones(1, dtype=bool),
                           torch.tensor([1]), torch.tensor([0]))


# --- bytes ------------------------------------------------------------------


def test_kv_cache_bytes_shrink_at_bench_geometry():
    """head_dim 32: int8 payload plus an f32 scale a row cut the pools
    >= 3.5x, as in the JAX test."""
    _, _, tm = _shared(vocab_size=512, d_model=128, mlp_dim=256,
                       max_len=64)
    kw = dict(device="cpu", max_slots=2, kv_block_size=8, max_len=64)
    fp = PagedEngine(tm, **kw)
    q8 = PagedEngine(tm, kv_dtype="int8", **kw)
    bf = PagedEngine(tm, kv_dtype="bf16", **kw)
    kv = [paged.pool_bytes(e.pools) for e in (fp, q8, bf)]
    assert kv[0] / kv[1] >= 3.5, kv
    assert kv[0] / kv[2] > 1.9, kv
    assert q8.kv_dtype == "int8" and fp.kv_dtype is None


def test_weight_bytes_shrink():
    _, params, tm = _shared()
    full = quant.weight_bytes(tm)
    assert quant.weight_bytes(quant.quantize_weights(tm, "int8")) < \
        full / 2.5
    assert quant.weight_bytes(quant.quantize_weights(tm, "bf16")) == \
        full // 2
    assert full == jquant.weight_bytes(params)


# --- the engines --------------------------------------------------------


def test_int8_pools_and_prefix_reuse():
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(1, 61, 17).astype(np.int32)
    reqs = [Request(uid, np.concatenate([sys_prompt, rng.integers(
        1, 61, 4 + uid).astype(np.int32)]), 6, arrival_tick=0)
        for uid in range(4)]
    eng = _engine(max_slots=2, kv_dtype="int8")
    for layer in eng.pools:
        for name in ("cached_key", "cached_value"):
            assert quant.is_quant(layer[name])
            assert layer[name].q.dtype == torch.int8
            assert layer[name].s.shape == layer[name].q.shape[:-1] + (1,)
    out = eng.run(reqs)
    assert not out["errors"]
    st = out["stats"]
    assert st["paged"]["prefix_hit_rate"] > 0, st["paged"]
    ref = _engine(max_slots=2).run(reqs)
    assert st["paged"]["prefix_hit_rate"] == \
        ref["stats"]["paged"]["prefix_hit_rate"]
    again = _engine(max_slots=2, kv_dtype="int8").run(reqs)
    assert _agreement(out["results"], again["results"]) == 1.0


def test_draft_pool_inherits_kv_dtype():
    eng = _engine(kv_dtype="int8", weight_dtype="int8", draft_layers=1,
                  max_len=40)
    assert all(quant.is_quant(layer["cached_key"])
               for layer in eng.draft_pools)
    assert eng.kv_cache_bytes == paged.pool_bytes(eng.pools) + \
        paged.pool_bytes(eng.draft_pools)
    out = eng.run(_trace(n=3, max_new=(2, 6)))
    assert not out["errors"]
    assert out["stats"]["spec"]["rounds"] > 0


def test_bf16_kv_greedy_parity_exact():
    reqs = _trace(n=4)
    ref = _engine().run(reqs)
    bf = _engine(kv_dtype="bf16").run(reqs)
    assert _agreement(ref["results"], bf["results"]) == 1.0
    tm = _shared()[2]
    v1_ref = ServeEngine(tm, device="cpu", max_slots=3).run(reqs)
    v1_bf = ServeEngine(tm, device="cpu", max_slots=3,
                        kv_dtype="bf16").run(reqs)
    assert _agreement(v1_ref["results"], v1_bf["results"]) == 1.0
    assert v1_bf["stats"]["kv_dtype"] == "bf16"
    assert v1_bf["stats"]["kv_cache_bytes"] < \
        v1_ref["stats"]["kv_cache_bytes"]


def test_int8_weights_drift_bounded():
    jm, params, tm = _shared()
    qm = quant.quantize_weights(tm, "int8")
    probe = np.asarray(_trace(n=1, plens=(24, 25))[0].prompt)
    cal = quant.calibrate_weight_drift(tm, qm, probe)
    assert cal["measured_max_drift"] <= cal["declared_bound"] <= 0.05
    assert cal["probe_argmax_agreement"] >= 0.9
    want = jquant.calibrate_weight_drift(
        jm, params, jquant.quantize_weights(params, "int8"), probe)
    np.testing.assert_allclose(cal["measured_max_drift"],
                               want["measured_max_drift"], rtol=1e-3,
                               atol=1e-6)
    reqs = _trace(n=4)
    out = _engine(kv_dtype="int8", weight_dtype="int8").run(reqs)
    assert not out["errors"]
    assert out["stats"]["weight_bytes"] < quant.weight_bytes(tm) / 2.5
    ref = _engine().run(reqs)
    assert _agreement(ref["results"], out["results"]) >= 0.5


def test_slot_engine_refuses_int8_kv():
    tm = _shared()[2]
    with pytest.raises(ValueError, match="requires the paged engine"):
        ServeEngine(tm, device="cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        ServeEngine(tm, device="cpu", kv_dtype="fp4")
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        PagedEngine(tm, device="cpu", weight_dtype="int4")


QUANT_CASES = {"kv_bf16": dict(kv_dtype="bf16"),
               "kv_int8": dict(kv_dtype="int8"),
               "kv_int8_weights_int8": dict(kv_dtype="int8",
                                            weight_dtype="int8"),
               "weights_bf16": dict(weight_dtype="bf16")}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_paged_engine_matches_jax_engine(case):
    opts = QUANT_CASES[case]
    jm, params, _ = _shared()
    jout = jeng.PagedEngine(jm, params, **ENGINE, **opts).run(
        _trace(n=4, cls=JReq))
    tout = _engine(**opts).run(_trace(n=4))
    assert jout["errors"] == tout["errors"] == {}
    for uid, toks in jout["results"].items():
        np.testing.assert_array_equal(tout["results"][uid], toks,
                                      err_msg=f"request {uid}")
    assert tout["stats"]["kv_cache_bytes"] == paged.pool_bytes(
        _engine(**opts).pools)


@pytest.mark.parametrize("case", ["kv_bf16", "weights_int8"])
def test_slot_engine_matches_jax_engine(case):
    opts = {"kv_bf16": dict(kv_dtype="bf16"),
            "weights_int8": dict(weight_dtype="int8")}[case]
    jm, params, tm = _shared()
    jout = jeng.ServeEngine(jm, params, max_slots=3, **opts).run(
        _trace(n=4, cls=JReq))
    tout = ServeEngine(tm, device="cpu", max_slots=3, **opts).run(
        _trace(n=4))
    for uid, toks in jout["results"].items():
        np.testing.assert_array_equal(tout["results"][uid], toks,
                                      err_msg=f"request {uid}")


def test_bench_records_carry_the_quantization():
    load = dict(n_requests=3, shared_prefix_len=8, prompt_short=(3, 6),
                prompt_long=(8, 12), new_tokens=(2, 6))
    rec = tbench.paged_serving_bench(
        device="cpu", load_kw=load, model_kw=MODEL, max_slots=2,
        kv_block_size=8, kv_dtype="int8", weight_dtype="int8",
        compare_engine=False)
    assert rec["errors"] == 0
    assert (rec["kv_dtype"], rec["weight_dtype"]) == ("int8", "int8")
    drift = rec["weight_drift"]
    assert drift["measured_max_drift"] <= drift["declared_bound"]
    pe = rec["paged_engine"]
    assert pe["weight_bytes"] > 0 and pe["kv_cache_bytes"] > 0
    slot = tbench.serving_bench(device="cpu", n_requests=3, model_kw=MODEL,
                                prompt_lens=(3, 8), new_tokens=(2, 5),
                                max_slots=2, skip_naive=True,
                                kv_dtype="bf16")
    assert slot["kv_dtype"] == "bf16" and slot["weight_drift"] is None
    assert slot["errors"] == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_cache_dict_helpers_match_jax(kv_dtype):
    """``quantize_cache_span``, ``dequant_cache`` and ``cast_kv`` on a
    layer's cache dict: the K/V leaves as JAX's helpers make them, the
    validity exact."""
    rng = np.random.default_rng(8)
    k, v = (rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
            for _ in range(2))
    valid = rng.random((1, 6)) > 0.5
    span = {"cached_key": torch.from_numpy(k),
            "cached_value": torch.from_numpy(v),
            "cached_valid": torch.from_numpy(valid)}
    jspan = {"cached_key": jnp.asarray(k), "cached_value": jnp.asarray(v),
             "cached_valid": jnp.asarray(valid)}
    got = quant.quantize_cache_span(span, kv_dtype)
    want = jquant.quantize_cache_span(jspan, kv_dtype)
    back = quant.dequant_cache(got, torch.float32)
    jback = jquant.dequant_cache(want, jnp.float32)
    for name in ("cached_key", "cached_value"):
        if kv_dtype == "int8":
            np.testing.assert_array_equal(got[name].q.numpy(),
                                          np.asarray(want[name].q))
        else:
            assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(back[name].numpy(),
                                      np.asarray(jback[name]))
    assert got["cached_valid"] is span["cached_valid"]
    cast = quant.cast_kv(span, torch.bfloat16)
    assert cast["cached_key"].dtype == torch.bfloat16
    assert cast["cached_valid"].dtype == torch.bool
