"""The port's disaggregated serving against the JAX package's.

The port's ``DisaggEngine`` on two CPU "devices" (one CPU device passed
twice) and JAX's on the conftest's CPU mesh serve the same shared-prefix
trace on the same weights (a 2-layer, width-64 ``gpt``, carried across
with ``load_flax_params``).  Greedy tokens are equal, and so are the
migration's moves and blocks, the wire bytes a moved block (JAX pads
every move to the migrator's width; the port carries the moved blocks
only), ``prefill_util`` and the chunk and tick counts, over both wires.
``reassign`` in both directions, ``reset``, the constructor's refusals
and ``PoolRebalancer``'s decisions match JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import autoscaler as jauto
from distributed_deep_learning_tpu.serve import disagg as jdis
from distributed_deep_learning_tpu.serve import load as jload
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import autoscaler as tauto
from distributed_deep_learning_tpu_torch.serve import disagg as tdis
from distributed_deep_learning_tpu_torch.serve import load as tload
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=64, num_heads=4,
             mlp_dim=128, max_len=64)
KW = dict(max_slots=4, kv_block_size=8, prefill_chunk=8, max_len=64,
          prefill_streams=3)
LOAD = dict(n_requests=10, arrival="poisson", rate=1.5,
            prompt_short=(3, 10), prompt_long=(14, 24), long_frac=0.3,
            shared_prefix_len=12, shared_frac=0.6, new_tokens=(2, 10))
CPU2 = [torch.device("cpu")] * 2


@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(11), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm.eval()


def _traces():
    return (jload.make_load(jload.LoadSpec(**LOAD), MODEL["vocab_size"], 0),
            tload.make_load(tload.LoadSpec(**LOAD), MODEL["vocab_size"], 0))


def _tokens(out):
    return {u: [int(t) for t in v] for u, v in out["results"].items()}


@functools.lru_cache(maxsize=None)
def _jax_run(wire):
    jm, params, _ = _models()
    return jdis.DisaggEngine(jm, params, wire=wire, **KW).run(_traces()[0])


@pytest.mark.parametrize("wire", ["at_rest", "int8"])
def test_tokens_and_handoffs_equal_jax(wire):
    _, _, tm = _models()
    want = _jax_run(wire)
    eng = tdis.DisaggEngine(tm, devices=CPU2, wire=wire, **KW)
    got = eng.run(_traces()[1])
    assert _tokens(got) == _tokens(want) and not got["errors"]
    ts, js = got["stats"], want["stats"]
    for k in ("requests", "generated_tokens", "prefill_util",
              "prefill_chunks", "prefill_chunk_calls", "decode_ticks",
              "mean_slot_occupancy", "prefill_workers", "decode_workers",
              "wire"):
        assert ts[k] == js[k], k
    assert ts["paged"] == {**js["paged"], "prefill_workers":
                           ts["paged"]["prefill_workers"]}
    tm_, jm_ = ts["migration"], js["migration"]
    for k in ("moves", "blocks", "hops", "verified", "failed"):
        assert tm_[k] == jm_[k], k
    width = eng.decode[0].eng.blocks_per_slot
    assert tm_["wire_bytes"] * jm_["moves"] * width == \
        jm_["wire_bytes"] * tm_["blocks"]
    assert ts["paged_decode_launches"] == 0      # the CPU's plain decode
    assert ts["decode_captures"] == 0


def test_reassign_and_reset_match_jax():
    jm, params, tm = _models()
    devs3 = [torch.device("cpu")] * 3
    mine = tdis.DisaggEngine(tm, prefill_workers=1, decode_workers=2,
                             devices=devs3, **KW)
    theirs = jdis.DisaggEngine(jm, params, prefill_workers=1,
                               decode_workers=2, **KW)
    steps = ["to_prefill", "to_prefill", "to_decode", "to_decode",
             "to_decode"]
    for d in steps:
        got, want = mine.reassign(d), theirs.reassign(d)
        assert got == want, d
        assert (len(mine.prefill), len(mine.decode)) == \
            (len(theirs.prefill), len(theirs.decode)), d
    assert mine.pool_reassignments == theirs.pool_reassignments == 2
    with pytest.raises(ValueError) as a:
        mine.reassign("sideways")
    with pytest.raises(ValueError) as b:
        theirs.reassign("sideways")
    assert str(a.value) == str(b.value)
    # after the moves and a reset the engine serves JAX's tokens
    mine.reset()
    assert mine.restarts == 1
    out = mine.run(_traces()[1])
    assert _tokens(out) == _tokens(_jax_run("at_rest"))
    assert out["stats"]["pool_reassignments"] == 2


@pytest.mark.parametrize("kw", [
    dict(prefill_workers=0), dict(decode_workers=0),
    dict(prefill_streams=0), dict(decode_passes=0), dict(devices=1),
    dict(prefill_workers=2, decode_workers=1),
    dict(wire="int8", kv_dtype="int8")],
    ids=["no_prefill", "no_decode", "no_streams", "no_passes",
         "one_device", "too_many", "int8_over_int8"])
def test_refusals_equal_jax(kw):
    jm, params, tm = _models()
    mine, theirs = dict(kw), dict(kw)
    if "devices" in kw:
        mine["devices"] = CPU2[:1]
        theirs["devices"] = jax.devices()[:1]
    else:
        mine["devices"] = CPU2
        theirs["devices"] = jax.devices()[:2]
    with pytest.raises(ValueError) as a:
        tdis.DisaggEngine(tm, **{**KW, **mine})
    with pytest.raises(ValueError) as b:
        jdis.DisaggEngine(jm, params, **{**KW, **theirs})
    assert str(a.value) == str(b.value)


def test_pool_rebalancer_equals_jax():
    utils = [0.95, 0.97, 0.5, 0.1, 0.2, 0.3, 0.05, 0.0, 0.92, 0.91, 0.93]
    for kw in ({}, dict(hi=0.8, lo=0.3, patience=1),
               dict(hi=0.99, lo=0.01, patience=3)):
        mine, theirs = tauto.PoolRebalancer(**kw), \
            jauto.PoolRebalancer(**kw)
        assert [mine.observe(u) for u in utils] == \
            [theirs.observe(u) for u in utils]
        assert mine.events == theirs.events
    for bad in (dict(hi=0.2, lo=0.5), dict(patience=0)):
        with pytest.raises(ValueError) as a:
            tauto.PoolRebalancer(**bad)
        with pytest.raises(ValueError) as b:
            jauto.PoolRebalancer(**bad)
        assert str(a.value) == str(b.value)
