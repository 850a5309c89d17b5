"""The port's quantized and fleet serving benches against the JAX
package's: JAX's record keys (the compile counts renamed to the decode
tick's captures), and the fields that do not depend on the weights or
the clock equal to JAX's.  (Each bench draws its own seeded weights, so
tokens are held only within a package.)"""

import pytest

from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

BENCH_MODEL = dict(vocab_size=97, num_layers=1, d_model=32, num_heads=2,
                   mlp_dim=64, max_len=96)
BENCH_LOAD = dict(n_requests=6, prompt_short=(4, 8), prompt_long=(12, 20),
                  shared_prefix_len=8, new_tokens=(2, 6))
KW = dict(model_kw=BENCH_MODEL, load_kw=BENCH_LOAD, max_slots=4,
          kv_block_size=8, prefill_chunk=8)
_COMPILES = (("decode_captures", "decode_compiles"),)


def _keys(d, renames=()):
    return {dict(renames).get(k, k) for k in set(d) - {"device"}}


def test_quantized_bench_record_equals_jax():
    theirs = jbench.quantized_serving_bench(**KW)
    mine = tbench.quantized_serving_bench(device="cpu", **KW)
    assert _keys(mine) == _keys(theirs)
    assert _keys(mine["baseline"], _COMPILES) == _keys(theirs["baseline"])
    assert _keys(mine["quantized"], _COMPILES) | {"chunk_compiles"} == \
        _keys(theirs["quantized"])
    for k in ("kv_dtype", "weight_dtype", "max_slots", "kv_block_size",
              "errors", "model", "load"):
        assert mine[k] == theirs[k], k
    # JAX's pools also hold a placeholder counter leaf a layer
    assert mine["kv_shrink_x"] == pytest.approx(theirs["kv_shrink_x"],
                                                rel=1e-3)
    for arm in ("baseline", "quantized"):
        assert mine[arm]["max_context_at_budget"] == pytest.approx(
            theirs[arm]["max_context_at_budget"], rel=1e-3), arm


def test_fleet_bench_record_equals_jax():
    theirs = jbench.fleet_serving_bench(replicas=2, **KW)
    mine = tbench.fleet_serving_bench(device="cpu", replicas=2, **KW)
    assert _keys(mine, (("decode_captures_max", "decode_compiles_max"),)) \
        == _keys(theirs)
    for k in ("replicas", "requests", "completed", "requests_lost",
              "errors", "generated_tokens", "rounds", "routing", "health"):
        assert mine[k] == theirs[k], k
    assert set(mine["slo_by_priority"]) == set(theirs["slo_by_priority"])
