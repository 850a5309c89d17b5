"""The port's ``--serve --paged --disagg`` path and serving benches
against the JAX package's.

On one device the CLI refuses ``--disagg`` with JAX's message.  With two
devices (the CPU passed twice to the port, JAX's CPU mesh cut to two)
``_gpt_serve_disagg`` logs JAX's ``serve(disagg):`` and ``pool-elastic``
lines with the same fields, times excepted.  ``disagg_serving_bench``
gives JAX's record keys (the compile counts renamed to the decode tick's
captures), and its fields that do not depend on the weights or the clock
equal JAX's.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import transformer as jtr
from distributed_deep_learning_tpu.serve import bench as jbench
from distributed_deep_learning_tpu.utils import config as jconfig
from distributed_deep_learning_tpu.workloads import northstar as jns
from distributed_deep_learning_tpu_torch.models import transformer as ttr
from distributed_deep_learning_tpu_torch.serve import bench as tbench
from distributed_deep_learning_tpu_torch.utils import config as tconfig
from distributed_deep_learning_tpu_torch.workloads import northstar as tns
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=64, num_heads=4,
             mlp_dim=128, max_len=64)
BENCH_MODEL = dict(vocab_size=97, num_layers=1, d_model=32, num_heads=2,
                   mlp_dim=64, max_len=96)
BENCH_LOAD = dict(n_requests=6, prompt_short=(4, 8), prompt_long=(12, 20),
                  shared_prefix_len=8, new_tokens=(2, 6))
ARGV = ["--serve", "--paged", "--disagg", "--pool-elastic", "-d", "cpu",
        "--max-slots", "4", "--kv-block-size", "8", "--prefill-chunk", "8"]


class Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.fixture
def two_devices(monkeypatch):
    """Two devices on each side: JAX's CPU mesh cut to two, the port's
    CPU passed twice."""
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: two)
    monkeypatch.setattr(tconfig, "local_device_count", lambda device: 2)
    monkeypatch.setattr(tns, "local_devices",
                        lambda config: [torch.device("cpu")] * 2)


def test_disagg_on_one_device_is_refused_as_jax(monkeypatch):
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: one)
    with pytest.raises(SystemExit) as theirs:
        jconfig.parse_args(ARGV, "gpt")
    with pytest.raises(SystemExit) as mine:
        tconfig.parse_args(ARGV, "gpt")
    assert str(mine.value) == str(theirs.value)
    assert "needs >= 2 local devices" in str(mine.value)
    for argv in (["--serve", "--disagg"], ["--prefill-workers", "0"],
                 ARGV + ["--prefill-workers", "2"]):
        with pytest.raises(SystemExit) as theirs:
            jconfig.parse_args(argv, "gpt")
        with pytest.raises(SystemExit) as mine:
            tconfig.parse_args(argv, "gpt")
        assert str(mine.value) == str(theirs.value), argv


@functools.lru_cache(maxsize=None)
def _models():
    jm = jtr.CausalLM(**MODEL)
    params = jm.init(jax.random.key(11), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = ttr.CausalLM(**MODEL)
    tm.load_state_dict(ttr.load_flax_params(params))
    return jm, params, tm.eval()


_FIELDS = re.compile(
    r"serve\(disagg\): (\d+) requests, (\d+) tokens at [\d.]+ tok/s over "
    r"(\dP\+\dD), prefill util ([\d.]+), migrated (\d+) handoffs")


def test_cli_lines_equal_jax(two_devices):
    jm, params, tm = _models()
    jcfg = jconfig.parse_args(ARGV, "gpt")
    tcfg = tconfig.parse_args(ARGV, "gpt")
    assert (tcfg.disagg, tcfg.pool_elastic, tcfg.prefill_workers) == \
        (jcfg.disagg, jcfg.pool_elastic, jcfg.prefill_workers)
    kw = dict(max_slots=4, max_len=64, kv_block_size=8, prefill_chunk=8,
              draft_layers=None, spec_k=4, kv_dtype=None, weight_dtype=None)
    jtrace = jbench.make_trace(6, vocab_size=61, seed=0,
                               prompt_lens=(2, 24), new_tokens=(1, 8))
    ttrace = tbench.make_trace(6, vocab_size=61, seed=0,
                               prompt_lens=(2, 24), new_tokens=(1, 8))
    for a, b in zip(jtrace, ttrace):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    theirs, mine = Lines(), Lines()
    jns._gpt_serve_disagg(jcfg, jm, params, theirs, jtrace, kw)
    tns._gpt_serve_disagg(tcfg, tm, mine, ttrace,
                          {**kw, "device": torch.device("cpu")})
    assert len(mine.lines) == len(theirs.lines) == 2
    assert _FIELDS.match(mine.lines[0]).groups() == \
        _FIELDS.match(theirs.lines[0]).groups()
    assert mine.lines[1] == theirs.lines[1]
    assert "pool-elastic" in mine.lines[1]


def _keys(d, renames=()):
    out = set(d) - {"device"}
    return {dict(renames).get(k, k) for k in out}


_COMPILES = (("decode_captures", "decode_compiles"),)


def test_disagg_bench_record_equals_jax(two_devices):
    kw = dict(model_kw=BENCH_MODEL, load_kw=BENCH_LOAD, max_slots=4,
              kv_block_size=8, prefill_chunk=8, prefill_streams=2)
    theirs = jbench.disagg_serving_bench(**kw)
    mine = tbench.disagg_serving_bench(device="cpu", **kw)
    assert _keys(mine) == _keys(theirs)
    assert _keys(mine["unified"], _COMPILES) | {"chunk_compiles"} == \
        _keys(theirs["unified"])
    for k in ("prefill_workers", "decode_workers", "prefill_streams",
              "max_slots", "kv_block_size", "kv_dtype", "decode_passes",
              "errors", "token_agreement", "wire_bytes_per_block",
              "int8_wire_shrink_x", "model", "load"):
        assert mine[k] == theirs[k], k
    assert mine["token_agreement"] == 1.0
    for k in ("prefill_util", "prefill_chunk_calls"):
        assert mine["disagg"][k] == theirs["disagg"][k], k
    for k in ("moves", "blocks"):
        assert mine["disagg"]["migration"][k] == \
            theirs["disagg"]["migration"][k], k
    assert mine["speedup"] > 0 and mine["migration_ms_per_move"] > 0
