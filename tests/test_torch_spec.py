"""Speculative decoding in the port (``serve/spec.py`` and ``PagedEngine(
draft_layers=...)``) against the JAX package's.

``greedy_accept`` is held against JAX's on the same proposals; the
truncated draft shares the target's tensors (same storage).  The engine,
with a 1-layer draft proposing 3 tokens a round, serves the trace of
``tests/test_serve_paged.py``'s speculation test on the JAX model's
weights (the ``load_flax_params`` bridge): its greedy tokens equal the
port's ``generate()``, the non-speculative engine's and the JAX engine's
with the same draft, exactly.  Every draft step attends through the
decode attention, counted here, and the plain decode tick never runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models.transformer import CausalLM as JLM
from distributed_deep_learning_tpu.serve import engine as jeng
from distributed_deep_learning_tpu.serve import spec as jspec
from distributed_deep_learning_tpu.serve.scheduler import Request as JReq
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, generate, load_flax_params)
from distributed_deep_learning_tpu_torch.ops.paged_decode import \
    paged_decode_reference
from distributed_deep_learning_tpu_torch.serve import quant, spec
from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
from distributed_deep_learning_tpu_torch.serve.scheduler import Request
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
             mlp_dim=64, max_len=48)
ENGINE = dict(max_slots=3, kv_block_size=8, prefill_chunk=8, max_len=40)
SPEC = dict(draft_layers=1, spec_k=3)


@functools.lru_cache(maxsize=None)
def _shared():
    jm = JLM(**MODEL)
    params = jm.init(jax.random.key(1), jnp.ones((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params["params"])
    tm = CausalLM(**MODEL)
    tm.load_state_dict(load_flax_params(params))
    return jm, params, tm.eval()


def _trace(cls=Request, seed=3, n=4, max_new=(4, 10), plens=(3, 14),
           stagger=3):
    rng = np.random.default_rng(seed)
    reqs, tick = [], 0
    for uid in range(n):
        p = int(rng.integers(*plens))
        reqs.append(cls(uid, rng.integers(1, 61, p).astype(np.int32),
                        int(rng.integers(*max_new)), arrival_tick=tick))
        tick += int(rng.integers(0, stagger + 1))
    return reqs


@pytest.mark.parametrize("proposed,verified", [
    ([5, 6, 7], [5, 6, 7, 8]), ([5, 6, 7], [5, 9, 7, 8]),
    ([5, 6, 7], [1, 6, 7, 8]), ([4], [4, 2]), ([4], [3, 2])])
def test_greedy_accept_matches_jax(proposed, verified):
    assert spec.greedy_accept(proposed, verified) == \
        jspec.greedy_accept(np.asarray(proposed), np.asarray(verified))


def test_greedy_accept_needs_k_plus_one():
    with pytest.raises(ValueError, match="k\\+1=3"):
        spec.greedy_accept([1, 2], [1, 2])


def test_truncated_draft_shares_the_targets_tensors():
    tm = _shared()[2]
    draft = spec.truncated_draft(tm, 1)
    assert draft.num_layers == 1 and len(draft.layers) == 1
    mine = dict(draft.named_parameters())
    for name, p in tm.named_parameters():
        if name in mine:
            assert mine[name].data_ptr() == p.data_ptr(), name
    assert len(mine) < len(dict(tm.named_parameters()))
    qm = quant.quantize_weights(tm, "int8")
    qdraft = spec.truncated_draft(qm, 1)
    assert qdraft.tok.q.data_ptr() == qm.tok.q.data_ptr()
    assert qdraft.layers[0].mlp_in.q.data_ptr() == \
        qm.layers[0].mlp_in.q.data_ptr()
    for bad in (0, 2):
        with pytest.raises(ValueError, match="draft_layers"):
            spec.truncated_draft(tm, bad)


def _counting_engine(monkeypatch, **kw):
    """A CPU engine whose decode attention is counted; the plain decode
    tick raises if it runs."""
    eng = PagedEngine(_shared()[2], device="cpu", **{**ENGINE, **kw})
    calls = [0]

    def attention(*args, **kwargs):
        calls[0] += 1
        return paged_decode_reference(*args, **kwargs)

    eng.attention = attention

    def no_plain_tick(self, staged):
        raise AssertionError("the plain decode tick ran while speculating")

    if kw.get("draft_layers") is not None:
        monkeypatch.setattr(PagedEngine, "_decode_body", no_plain_tick)
    return eng, calls


def test_spec_matches_generate_and_the_jax_engine(monkeypatch):
    jm, params, tm = _shared()
    eng, calls = _counting_engine(monkeypatch, **SPEC)
    reqs = _trace()
    out = eng.run(reqs)
    assert not out["errors"]
    for r in reqs:
        ref = generate(tm, torch.as_tensor(r.prompt)[None].long(),
                       max_new_tokens=r.max_new_tokens)[0].numpy()
        np.testing.assert_array_equal(out["results"][r.uid], ref,
                                      err_msg=f"request {r.uid}")
    jout = jeng.PagedEngine(jm, params, **ENGINE, **SPEC).run(_trace(JReq))
    for uid, toks in jout["results"].items():
        np.testing.assert_array_equal(out["results"][uid], toks,
                                      err_msg=f"request {uid}")
    s, sp = out["stats"], out["stats"]["spec"]
    assert sp["enabled"] and sp["rounds"] > 0 and sp["k"] == 3
    assert sp["proposed"] == sp["rounds"] * SPEC["spec_k"]
    assert sp["accepted"] == jout["stats"]["spec"]["accepted"]
    assert 0.0 <= sp["acceptance_rate"] <= 1.0
    # each speculative tick: spec_k + 1 draft steps, one launch a layer
    assert calls[0] == s["decode_ticks"] * (SPEC["spec_k"] + 1) * \
        SPEC["draft_layers"]
    assert (s["decode_captures"], s["draft_captures"],
            s["verify_captures"]) == (0, 0, 0)       # CPU: eager
    assert s["paged_decode_launches"] == 0


def test_spec_matches_the_plain_engine_on_a_shared_prefix():
    """Prefix reuse and copy-on-write with speculation: the draft's pools
    are copied with the target's."""
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 61, 11).astype(np.int32)
    reqs = [Request(uid, np.concatenate([shared, rng.integers(
        1, 61, 3 + uid).astype(np.int32)]), 6, arrival_tick=2 * uid)
        for uid in range(4)]
    tm = _shared()[2]
    plain = PagedEngine(tm, device="cpu", **ENGINE).run(reqs)
    sp = PagedEngine(tm, device="cpu", **ENGINE, **SPEC).run(reqs)
    assert plain["results"].keys() == sp["results"].keys()
    for uid, toks in plain["results"].items():
        np.testing.assert_array_equal(sp["results"][uid], toks)
    assert sp["stats"]["paged"]["prefix_hit_rate"] > 0
    assert sp["stats"]["paged"]["cow_copies"] > 0


def test_spec_options_are_checked():
    tm = _shared()[2]
    with pytest.raises(ValueError, match="greedy-only"):
        PagedEngine(tm, device="cpu", temperature=0.5, **ENGINE, **SPEC)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        PagedEngine(tm, device="cpu", draft_layers=1, spec_k=0, **ENGINE)
    with pytest.raises(ValueError, match="speculative headroom"):
        PagedEngine(tm, device="cpu", draft_layers=1, spec_k=3,
                    max_slots=2, kv_block_size=8, max_len=48)
    eng = PagedEngine(tm, device="cpu", **ENGINE, **SPEC)
    # spec_k + 1 positions of headroom in whole blocks: 40 + 4 -> 48
    assert eng.padded_len == 48 and eng.draft_pools is not None
