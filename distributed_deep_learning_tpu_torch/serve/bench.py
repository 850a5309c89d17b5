"""Paged serving bench: the port of the paged half of
``distributed_deep_learning_tpu/serve/bench.py``.

:func:`paged_serving_bench` drives one seeded trace-driven load
(:mod:`.load`: Poisson arrivals, bimodal prompt lengths, a shared system
prompt, per-request SLOs) through :class:`.engine.PagedEngine` and
returns one JSON-able record.  Load shapes live here (``DEFAULT_LOAD``),
as in the JAX package, so every caller benches the same story.  The JAX
bench's A/B against its slot engine is not ported (the slot engine is
ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.models.transformer import CausalLM
from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
from distributed_deep_learning_tpu_torch.serve.load import (LoadSpec,
                                                            make_load)
from distributed_deep_learning_tpu_torch.serve.scheduler import Request

#: CPU-sized default model geometry (the JAX bench's)
DEFAULT_MODEL = dict(vocab_size=512, num_layers=2, d_model=128,
                     num_heads=4, mlp_dim=256, max_len=160)

#: default trace for the paged bench (the JAX bench's): Poisson arrivals,
#: bimodal prompt lengths, 60% of requests opening with one shared
#: 32-token system prompt, per-request TTFT/e2e SLOs
DEFAULT_LOAD = dict(n_requests=24, arrival="poisson", rate=2.0,
                    prompt_short=(4, 16), prompt_long=(40, 72),
                    long_frac=0.3, shared_prefix_len=32, shared_frac=0.6,
                    new_tokens=(4, 32), slo_ttft_ms=2000.0,
                    slo_e2e_ms=15000.0)


def build_model(seed: int = 0, device="cuda", **overrides) -> CausalLM:
    """A :class:`CausalLM` with seeded random weights on ``device``.  The
    weights are drawn on the CPU from a ``torch.Generator``, so a seed
    gives the same weights on every device."""
    dev = resolve_device(device)
    model = CausalLM(**{**DEFAULT_MODEL, **overrides})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def make_trace(n_requests: int, *, vocab_size: int, seed: int = 0,
               prompt_lens: tuple[int, int] = (4, 48),
               new_tokens: tuple[int, int] = (4, 64),
               stagger: int = 0) -> list[Request]:
    """Seeded mixed-length trace.  ``prompt_lens``/``new_tokens`` are
    inclusive uniform ranges; ``stagger`` is the mean inter-arrival gap
    in decode ticks (0 = every request queued at tick 0)."""
    rng = np.random.default_rng(seed)
    reqs, tick = [], 0
    for uid in range(n_requests):
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        n = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        prompt = rng.integers(1, vocab_size, p).astype(np.int32)
        reqs.append(Request(uid, prompt, n, arrival_tick=tick))
        if stagger:
            tick += int(rng.integers(0, 2 * stagger + 1))
    return reqs


def run_paged(model, requests: Sequence[Request], **engine_kw) -> dict:
    """One :class:`PagedEngine` lifetime over the trace; returns its
    ``{"results", "errors", "stats"}``."""
    return PagedEngine(model, **engine_kw).run(requests)


def paged_max_len(model_max_len: int, kv_block_size: int) -> int:
    """Largest engine ``max_len`` a model geometry supports: the paged
    cache rounds capacity to whole blocks inside the model's positions."""
    cap = (model_max_len // kv_block_size) * kv_block_size
    if cap < kv_block_size:
        raise ValueError(f"model max_len {model_max_len} too small for "
                         f"block size {kv_block_size}")
    return cap


def _rounded(d: dict) -> dict:
    return {k: (round(v, 5) if isinstance(v, float) else v)
            for k, v in d.items()}


def paged_serving_bench(*, seed: int = 0, device="cuda",
                        load_kw: Optional[dict] = None,
                        model_kw: Optional[dict] = None,
                        max_slots: int = 8, kv_block_size: int = 16,
                        prefill_chunk: int = 32,
                        decode_attention: str = "kernel") -> dict:
    """One trace-driven load (``DEFAULT_LOAD`` overridden by ``load_kw``)
    through :class:`PagedEngine` on a seeded model (``DEFAULT_MODEL``
    overridden by ``model_kw``).  Besides the summary the record holds
    ``results`` (uid -> generated tokens) and ``budgets`` (uid ->
    ``max_new_tokens``), so a caller can check every request."""
    model = build_model(seed, device, **(model_kw or {}))
    spec = LoadSpec(**{**DEFAULT_LOAD, **(load_kw or {})})
    cap = paged_max_len(model.max_len, kv_block_size)
    need = spec.shared_prefix_len + spec.prompt_long[1] + spec.new_tokens[1]
    if need > cap:
        raise ValueError(
            f"trace upper bound {need} tokens exceeds paged capacity "
            f"{cap} (model max_len {model.max_len})")
    trace = make_load(spec, vocab_size=model.vocab_size, seed=seed)
    res = run_paged(model, trace, device=device, max_slots=max_slots,
                    max_len=cap, kv_block_size=kv_block_size,
                    prefill_chunk=min(prefill_chunk, cap),
                    decode_attention=decode_attention)
    ps = res["stats"]
    return {
        "metric": "paged serving under trace-driven SLO load",
        "device": ps["device"],
        "model": {**DEFAULT_MODEL, **(model_kw or {})},
        "load": {**DEFAULT_LOAD, **(load_kw or {})},
        "max_slots": max_slots,
        "kv_block_size": kv_block_size,
        "prefill_chunk": prefill_chunk,
        "decode_attention": decode_attention,
        "errors": len(res["errors"]),
        "paged_engine": {
            "tokens_per_sec": ps["tokens_per_sec"],
            "generated_tokens": ps["generated_tokens"],
            "total_seconds": ps["total_seconds"],
            "kv_cache_bytes": ps["kv_cache_bytes"],
            "prefill_seconds": ps["prefill_seconds"],
            "decode_seconds": ps["decode_seconds"],
            "mean_slot_occupancy": ps["mean_slot_occupancy"],
            "prefill_chunks": ps["prefill_chunks"],
            "decode_ticks": ps["decode_ticks"],
            "paged_decode_launches": ps["paged_decode_launches"],
            "prefix_hit_rate": ps["paged"]["prefix_hit_rate"],
            "slo_attainment": ps["slo"]["slo_attainment"],
            "paged": ps["paged"],
            "slo": ps["slo"],
            "latency": _rounded(ps["latency"]),
        },
        "results": {uid: [int(t) for t in toks]
                    for uid, toks in res["results"].items()},
        "budgets": {r.uid: r.max_new_tokens for r in trace},
    }
