"""Serving benches: the port of
``distributed_deep_learning_tpu/serve/bench.py``.

* :func:`serving_bench` drives one seeded mixed-length trace
  (:func:`make_trace`) through the slot engine
  (:class:`.engine.ServeEngine`) and, unless skipped, through the
  batch-synchronous :func:`..models.transformer.generate` baseline
  (:func:`run_naive`: fixed batches in submission order, prompts padded to
  the batch's longest, every row decoded to the batch's largest budget).
  Tokens/s counts the tokens each request asked for, so the baseline's
  overshoot is wasted time.
* :func:`paged_serving_bench` drives one seeded trace-driven load
  (:mod:`.load`: Poisson arrivals, bimodal prompt lengths, a shared system
  prompt, per-request SLOs) through :class:`.engine.PagedEngine` and, as
  its comparison leg, through the slot engine on the same trace.

Each returns one JSON-able record.  Load shapes live here
(``DEFAULT_LOAD``), as in the JAX package, so every caller benches the
same story.  The JAX record's compile counts become ``decode_captures``
(the CUDA graph captures of the decode tick); the naive baseline, which
XLA recompiles for every new shape, has nothing to count here.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.models.transformer import (CausalLM,
                                                                     generate)
from distributed_deep_learning_tpu_torch.serve.engine import (PagedEngine,
                                                              ServeEngine)
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


def run_engine(model, requests: Sequence[Request], **engine_kw) -> dict:
    """One :class:`ServeEngine` lifetime over the trace; returns its
    ``{"results", "errors", "stats"}``."""
    return ServeEngine(model, **engine_kw).run(requests)


def run_naive(model, requests: Sequence[Request], batch_size: int) -> dict:
    """The run-to-completion baseline at the same concurrency: batches of
    ``batch_size`` in submission order (arrival ticks ignored, which is
    generous to it), prompts right-padded with the pad id to the batch's
    longest, decoded to the batch's largest budget by :func:`generate` on
    the model's device.  A padded row samples its first token after pad
    positions, so the baseline is only right when a batch's prompts share
    one length."""
    device = next(model.parameters()).device
    pad_fill = model.pad_id if model.pad_id is not None else 0
    results: dict[int, np.ndarray] = {}
    useful = decoded = 0
    t0 = time.perf_counter()
    for i in range(0, len(requests), batch_size):
        batch = requests[i:i + batch_size]
        pmax = max(len(r.prompt) for r in batch)
        nmax = max(r.max_new_tokens for r in batch)
        prompts = np.full((len(batch), pmax), pad_fill, np.int32)
        for j, r in enumerate(batch):
            prompts[j, :len(r.prompt)] = r.prompt
        out = generate(model, torch.from_numpy(prompts).to(device),
                       max_new_tokens=nmax).cpu().numpy()
        for j, r in enumerate(batch):
            results[r.uid] = out[j, :r.max_new_tokens]
            useful += r.max_new_tokens
        decoded += len(batch) * nmax
    total = time.perf_counter() - t0
    return {"results": results, "stats": {
        "requests": len(requests),
        "generated_tokens": useful,
        "decoded_tokens": decoded,
        "wasted_fraction": 1 - useful / decoded if decoded else 0,
        "tokens_per_sec": useful / total if total else None,
        "total_seconds": total,
        "batch_size": batch_size,
    }}


def serving_bench(*, seed: int = 0, device="cuda", n_requests: int = 32,
                  model_kw: Optional[dict] = None,
                  prompt_lens: tuple[int, int] = (4, 48),
                  new_tokens: tuple[int, int] = (4, 64),
                  max_slots: int = 8, stagger: int = 0,
                  skip_naive: bool = False) -> dict:
    """The slot engine against the naive baseline on one seeded
    mixed-length trace (:func:`make_trace`) and a seeded model
    (``DEFAULT_MODEL`` overridden by ``model_kw``).  Besides the summary
    the record holds ``results`` (uid -> the engine's tokens) and
    ``budgets`` (uid -> ``max_new_tokens``)."""
    model = build_model(seed, device, **(model_kw or {}))
    if prompt_lens[1] + new_tokens[1] > model.max_len:
        raise ValueError(
            f"trace upper bounds {prompt_lens[1]}+{new_tokens[1]} exceed "
            f"max_len {model.max_len}")
    trace = make_trace(n_requests, vocab_size=model.vocab_size, seed=seed,
                       prompt_lens=prompt_lens, new_tokens=new_tokens,
                       stagger=stagger)
    eng = run_engine(model, trace, device=device, max_slots=max_slots)
    record = {
        "metric": "serving throughput tokens/sec (mixed-length trace)",
        "device": eng["stats"]["device"],
        "model": {**DEFAULT_MODEL, **(model_kw or {})},
        "requests": n_requests,
        "prompt_lens": list(prompt_lens),
        "new_tokens": list(new_tokens),
        "max_slots": max_slots,
        "errors": len(eng["errors"]),
        "engine": _slot_summary(eng["stats"]),
        "results": {uid: [int(t) for t in toks]
                    for uid, toks in eng["results"].items()},
        "budgets": {r.uid: r.max_new_tokens for r in trace},
    }
    if not skip_naive:
        ns = run_naive(model, trace, batch_size=max_slots)["stats"]
        record["naive"] = {k: ns[k] for k in (
            "tokens_per_sec", "total_seconds", "wasted_fraction")}
        es = eng["stats"]
        record["speedup"] = es["tokens_per_sec"] / ns["tokens_per_sec"] \
            if ns["tokens_per_sec"] else None
    return record


def _slot_summary(es: dict) -> dict:
    return {
        "tokens_per_sec": es["tokens_per_sec"],
        "generated_tokens": es["generated_tokens"],
        "total_seconds": es["total_seconds"],
        "kv_cache_bytes": es["kv_cache_bytes"],
        "prefill_seconds": es["prefill_seconds"],
        "decode_seconds": es["decode_seconds"],
        "mean_slot_occupancy": es["mean_slot_occupancy"],
        "prefill_calls": es["prefill_calls"],
        "decode_ticks": es["decode_ticks"],
        "decode_captures": es["decode_captures"],
        "nonfinite_tokens": es["nonfinite_tokens"],
        "latency": _rounded(es["latency"]),
    }


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
                        decode_attention: str = "kernel",
                        compare_engine: bool = True) -> dict:
    """One trace-driven load (``DEFAULT_LOAD`` overridden by ``load_kw``)
    through :class:`PagedEngine` on a seeded model (``DEFAULT_MODEL``
    overridden by ``model_kw``).  Besides the summary the record holds
    ``results`` (uid -> generated tokens) and ``budgets`` (uid ->
    ``max_new_tokens``), so a caller can check every request.

    ``compare_engine``: the same trace through the slot engine as well
    (``engine_v1``, its tokens under ``results_v1``), with
    ``prefill_tokens_saved_frac`` and ``speedup_vs_v1``.  The slot engine
    prefills each prompt at its true length (the flax one at its padded
    bucket), so its ``prefill_tokens_computed`` is the prompts' total."""
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
    record = {
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
            "decode_captures": ps["decode_captures"],
            "nonfinite_tokens": ps["nonfinite_tokens"],
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
    if compare_engine:
        v1 = run_engine(model, trace, device=device, max_slots=max_slots)
        vs = v1["stats"]
        v1_prefill = sum(len(r.prompt) for r in trace
                         if r.uid not in v1["errors"])
        record["engine_v1"] = {**_slot_summary(vs),
                               "errors": len(v1["errors"]),
                               "prefill_tokens_computed": v1_prefill}
        record["results_v1"] = {uid: [int(t) for t in toks]
                                for uid, toks in v1["results"].items()}
        if v1_prefill:
            record["prefill_tokens_saved_frac"] = 1 - ps["paged"][
                "prefill_tokens_computed"] / v1_prefill
        if vs["tokens_per_sec"]:
            record["speedup_vs_v1"] = ps["tokens_per_sec"] / \
                vs["tokens_per_sec"]
    return record
