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
* :func:`quantized_serving_bench`, :func:`fleet_serving_bench` and
  :func:`disagg_serving_bench`: JAX's quantized A/B, fleet and
  disaggregation benches, on the port's engines.

Both take the engines' serving options: ``kv_dtype`` and ``weight_dtype``
(the records carry the KV and weight bytes, and under int8 weights the
:func:`.quant.calibrate_weight_drift` record on a probe of the trace's
prompts), and for the paged bench ``draft_layers``/``spec_k`` (the
capacity keeps ``spec_k + 1`` positions of headroom; the record carries
the ``spec`` stats).

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
from distributed_deep_learning_tpu_torch.serve import quant
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


#: the fleet's priority mix: a quarter interactive (priority 0, never
#: preempted or shed), half standard, a quarter batch
DEFAULT_PRIORITY_CLASSES = ((0, 0.25), (1, 0.5), (2, 0.25))


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


def run_engine(model, requests: Sequence[Request], telemetry=None,
               **engine_kw) -> dict:
    """One :class:`ServeEngine` lifetime over the trace; returns its
    ``{"results", "errors", "stats"}``."""
    return ServeEngine(model, **engine_kw).run(requests, telemetry=telemetry)


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


def _weight_drift(model, trace, weight_dtype):
    """The declared int8 weight-drift record on a probe of the trace's
    first prompts (at most 64 tokens), as the JAX quantized bench makes
    it; None for other weights."""
    if weight_dtype != "int8":
        return None
    probe = np.concatenate([np.asarray(r.prompt) for r in trace[:4]])[:64]
    return quant.calibrate_weight_drift(
        model, quant.quantize_weights(model, weight_dtype), probe)


def serving_bench(*, seed: int = 0, device="cuda", n_requests: int = 32,
                  model_kw: Optional[dict] = None,
                  prompt_lens: tuple[int, int] = (4, 48),
                  new_tokens: tuple[int, int] = (4, 64),
                  max_slots: int = 8, stagger: int = 0,
                  skip_naive: bool = False, kv_dtype: Optional[str] = None,
                  weight_dtype: Optional[str] = None, telemetry=None) -> dict:
    """The slot engine against the naive baseline on one seeded
    mixed-length trace (:func:`make_trace`) and a seeded model
    (``DEFAULT_MODEL`` overridden by ``model_kw``).  Besides the summary
    the record holds ``results`` (uid -> the engine's tokens) and
    ``budgets`` (uid -> ``max_new_tokens``).  ``telemetry`` (an
    :class:`..obs.RunTelemetry`) records the engine's run, as JAX's does."""
    model = build_model(seed, device, **(model_kw or {}))
    if prompt_lens[1] + new_tokens[1] > model.max_len:
        raise ValueError(
            f"trace upper bounds {prompt_lens[1]}+{new_tokens[1]} exceed "
            f"max_len {model.max_len}")
    trace = make_trace(n_requests, vocab_size=model.vocab_size, seed=seed,
                       prompt_lens=prompt_lens, new_tokens=new_tokens,
                       stagger=stagger)
    eng = run_engine(model, trace, telemetry=telemetry, device=device,
                     max_slots=max_slots, kv_dtype=kv_dtype,
                     weight_dtype=weight_dtype)
    record = {
        "metric": "serving throughput tokens/sec (mixed-length trace)",
        "device": eng["stats"]["device"],
        "model": {**DEFAULT_MODEL, **(model_kw or {})},
        "kv_dtype": kv_dtype,
        "weight_dtype": weight_dtype,
        "weight_drift": _weight_drift(model, trace, weight_dtype),
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
        "weight_bytes": es["weight_bytes"],
        "prefill_seconds": es["prefill_seconds"],
        "decode_seconds": es["decode_seconds"],
        "mean_slot_occupancy": es["mean_slot_occupancy"],
        "prefill_calls": es["prefill_calls"],
        "decode_ticks": es["decode_ticks"],
        "decode_captures": es["decode_captures"],
        "nonfinite_tokens": es["nonfinite_tokens"],
        "latency": _rounded(es["latency"]),
    }


def run_paged(model, requests: Sequence[Request], telemetry=None,
              **engine_kw) -> dict:
    """One :class:`PagedEngine` lifetime over the trace; returns its
    ``{"results", "errors", "stats"}``."""
    return PagedEngine(model, **engine_kw).run(requests, telemetry=telemetry)


def run_supervised(model, requests: Sequence[Request], *,
                   paged: bool = False,
                   deadline_ms: Optional[float] = None, retries: int = 2,
                   stall_timeout_s: Optional[float] = None,
                   reload_watch: Optional[str] = None,
                   canary_slots: int = 2,
                   admission: Optional[dict] = None,
                   **engine_kw) -> dict:
    """One SUPERVISED engine lifetime over the trace: the same
    ``{"results", "errors", "stats"}`` contract as :func:`run_engine` /
    :func:`run_paged`, with the engine run under
    :class:`.supervisor.ServeSupervisor` — tick watchdog, crash
    containment with zero-loss replay, per-request deadlines and bounded
    retries.  ``reload_watch`` adds hot weight reload
    (:class:`.reload.ReloadManager` watching that directory, with
    ``canary_slots`` of canary before promote); ``admission`` is a kwargs
    dict for :class:`.admission.AdmissionController`
    (``utils.config.parse_admission_arg`` makes it from the CLI).  The
    engine-level stats land under ``stats["engine"]``."""
    from distributed_deep_learning_tpu_torch.serve.admission import \
        AdmissionController
    from distributed_deep_learning_tpu_torch.serve.reload import \
        ReloadManager
    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor

    eng = (PagedEngine if paged else ServeEngine)(model, **engine_kw)
    rm = (ReloadManager(reload_watch, canary_slots=canary_slots)
          if reload_watch is not None else None)
    adm = AdmissionController(**admission) if admission is not None \
        else None
    sup = ServeSupervisor(eng, deadline_ms=deadline_ms, retries=retries,
                          stall_timeout_s=stall_timeout_s, reload=rm,
                          admission=adm)
    return sup.run(requests)


def paged_max_len(model_max_len: int, kv_block_size: int,
                  draft: bool = False, spec_k: int = 4) -> int:
    """Largest engine ``max_len`` a model geometry supports: the paged
    cache rounds capacity up to whole blocks and, speculating, needs
    ``spec_k + 1`` positions of verify headroom, all inside the model's
    positions."""
    head = spec_k + 1 if draft else 0
    cap = (model_max_len // kv_block_size) * kv_block_size - head
    if cap < kv_block_size:
        raise ValueError(
            f"model max_len {model_max_len} too small for block size "
            f"{kv_block_size} (+{head} speculative headroom)")
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
                        draft_layers: Optional[int] = None, spec_k: int = 4,
                        kv_dtype: Optional[str] = None,
                        weight_dtype: Optional[str] = None,
                        compare_engine: bool = True, telemetry=None) -> dict:
    """One trace-driven load (``DEFAULT_LOAD`` overridden by ``load_kw``)
    through :class:`PagedEngine` on a seeded model (``DEFAULT_MODEL``
    overridden by ``model_kw``).  Besides the summary the record holds
    ``results`` (uid -> generated tokens) and ``budgets`` (uid ->
    ``max_new_tokens``), so a caller can check every request.

    ``compare_engine``: the same trace through the slot engine as well
    (``engine_v1``, its tokens under ``results_v1``), with
    ``prefill_tokens_saved_frac`` and ``speedup_vs_v1``.  The slot engine
    prefills each prompt at its true length (the flax one at its padded
    bucket), so its ``prefill_tokens_computed`` is the prompts' total.
    ``telemetry`` records the paged engine's run (not the comparison
    leg's), as JAX's does."""
    model = build_model(seed, device, **(model_kw or {}))
    spec = LoadSpec(**{**DEFAULT_LOAD, **(load_kw or {})})
    cap = paged_max_len(model.max_len, kv_block_size,
                        draft_layers is not None, spec_k)
    need = spec.shared_prefix_len + spec.prompt_long[1] + spec.new_tokens[1]
    if need > cap:
        raise ValueError(
            f"trace upper bound {need} tokens exceeds paged capacity "
            f"{cap} (model max_len {model.max_len})")
    trace = make_load(spec, vocab_size=model.vocab_size, seed=seed)
    res = run_paged(model, trace, telemetry=telemetry, device=device,
                    max_slots=max_slots,
                    max_len=cap, kv_block_size=kv_block_size,
                    prefill_chunk=min(prefill_chunk, cap),
                    decode_attention=decode_attention,
                    draft_layers=draft_layers, spec_k=spec_k,
                    kv_dtype=kv_dtype, weight_dtype=weight_dtype)
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
        "kv_dtype": kv_dtype,
        "weight_dtype": weight_dtype,
        "weight_drift": _weight_drift(model, trace, weight_dtype),
        "errors": len(res["errors"]),
        "paged_engine": {
            "tokens_per_sec": ps["tokens_per_sec"],
            "generated_tokens": ps["generated_tokens"],
            "total_seconds": ps["total_seconds"],
            "kv_cache_bytes": ps["kv_cache_bytes"],
            "weight_bytes": ps["weight_bytes"],
            "prefill_seconds": ps["prefill_seconds"],
            "decode_seconds": ps["decode_seconds"],
            "mean_slot_occupancy": ps["mean_slot_occupancy"],
            "prefill_chunks": ps["prefill_chunks"],
            "decode_ticks": ps["decode_ticks"],
            "paged_decode_launches": ps["paged_decode_launches"],
            "decode_captures": ps["decode_captures"],
            "draft_captures": ps["draft_captures"],
            "verify_captures": ps["verify_captures"],
            "nonfinite_tokens": ps["nonfinite_tokens"],
            "prefix_hit_rate": ps["paged"]["prefix_hit_rate"],
            "slo_attainment": ps["slo"]["slo_attainment"],
            "spec_acceptance": ps["spec"]["acceptance_rate"],
            "paged": ps["paged"],
            "spec": ps["spec"],
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


def _token_agreement(a: dict, b: dict) -> float:
    """Fraction of greedy tokens identical between two result maps (uid
    -> token array) over their shared uids."""
    total = same = 0
    for uid, toks in a.items():
        if uid not in b:
            continue
        other = np.asarray(b[uid])
        toks = np.asarray(toks)
        n = min(len(toks), len(other))
        total += n
        same += int(np.sum(toks[:n] == other[:n]))
    return same / total if total else 1.0


def quantized_serving_bench(*, seed: int = 0, device="cuda",
                            load_kw: Optional[dict] = None,
                            model_kw: Optional[dict] = None,
                            max_slots: int = 8, kv_block_size: int = 16,
                            prefill_chunk: int = 32, kv_dtype: str = "int8",
                            weight_dtype: str = "int8") -> dict:
    """The quantized-serving A/B (JAX's record): the same trace through
    the paged engine at full precision and again with ``kv_dtype`` pools
    and ``weight_dtype`` weights.  ``kv_shrink_x`` is the measured pool
    bytes' ratio, ``max_context_at_budget`` the KV positions that fit the
    full-precision pools' bytes under each representation, and
    ``logprob_drift`` the calibrated int8 weight drift on a probe of the
    trace's prompts.  The JAX record's compile counts are the decode
    tick's captures here."""
    model = build_model(seed, device, **(model_kw or {}))
    spec = LoadSpec(**{**DEFAULT_LOAD, **(load_kw or {})})
    cap = paged_max_len(model.max_len, kv_block_size, False, 0)
    trace = make_load(spec, vocab_size=model.vocab_size, seed=seed)
    engine_kw = dict(device=device, max_slots=max_slots, max_len=cap,
                     kv_block_size=kv_block_size,
                     prefill_chunk=min(prefill_chunk, cap))
    base = run_paged(model, trace, **engine_kw)
    bs_ = base["stats"]
    q = run_paged(model, trace, kv_dtype=kv_dtype,
                  weight_dtype=weight_dtype, **engine_kw)
    qs = q["stats"]
    positions = bs_["paged"]["blocks_total"] * kv_block_size
    budget = bs_["kv_cache_bytes"]
    base_ctx = int(budget // (bs_["kv_cache_bytes"] / positions))
    quant_ctx = int(budget // (qs["kv_cache_bytes"] / positions))
    drift = _weight_drift(model, trace, weight_dtype) if weight_dtype else {
        "measured_max_drift": 0.0, "declared_bound": 0.0,
        "probe_argmax_agreement": 1.0, "probe_tokens": 0}
    return {
        "metric": "quantized serving hot path A/B (paged engine)",
        "device": bs_["device"],
        "model": {**DEFAULT_MODEL, **(model_kw or {})},
        "load": {**DEFAULT_LOAD, **(load_kw or {})},
        "max_slots": max_slots,
        "kv_block_size": kv_block_size,
        "kv_dtype": kv_dtype,
        "weight_dtype": weight_dtype,
        "errors": len(base["errors"]) + len(q["errors"]),
        "baseline": {
            "tokens_per_sec": round(bs_["tokens_per_sec"], 2),
            "kv_cache_bytes": bs_["kv_cache_bytes"],
            "kv_bytes_per_slot": bs_["kv_cache_bytes"] // max_slots,
            "max_context_at_budget": base_ctx,
            "decode_captures": bs_["decode_captures"],
        },
        "quantized": {
            "tokens_per_sec": round(qs["tokens_per_sec"], 2),
            "kv_cache_bytes": qs["kv_cache_bytes"],
            "kv_bytes_per_slot": qs["kv_cache_bytes"] // max_slots,
            "max_context_at_budget": quant_ctx,
            "decode_captures": qs["decode_captures"],
            "weight_bytes": qs["weight_bytes"],
        },
        "kv_shrink_x": round(
            bs_["kv_cache_bytes"] / qs["kv_cache_bytes"], 3),
        "token_agreement": round(
            _token_agreement(base["results"], q["results"]), 4),
        "logprob_drift": round(drift["measured_max_drift"], 5),
        "declared_drift_bound": round(drift["declared_bound"], 5),
        "probe_argmax_agreement": drift["probe_argmax_agreement"],
    }


def fleet_serving_bench(*, seed: int = 0, device="cuda", replicas: int = 3,
                        load_kw: Optional[dict] = None,
                        model_kw: Optional[dict] = None,
                        max_slots: int = 4, kv_block_size: int = 16,
                        prefill_chunk: int = 32, telemetry=None) -> dict:
    """Throughput and routing quality of a :class:`.fleet.FleetRouter`
    over ``replicas`` paged engines sharing one model, on the shared-prefix
    Poisson trace with priority classes (JAX's record)."""
    from distributed_deep_learning_tpu_torch.serve.fleet import FleetRouter

    model = build_model(seed, device, **(model_kw or {}))
    spec = LoadSpec(**{**DEFAULT_LOAD,
                       "priority_classes": DEFAULT_PRIORITY_CLASSES,
                       **(load_kw or {})})
    trace = make_load(spec, vocab_size=model.vocab_size, seed=seed)
    cap = paged_max_len(model.max_len, kv_block_size, False, 0)
    engines = [PagedEngine(model, device=device, max_slots=max_slots,
                           max_len=cap, kv_block_size=kv_block_size,
                           prefill_chunk=prefill_chunk)
               for _ in range(replicas)]
    flt = FleetRouter(engines, telemetry=telemetry)
    t0 = time.perf_counter()
    out = flt.run(list(trace))
    total = time.perf_counter() - t0
    st = out["stats"]
    tokens = int(sum(len(v) for v in out["results"].values()))
    return {
        "metric": "fleet serving: routed throughput / SLO by priority",
        "replicas": replicas,
        "requests": st["requests"],
        "completed": st["completed"],
        "requests_lost": st["requests_lost"],
        "errors": len(out["errors"]),
        "generated_tokens": tokens,
        "tokens_per_sec": round(tokens / total, 2) if total else None,
        "rounds": st["rounds"],
        "routing": st["routing"],
        "health": st["health"],
        "decode_captures_max": max(
            v["decode_captures"] for v in st["per_replica"].values()),
        "slo_attainment": st["slo"]["slo_attainment"],
        "slo_by_priority": {
            p: s["slo_attainment"]
            for p, s in st["slo"].get("by_priority", {}).items()},
    }


def disagg_serving_bench(*, seed: int = 0, device="cuda", devices=None,
                         load_kw: Optional[dict] = None,
                         model_kw: Optional[dict] = None,
                         prefill_workers: int = 1, decode_workers: int = 1,
                         prefill_streams: int = 4, max_slots: int = 8,
                         kv_block_size: int = 16, prefill_chunk: int = 32,
                         kv_dtype: Optional[str] = None,
                         decode_passes: int = 2, telemetry=None,
                         model: Optional[CausalLM] = None,
                         trace: Optional[Sequence[Request]] = None) -> dict:
    """The disaggregation A/B (JAX's record): the same trace through the
    unified :class:`PagedEngine` and through
    :class:`.disagg.DisaggEngine`.  Both engines are warmed on the trace
    and reset before the timed runs, and the migrator's stats are zeroed
    after the warm run.  ``speedup`` is disagg / unified tokens/s;
    ``migration_gbps`` comes from four synchronised moves of one slot's
    blocks; ``token_agreement`` holds the greedy outputs together.

    ``devices`` (default ``[device, device]``: both pools on one card)
    are the workers' devices; ``model``/``trace`` replace the seeded
    ones (a caller's model at its own width)."""
    from distributed_deep_learning_tpu_torch.serve import migrate as \
        migrate_mod
    from distributed_deep_learning_tpu_torch.serve.disagg import \
        DisaggEngine

    if model is None:
        model = build_model(seed, device, **(model_kw or {}))
    cap = paged_max_len(model.max_len, kv_block_size, False, 0)
    if trace is None:
        spec = LoadSpec(**{**DEFAULT_LOAD, **(load_kw or {})})
        trace = make_load(spec, vocab_size=model.vocab_size, seed=seed)
    dev = next(model.parameters()).device
    if devices is None:
        devices = [dev] * (prefill_workers + decode_workers)
    uni = PagedEngine(model, device=dev, max_slots=max_slots, max_len=cap,
                      kv_block_size=kv_block_size,
                      prefill_chunk=min(prefill_chunk, cap),
                      kv_dtype=kv_dtype)
    dis = DisaggEngine(model, prefill_workers=prefill_workers,
                       decode_workers=decode_workers,
                       prefill_streams=prefill_streams,
                       max_slots=max_slots, max_len=cap,
                       kv_block_size=kv_block_size,
                       prefill_chunk=min(prefill_chunk, cap),
                       kv_dtype=kv_dtype, decode_passes=decode_passes,
                       devices=devices, telemetry=telemetry)
    # warm both arms (kernel builds, graph captures), then reset
    uni.run(list(trace))
    uni.reset()
    dis.run(list(trace))
    dis.reset()
    dis.migrator.stats = migrate_mod.MigrationStats()

    du = uni.run(list(trace))
    dd = dis.run(list(trace), telemetry=telemetry)
    us, ds = du["stats"], dd["stats"]

    # synchronised migration bandwidth: one slot's blocks moved from the
    # prefill to the decode pool four times, waiting for each
    pw, dw = dis.prefill[0], dis.decode[0]
    nb = pw.eng.blocks_per_slot
    ids = np.arange(nb)
    dis.migrator.stats = migrate_mod.MigrationStats()
    for _ in range(4):
        dw.eng.pools = dis.migrator.migrate(
            pw.eng.pools, dw.eng.pools, ids, ids, device=dw.device,
            sync=True, trace_id="bench")
    sync_stats = dis.migrator.stats
    at_rest_per_block = sync_stats.wire_bytes / sync_stats.blocks
    wire_shrink = None
    if kv_dtype != "int8":
        m8 = migrate_mod.BlockMigrator(nb, wire="int8")
        dw.eng.pools = m8.migrate(pw.eng.pools, dw.eng.pools, ids, ids,
                                  device=dw.device, trace_id="bench")
        wire_shrink = round(
            at_rest_per_block / (m8.stats.wire_bytes / m8.stats.blocks), 3)

    speedup = (round(ds["tokens_per_sec"] / us["tokens_per_sec"], 3)
               if us["tokens_per_sec"] else None)
    ul, dl = us["latency"], ds["latency"]
    return {
        "metric": "disaggregated prefill/decode vs unified paged engine",
        "device": str(dev),
        "model": {**DEFAULT_MODEL, **(model_kw or {})},
        "load": {**DEFAULT_LOAD, **(load_kw or {})},
        "prefill_workers": prefill_workers,
        "decode_workers": decode_workers,
        "prefill_streams": prefill_streams,
        "max_slots": max_slots,
        "kv_block_size": kv_block_size,
        "kv_dtype": kv_dtype,
        "decode_passes": decode_passes,
        "errors": len(du["errors"]) + len(dd["errors"]),
        "unified": {
            "tokens_per_sec": round(us["tokens_per_sec"], 2),
            "kv_cache_bytes": us["kv_cache_bytes"],
            "decode_captures": us["decode_captures"],
            "itl_p99_s": ul["itl_p99_s"],
            "ttft_p99_s": ul["ttft_p99_s"],
        },
        "disagg": {
            "tokens_per_sec": round(ds["tokens_per_sec"], 2),
            "kv_cache_bytes": ds["kv_cache_bytes"],
            "decode_captures": ds["decode_captures"],
            "paged_decode_launches": ds["paged_decode_launches"],
            "decode_ticks": ds["decode_ticks"],
            "prefill_util": ds["prefill_util"],
            "prefill_chunk_calls": ds["prefill_chunk_calls"],
            "itl_p99_s": dl["itl_p99_s"],
            "ttft_p99_s": dl["ttft_p99_s"],
            "migration": ds["migration"],
        },
        "speedup": speedup,
        # > 1 means disagg's inter-token gaps are worse than unified's
        "itl_p99_ratio": (round(dl["itl_p99_s"] / ul["itl_p99_s"], 3)
                          if ul["itl_p99_s"] else None),
        "token_agreement": round(
            _token_agreement(du["results"], dd["results"]), 4),
        "migration_gbps": round(sync_stats.gb_per_s(), 3),
        "migration_ms_per_move": round(
            1e3 * sync_stats.seconds / sync_stats.moves, 3),
        "wire_bytes_per_block": int(at_rest_per_block),
        "int8_wire_shrink_x": wire_shrink,
    }
