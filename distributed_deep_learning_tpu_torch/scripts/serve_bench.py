"""Serving bench: the counterpart of ``scripts/serve_bench.py``.  One JSON
record on stdout, a human latency summary on stderr.

    python -m distributed_deep_learning_tpu_torch.scripts.serve_bench
    python -m distributed_deep_learning_tpu_torch.scripts.serve_bench --paged
    python -m distributed_deep_learning_tpu_torch.scripts.serve_bench --paged \\
        --layers 12 --d-model 768 --heads 12 --mlp-dim 3072 --vocab 32768 \\
        --max-len 1024 --prefill-chunk 64 --shared-prefix-len 64
    python -m distributed_deep_learning_tpu_torch.scripts.serve_bench --paged \\
        --draft 2 --spec-k 4 --kv-dtype int8 --weight-dtype int8
    python -m distributed_deep_learning_tpu_torch.scripts.serve_bench --paged \\
        --obs --obs-file events.jsonl --obs-trace trace.json

``python -m distributed_deep_learning_tpu_torch.serve`` is the same
program.  Without ``--paged`` the slot engine serves a mixed-length trace
against the batch-synchronous ``generate()`` baseline (``serving_bench``;
``--stagger``, ``--skip-naive``); with it the paged engine serves a
trace-driven SLO load, compared with the slot engine on the same trace
unless ``--skip-v1`` (``paged_serving_bench``).  ``--draft N`` speculates
with the target's first N layers (paged only), ``--kv-dtype`` and
``--weight-dtype`` store the KV cache and the weights in bf16 or int8
(int8 KV needs ``--paged``).  ``--obs`` records the engine's run as the
JAX script does: the JSONL event stream (``--obs-file``) and the
per-request span trace (``--obs-trace``), which
``scripts.obs_report`` renders.  The flags are the JAX script's, plus
``--device`` (``cuda`` unless given); ``--buckets`` is refused, since the
port's slot engine has no prefill buckets.  The record is JAX's, with its
compile counts as the decode tick's graph captures.
"""

from __future__ import annotations

import argparse
import json
import sys

#: why ``--buckets`` is refused
NO_BUCKETS = ("--buckets: the port's slot engine prefills each prompt at "
              "its true length and has no prefill buckets (serve/engine.py)"
              "; there is nothing to set")


def build_parser() -> argparse.ArgumentParser:
    """The serving bench's flags: ``scripts/serve_bench.py``'s, plus
    ``--device``."""
    p = argparse.ArgumentParser(
        description="serving bench of the PyTorch port: the slot engine "
                    "against generate(), or the paged engine")
    p.add_argument("--paged", action="store_true",
                   help="bench the paged engine under trace-driven SLO "
                        "load instead of the slot engine's A/B")
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt-min", type=int, default=None)
    p.add_argument("--prompt-max", type=int, default=None)
    p.add_argument("--new-min", type=int, default=None)
    p.add_argument("--new-max", type=int, default=None)
    p.add_argument("--stagger", type=int, default=0,
                   help="slot-engine trace: mean inter-arrival gap in "
                        "decode ticks (0 = all requests queued up front)")
    p.add_argument("--buckets", type=str, default=None,
                   help="refused: the slot engine has no prefill buckets")
    p.add_argument("--skip-naive", action="store_true",
                   help="slot-engine mode: engine only")
    p.add_argument("--skip-v1", action="store_true",
                   help="paged mode: skip the slot-engine comparison leg")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--draft", type=int, default=0,
                   help="speculative decoding: draft layer count "
                        "(0 = off; the draft shares the target's weights)")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--arrival", choices=("front", "poisson", "bursty"),
                   default=None)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--shared-prefix-len", type=int, default=None)
    p.add_argument("--shared-frac", type=float, default=None)
    p.add_argument("--slo-ttft-ms", type=float, default=None)
    p.add_argument("--slo-e2e-ms", type=float, default=None)
    p.add_argument("--kv-dtype", default=None,
                   help="KV-cache storage dtype: bf16 or int8 (int8 "
                        "stores per-position scales in the block pools, "
                        "so it requires --paged; unset = full precision)")
    p.add_argument("--weight-dtype", default=None,
                   help="weight storage dtype: bf16 or int8 (int8 = "
                        "per-channel scales, each weight dequantized at "
                        "its use; unset = full precision)")
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--d-model", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--mlp-dim", type=int, default=None)
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--obs", action="store_true",
                   help="attach run telemetry: JSONL event stream "
                        "(--obs-file) + per-request span trace exported "
                        "as Chrome/Perfetto JSON (--obs-trace)")
    p.add_argument("--obs-file", default="obs_events.jsonl",
                   help="telemetry event stream path (with --obs)")
    p.add_argument("--obs-trace", default=None, metavar="PATH",
                   help="span-trace output path (default "
                        "serve_trace.json with --obs; giving a path "
                        "implies --obs)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.buckets is not None:
        p.error(NO_BUCKETS)

    from distributed_deep_learning_tpu_torch.serve.bench import (
        paged_serving_bench, serving_bench)
    from distributed_deep_learning_tpu_torch.utils.config import (
        serve_dtype_error)

    err = serve_dtype_error(args.kv_dtype, args.weight_dtype, args.paged)
    if err:
        p.error(err)
    quant_kw = dict(kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype)
    telemetry = None
    if args.obs or args.obs_trace:
        from distributed_deep_learning_tpu_torch.obs import RunTelemetry

        telemetry = RunTelemetry(
            path=args.obs_file,
            trace_path=args.obs_trace or "serve_trace.json",
            device=None if args.device == "cpu" else args.device)
    quant_kw["telemetry"] = telemetry

    model_kw = {k: v for k, v in (
        ("num_layers", args.layers), ("d_model", args.d_model),
        ("num_heads", args.heads), ("mlp_dim", args.mlp_dim),
        ("vocab_size", args.vocab), ("max_len", args.max_len),
    ) if v is not None}
    if not args.paged:
        try:
            record = serving_bench(
                seed=args.seed, device=args.device,
                n_requests=args.requests or 32, model_kw=model_kw,
                prompt_lens=(4 if args.prompt_min is None else args.prompt_min,
                             48 if args.prompt_max is None
                             else args.prompt_max),
                new_tokens=(4 if args.new_min is None else args.new_min,
                            64 if args.new_max is None else args.new_max),
                max_slots=args.max_slots, stagger=args.stagger,
                skip_naive=args.skip_naive, **quant_kw)
        except ValueError as e:
            p.error(f"{e} — shrink the trace (--prompt-max / --new-max) or "
                    "raise --max-len")
        for key in ("results", "budgets"):
            record.pop(key)
        _latency_line("slot", record["device"], record["engine"])
        return _finish(args, telemetry, record)

    load_kw = {k: v for k, v in (
        ("n_requests", args.requests), ("arrival", args.arrival),
        ("rate", args.rate), ("shared_prefix_len", args.shared_prefix_len),
        ("shared_frac", args.shared_frac),
        ("slo_ttft_ms", args.slo_ttft_ms), ("slo_e2e_ms", args.slo_e2e_ms),
    ) if v is not None}
    if args.prompt_min is not None or args.prompt_max is not None:
        lo = 4 if args.prompt_min is None else args.prompt_min
        hi = 48 if args.prompt_max is None else args.prompt_max
        if hi <= lo:
            p.error(f"--prompt-max must exceed --prompt-min "
                    f"(got {lo}..{hi})")
        mid = max(lo + 1, (lo + hi) // 2)
        load_kw["prompt_short"] = (lo, mid)
        load_kw["prompt_long"] = (mid, hi)
    if args.new_min is not None or args.new_max is not None:
        lo = 4 if args.new_min is None else args.new_min
        hi = 64 if args.new_max is None else args.new_max
        if hi <= lo:
            p.error(f"--new-max must exceed --new-min (got {lo}..{hi})")
        load_kw["new_tokens"] = (lo, hi)
    try:
        record = paged_serving_bench(
            seed=args.seed, device=args.device, load_kw=load_kw,
            model_kw=model_kw, max_slots=args.max_slots,
            kv_block_size=args.kv_block_size,
            prefill_chunk=args.prefill_chunk,
            draft_layers=args.draft or None, spec_k=args.spec_k,
            compare_engine=not args.skip_v1, **quant_kw)
    except ValueError as e:
        p.error(f"{e} — shrink the trace (--prompt-max / --new-max / "
                "--shared-prefix-len) or raise --max-len")
    for key in ("results", "budgets", "results_v1"):
        record.pop(key, None)
    pe = record["paged_engine"]
    _latency_line("paged", record["device"], pe)
    print(f"prefix_hit_rate={pe['prefix_hit_rate']:.3f} "
          f"slo_attainment={pe['slo_attainment']} "
          f"spec_acceptance={pe['spec_acceptance']}", file=sys.stderr)
    return _finish(args, telemetry, record)


def _finish(args, telemetry, record) -> int:
    if telemetry is not None:
        tr = telemetry.close().get("trace")
        if tr:
            print(f"obs: {tr['spans']} spans -> {tr['path']} "
                  f"(load in Perfetto / chrome://tracing); "
                  f"events -> {args.obs_file}", file=sys.stderr)
    print(json.dumps(record))
    return _write(args.out, record)


def _latency_line(tag: str, device: str, rec: dict) -> None:
    lat = rec["latency"]
    if not lat["measured_requests"]:
        return
    print(f"{tag}: {rec['generated_tokens']} tokens at "
          f"{rec['tokens_per_sec']:.1f} tok/s on {device}, ttft "
          f"p50={lat['ttft_p50_s'] * 1e3:.1f}ms p99="
          f"{lat['ttft_p99_s'] * 1e3:.1f}ms, itl p50="
          f"{lat['itl_p50_s'] * 1e3:.2f}ms p99={lat['itl_p99_s'] * 1e3:.2f}"
          f"ms, e2e p50={lat['e2e_p50_s']:.3f}s p99={lat['e2e_p99_s']:.3f}s",
          file=sys.stderr)


def _write(path, record) -> int:
    if path:
        with open(path, "w") as f:
            f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
