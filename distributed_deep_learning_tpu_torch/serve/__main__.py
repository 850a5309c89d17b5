"""Paged serving bench CLI of the port: one JSON record on stdout.

    python -m distributed_deep_learning_tpu_torch.serve --paged
    python -m distributed_deep_learning_tpu_torch.serve --paged \\
        --layers 12 --d-model 768 --heads 12 --mlp-dim 3072 --vocab 32768 \\
        --max-len 1024 --prefill-chunk 64 --shared-prefix-len 64

The flags are the subset of ``scripts/serve_bench.py`` that the port's
paged engine supports, plus ``--device`` (``cuda`` unless given).  The
slot-engine A/B, speculation, quantization and telemetry flags are not
ported (ROADMAP.md queue 1 items 6, 7 and 14).  A human latency line
goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_deep_learning_tpu_torch.serve",
        description="paged serving bench of the PyTorch port")
    p.add_argument("--paged", action="store_true",
                   help="bench the paged engine (the only engine ported)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt-min", type=int, default=None)
    p.add_argument("--prompt-max", type=int, default=None)
    p.add_argument("--new-min", type=int, default=None)
    p.add_argument("--new-max", type=int, default=None)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--arrival", choices=("front", "poisson", "bursty"),
                   default=None)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--shared-prefix-len", type=int, default=None)
    p.add_argument("--shared-frac", type=float, default=None)
    p.add_argument("--slo-ttft-ms", type=float, default=None)
    p.add_argument("--slo-e2e-ms", type=float, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--d-model", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--mlp-dim", type=int, default=None)
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not args.paged:
        p.error("only the paged engine is ported: pass --paged (the slot "
                "engine is ROADMAP.md queue 1 item 6)")

    from distributed_deep_learning_tpu_torch.serve.bench import \
        paged_serving_bench

    model_kw = {k: v for k, v in (
        ("num_layers", args.layers), ("d_model", args.d_model),
        ("num_heads", args.heads), ("mlp_dim", args.mlp_dim),
        ("vocab_size", args.vocab), ("max_len", args.max_len),
    ) if v is not None}
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
            prefill_chunk=args.prefill_chunk)
    except ValueError as e:
        p.error(f"{e} — shrink the trace (--prompt-max / --new-max / "
                "--shared-prefix-len) or raise --max-len")
    record.pop("results")
    record.pop("budgets")
    pe = record["paged_engine"]
    lat = pe["latency"]
    print(f"paged: {pe['generated_tokens']} tokens at "
          f"{pe['tokens_per_sec']:.1f} tok/s on {record['device']}, ttft "
          f"p50={lat['ttft_p50_s'] * 1e3:.1f}ms p99="
          f"{lat['ttft_p99_s'] * 1e3:.1f}ms, e2e p50={lat['e2e_p50_s']:.3f}s"
          f" p99={lat['e2e_p99_s']:.3f}s, prefix_hit_rate="
          f"{pe['prefix_hit_rate']:.3f}", file=sys.stderr)
    out = json.dumps(record)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
