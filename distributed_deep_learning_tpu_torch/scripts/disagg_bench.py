"""Disaggregated-serving bench: the counterpart of
``scripts/disagg_bench.py``.  The same trace through the unified paged
engine and through prefill and decode pools (``disagg_serving_bench``);
one JSON record on stdout, a summary line on stderr.

    python -m distributed_deep_learning_tpu_torch.scripts.disagg_bench
    python -m distributed_deep_learning_tpu_torch.scripts.disagg_bench \\
        --prefill-workers 2 --decode-workers 2 --devices 4
    python -m distributed_deep_learning_tpu_torch.scripts.disagg_bench \\
        --kv-dtype int8 --device cpu

``--devices N`` gives the pools N devices: card 0 repeated N times on
the card (one card stands in for the JAX script's emulated topology, so a
handoff is a copy on that card), the CPU repeated N times under
``--device cpu``; by default just enough for the worker pools, and at
least two, as the JAX script forces.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="disaggregated prefill/decode serving vs the "
                    "unified paged engine")
    p.add_argument("--requests", type=int, default=None,
                   help="trace size (default: DEFAULT_LOAD's 24)")
    p.add_argument("--prefill-workers", type=int, default=1)
    p.add_argument("--decode-workers", type=int, default=1)
    p.add_argument("--prefill-streams", type=int, default=4,
                   help="prompts batched per prefill-worker chunk call")
    p.add_argument("--max-slots", type=int, default=8,
                   help="decode slots per decode worker")
    p.add_argument("--decode-passes", type=int, default=2,
                   help="decode ticks per scheduler iteration")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--kv-dtype", type=str, default=None,
                   help="block-pool dtype (bf16/int8; unset = fp32)")
    p.add_argument("--devices", type=int, default=None,
                   help="this many devices for the pools, the one device "
                        "repeated (default: just enough for the worker "
                        "pools)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (card 0) or cpu")
    args = p.parse_args(argv)

    import torch

    from distributed_deep_learning_tpu_torch import resolve_device
    from distributed_deep_learning_tpu_torch.serve.bench import (
        disagg_serving_bench)

    need = args.devices or (args.prefill_workers + args.decode_workers)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    rec = disagg_serving_bench(
        seed=args.seed, device=dev, devices=[dev] * max(need, 2),
        load_kw=(dict(n_requests=args.requests)
                 if args.requests is not None else None),
        prefill_workers=args.prefill_workers,
        decode_workers=args.decode_workers,
        prefill_streams=args.prefill_streams,
        max_slots=args.max_slots,
        kv_block_size=args.kv_block_size,
        prefill_chunk=args.prefill_chunk,
        kv_dtype=args.kv_dtype,
        decode_passes=args.decode_passes)
    print(json.dumps(rec))
    u, d = rec["unified"], rec["disagg"]
    print(f"disagg {d['tokens_per_sec']:.0f} tok/s vs unified "
          f"{u['tokens_per_sec']:.0f} tok/s = {rec['speedup']}x | "
          f"itl p99 {d['itl_p99_s'] * 1e3:.2f}ms vs "
          f"{u['itl_p99_s'] * 1e3:.2f}ms | migration "
          f"{rec['migration_gbps']} GB/s | agreement "
          f"{rec['token_agreement']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
