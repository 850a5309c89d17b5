#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, one card

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name and power limit as ``nvidia-smi`` reports them;
   no visible CUDA card is a failure;
2. build: compile the paged flash-decode kernel from the sources in the
   checkout (``nvcc``), with its build time and ``ptxas`` register report;
3. kernel vs plain: ``paged_flash_decode`` against ``paged_decode_reference``
   on the card at the serving path's decode shape, plus GQA, bf16, int8,
   ``valid_pool`` holes and an empty slot; median times of the kernel, the
   plain version and ``scaled_dot_product_attention`` on pre-gathered K/V
   (a yardstick the port never calls), beside the bytes bound;
4. the serving slice at full width (GPT-2-small shape, vocab 32768): the
   paged engine serves a seeded Poisson load with a shared prefix; checks
   errors, token budgets and ranges, prefix hits and that every decode
   tick launched the kernel once per layer;
5. the same trace with the decode attention switched to the plain
   version: first tokens must agree, and the overall greedy agreement is
   printed.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
KERNEL_SOURCE = "distributed_deep_learning_tpu_torch/csrc/paged_decode.cu"
KERNEL_REPLACES = ("distributed_deep_learning_tpu/ops/paged_decode_pallas.py"
                   ":66 (_decode_kernel)")

#: the serving slice's decode shape: 8 slots, GPT-2-small heads, 1024-token
#: slots in 16-position blocks, pools sized as the engine sizes them
DECODE_SHAPE = dict(B=8, Hkv=12, G=1, D=64, bs=16, Bps=64,
                    N=2 * 8 * 64 + 1)
TOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-2}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return line


def phase_build():
    from distributed_deep_learning_tpu_torch.ops import paged_decode as pd

    t0 = time.perf_counter()
    path, log = pd.build()
    print(f"build: {time.perf_counter() - t0:.2f}s -> "
          f"{path.relative_to(pd.BUILD_DIR.parents[1])}")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas {ln.strip()}")


# --- phase 3 ---------------------------------------------------------------


def _decode_case(*, B, Hkv, G, D, bs, Bps, N, lens, kv="f32", holes=False,
                 seed=0, device="cuda"):
    """Seeded decode inputs on the card: pools of N blocks (block 0 the
    trash block), each slot's live blocks at distinct random physical ids,
    table tails trash-padded."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device(device)
    need = [-(-n // bs) for n in lens]
    ids = (torch.randperm(N - 1, generator=gen) + 1).tolist()
    tables = torch.zeros(B, Bps, dtype=torch.int32)
    for b, nb in enumerate(need):
        tables[b, :nb] = torch.tensor(ids[:nb], dtype=torch.int32)
        ids = ids[nb:]
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.randn(B, Hkv, G, D, generator=gen).to(qdt)
    k = torch.randn(N, bs, Hkv, D, generator=gen)
    v = torch.randn(N, bs, Hkv, D, generator=gen)
    scales = {}
    if kv == "int8":
        def quantize(x):
            s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
            return torch.round(x / s).clamp(-127, 127).to(torch.int8), s
        k, scales["k_scale"] = quantize(k)
        v, scales["v_scale"] = quantize(v)
    elif kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    valid = torch.ones(N, bs, dtype=torch.bool)
    if holes:
        valid = torch.rand(N, bs, generator=gen) > 0.2
        for b, n in enumerate(lens):   # the query's own position is valid
            if n:
                valid[tables[b, (n - 1) // bs], (n - 1) % bs] = True
    args = [q, k, v, tables, torch.tensor(lens, dtype=torch.int32)]
    kw = {"valid_pool": valid, **scales}
    return ([a.to(dev) for a in args],
            {name: t.to(dev) for name, t in kw.items()})


def _time_ms(fn, reps=20, rounds=5):
    """Device time of one call of ``fn`` with a cold L2 (the decode reads
    pools that the other layers pushed out): each round times ``reps``
    pairs of (256 MiB write, call) and ``reps`` writes alone between CUDA
    events; the call's time is the difference over ``reps``, median over
    rounds.  The write keeps the card busy while the host enqueues the
    next call, so host launch cost is hidden unless a call's host cost
    exceeds the write (then it is counted, as for a many-op plain call)."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()

    def span(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            flush.zero_()
            if call:
                fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    return statistics.median((span(True) - span(False)) / reps
                             for _ in range(rounds))


def _bound_ms(args, kw):
    """Least time for the work: each input byte the function needs read
    once, the output written once, over HBM; its flops over the f32 rate."""
    q, k, _, tables, lens = args
    B, Hkv, G, D = q.shape
    bs = k.shape[1]
    n = [int(x) for x in lens.tolist()]
    pos = sum(n)
    blocks = sum(-(-x // bs) for x in n)
    nbytes = 2 * q.numel() * q.element_size()               # q in, out
    nbytes += 2 * pos * Hkv * D * k.element_size()         # live K and V
    if "k_scale" in kw:
        nbytes += 2 * pos * Hkv * 4
    if kw.get("valid_pool") is not None:
        nbytes += pos
    nbytes += blocks * 4 + B * 4                             # tables, lens
    flops = 4 * pos * Hkv * G * D                            # q.k and p.v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def _library_ms(args, kw):
    """``scaled_dot_product_attention`` over K/V gathered beforehand (the
    gather is not timed): one PyTorch call computing the same function."""
    import torch
    import torch.nn.functional as F

    q, k, v, tables, lens = args
    B, Hkv, G, D = q.shape
    T = tables.shape[1] * k.shape[1]
    t = tables.long()
    kd = k[t].reshape(B, T, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    vd = v[t].reshape(B, T, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = torch.arange(T, device=q.device)[None, :] < lens.long()[:, None]
    mask = mask & kw["valid_pool"][t].reshape(B, T)
    q4 = q.reshape(B, Hkv * G, 1, D)
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask[:, None, None, :]))


def phase_kernel():
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        paged_decode_reference, paged_flash_decode)

    shape = DECODE_SHAPE
    spread = [int(x) for x in np.linspace(1, 600, shape["B"])]
    cases = [
        ("f32", dict(shape, lens=spread)),
        ("gqa_g4", dict(shape, Hkv=3, G=4, lens=spread)),
        ("bf16", dict(shape, lens=spread, kv="bf16")),
        ("int8", dict(shape, lens=spread, kv="int8")),
        ("valid_holes", dict(shape, lens=spread, holes=True)),
        ("empty_slot", dict(shape, lens=[0] + spread[1:])),
    ]
    main = None
    for name, spec in cases:
        args, kw = _decode_case(seed=len(name), **spec)
        out = paged_flash_decode(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_reference(*args, **kw)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"kernel case {name}: non-finite output")
        rows = torch.as_tensor(spec["lens"], device=out.device) > 0
        err = float((out.float() - ref.float())[rows].abs().max())
        tol = TOL[spec.get("kv", "f32")]
        print(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise RuntimeError(f"kernel case {name}: error {err} > {tol}")
        if name == "f32":
            main = dict(max_abs_err=err,
                        ms=_time_ms(lambda: paged_flash_decode(*args, **kw)),
                        plain_ms=_time_ms(
                            lambda: paged_decode_reference(*args, **kw)),
                        library_ms=_library_ms(args, kw))
            main["bound_ms"], main["bound_by"] = _bound_ms(args, kw)
            print(f"kernel f32 timing: kernel {main['ms']:.4f} ms, plain "
                  f"{main['plain_ms']:.4f} ms, sdpa {main['library_ms']:.4f}"
                  f" ms, bound {main['bound_ms']:.4f} ms "
                  f"({main['bound_by']}), {main['bound_ms'] / main['ms']:.1%}"
                  " of bound")
    return main


# --- phases 4 and 5 ---------------------------------------------------------

#: the ``gpt`` CLI default (-l 12 -s 768: 12 heads of 64, MLP 3072) with the
#: bench ``lm`` vocabulary, 1024 positions, f32, random weights from seed 0
FULL_MODEL = dict(vocab_size=32768, num_layers=12, d_model=768,
                  num_heads=12, mlp_dim=3072, max_len=1024)
FULL_LOAD = dict(n_requests=16, arrival="poisson", prompt_short=(16, 64),
                 prompt_long=(256, 512), long_frac=0.3,
                 shared_prefix_len=64, shared_frac=0.6, new_tokens=(16, 64))
FULL_ENGINE = dict(max_slots=8, kv_block_size=16, prefill_chunk=64)


def _serve(decode_attention):
    from distributed_deep_learning_tpu_torch.serve.bench import \
        paged_serving_bench

    t0 = time.perf_counter()
    rec = paged_serving_bench(seed=0, device="cuda", load_kw=FULL_LOAD,
                              model_kw=FULL_MODEL,
                              decode_attention=decode_attention,
                              **FULL_ENGINE)
    pe, lat = rec["paged_engine"], rec["paged_engine"]["latency"]
    print(f"serve[{decode_attention}]: {pe['generated_tokens']} tokens at "
          f"{pe['tokens_per_sec']:.1f} tok/s ({pe['total_seconds']:.2f} s "
          f"serving, {time.perf_counter() - t0:.1f} s with model build), "
          f"decode {pe['decode_seconds']:.3f} s over {pe['decode_ticks']} "
          f"ticks, prefill {pe['prefill_seconds']:.3f} s over "
          f"{pe['prefill_chunks']} chunks")
    print(f"serve[{decode_attention}]: ttft p50 {lat['ttft_p50_s']:.4f} s "
          f"p99 {lat['ttft_p99_s']:.4f} s | itl p50 {lat['itl_p50_s']:.5f} s"
          f" p99 {lat['itl_p99_s']:.5f} s | e2e p50 {lat['e2e_p50_s']:.4f} s"
          f" p99 {lat['e2e_p99_s']:.4f} s | kv_cache_bytes "
          f"{pe['kv_cache_bytes']} | prefix_hit_rate "
          f"{pe['prefix_hit_rate']:.4f} | mean occupancy "
          f"{pe['mean_slot_occupancy']:.3f}")
    return rec


def phase_serve():
    """The main path at full width; returns its record and the kernel
    launches counted during it (the count is zeroed just before)."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    paged_flash_decode.launches = 0
    rec = _serve("kernel")
    launches = paged_flash_decode.launches
    pe = rec["paged_engine"]
    if rec["errors"]:
        raise RuntimeError(f"serving: {rec['errors']} requests rejected")
    vocab = FULL_MODEL["vocab_size"]
    for uid, budget in rec["budgets"].items():
        toks = rec["results"].get(uid, [])
        if len(toks) != budget:
            raise RuntimeError(f"request {uid}: {len(toks)} tokens of "
                               f"{budget}")
        if not all(1 <= t < vocab for t in toks):
            raise RuntimeError(f"request {uid}: token outside [1, {vocab})")
    if not pe["prefix_hit_rate"] > 0:
        raise RuntimeError("serving: no prefix-cache hit")
    want = pe["decode_ticks"] * FULL_MODEL["num_layers"]
    print(f"serve: paged_flash_decode launches {launches} (stats "
          f"{pe['paged_decode_launches']}), decode_ticks x layers {want}")
    if not launches == pe["paged_decode_launches"] == want:
        raise RuntimeError("serving: the decode did not launch the kernel "
                           "once per layer per tick")
    return rec, launches


def phase_plain_replay(rec):
    """The same trace with the plain decode attention: first tokens must
    agree; returns the overall greedy agreement."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    before = paged_flash_decode.launches
    plain = _serve("plain")
    if paged_flash_decode.launches != before:
        raise RuntimeError("plain replay launched the kernel")
    if plain["errors"]:
        raise RuntimeError(f"plain replay: {plain['errors']} rejected")
    same = total = 0
    for uid, toks in rec["results"].items():
        other = plain["results"][uid]
        if toks[0] != other[0]:
            raise RuntimeError(f"request {uid}: first token {toks[0]} "
                               f"(kernel) vs {other[0]} (plain)")
        same += sum(a == b for a, b in zip(toks, other))
        total += len(toks)
    print(f"plain replay: first tokens identical for {len(rec['results'])}"
          f" requests; greedy agreement {same}/{total} = {same / total:.4f}")
    return same / total


def main() -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    timing = phase_kernel()
    rec, launches = phase_serve()
    phase_plain_replay(rec)
    print(f"phases done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "paged_flash_decode", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
