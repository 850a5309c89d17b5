#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --phases 1,6,7  # a subset (no result lines)
    python3 chip_smoke.py --phases 3,16,18,19,20  # this slice's options
    python3 chip_smoke.py --phases 1,2,3 --waves 4  # another split rule

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name and power limit as ``nvidia-smi`` reports them;
   no visible CUDA card is a failure;
2. build: compile the kernels from the sources in the checkout, one
   ``nvcc`` per source, all started together; prints the paged
   flash-decode library's build time and ``ptxas`` register report;
3. kernel vs plain: ``paged_flash_decode`` against ``paged_decode_reference``
   on the card at the serving path's decode shape, plus GQA, bf16, int8,
   ``valid_pool`` holes, an empty slot, a slot ending on a split boundary,
   a slot shorter than one split beside long ones, two full-length slots
   (``f32_long``, the few-slots case split-K is for), phase 15's shape
   (``bf16_serve``: bf16 queries and pools, 128 blocks a slot, 2-24 live
   positions, the split count that shape gives), a sliding window of 256
   at the 8-slot shape (``window``, phase 20's) and int8 pools quantized
   by the engines' rule at phase 18's shape (``int8_serve``); median times
   of the kernel, the plain version and ``scaled_dot_product_attention``
   on pre-gathered K/V (a yardstick the port never calls), beside the
   bytes bound, at the 8-slot shape, at ``f32_long`` and ``window``; the
   kernel's
   device time with no host cost in it at both, and the host's cost of
   one wrapper call at the 8-slot shape;
4. the serving slice at full width (GPT-2-small shape, vocab 32768): the
   paged engine serves a seeded Poisson load with a shared prefix, its
   decode tick captured once in a CUDA graph and replayed; checks errors,
   token budgets and ranges, prefix hits, one capture, finite outputs and
   that every decode tick launched the kernel once per layer; prints the
   mean tick time;
5. the same trace with the decode attention switched to the plain
   version: first tokens must agree, and the overall greedy agreement is
   printed;
6. the flash-attention library's build time and ``ptxas`` report, with
   the registers, stack frame and spill bytes of every instantiation of
   the three tensor-core kernels (forward, dQ, dK/dV) and of the paged
   decode kernels (split and combine); a missing instantiation, or a
   stack frame or spill in a tensor-core kernel, fails;
7. flash forward, dQ and dK/dV kernels against their plain versions at
   the training shape (B 4, H 12, T 2048, D 64, causal, key_valid given),
   f32 and bf16, plus padding with a fully padded row, GQA, a sliding
   window, a ragged T, a non-causal cross shape and head dims 16, 32 and
   128 in both dtypes (B 1, H 2, T 512); median times of each kernel, its
   plain version and ``scaled_dot_product_attention`` (forward, and
   forward plus backward: a yardstick the port never calls) beside the
   operations bound (f32: three TF32 products at the TF32 rate, with the
   f32-unit figure beside it), and a backward-total line (delta + dQ +
   dK/dV against SDPA's whole backward);
8. training at full width through the CLI entry point:
   ``gpt -m sequential -l 12 -s 768 -e 1 -b 4 --attention flash`` on a
   seeded ``tokens.npy`` of 48 rows of 2049 ids (vocab 32768): finite
   losses, the last train step's below the first's, and every layer of
   every step through the kernels (forward per train/val/test step, dQ and
   dK/dV per train step);
9. the same run with ``--attention dense``: the first step's loss within
   1e-4 and the epoch's train loss within 1e-2 of the flash run;
10. phase 8's run in bf16 (``--dtype bfloat16``): finite losses falling
    from the first train step to the last, every kernel launch on the bf16
    instantiations at phase 8's counts, the first step's loss within 2e-2
    of phase 8's;
11. ``-m data --dtype bfloat16`` at world 1 on NCCL (DDP): the first loss
    within 1e-6 of phase 10's; then with ``--remat`` under the policies
    ``nothing`` and ``dots`` (the forward launched twice a layer a train
    step: (2 x train + eval steps) x 12, the first loss within 1e-6, peak
    memory beside phase 10's); then with ``--grad-accum 2`` (epoch loss
    within 1e-2 of phase 10's, and each train step's loss within
    ``ACCUM_STEP_TOL`` of the plain ``-m data`` run's), and once more with
    a planted fault (the second microbatch's gradient dropped), which
    this check must fail;
12. ``-m data --dtype bfloat16 --dropout 0.1 --checkpoint-every 4`` into a
    ``--checkpoint-dir`` under ``build/``: the final step removed, a
    ``--resume`` run continues from batch 4 and its steps 5-8 give the
    losses of the run that was never stopped within 1e-6; the final step's
    manifest (CRC32 of every leaf) verifies;
13. phase 4's trace through ``PagedEngine`` with its decode tick eager
    (``DecodeTick.graphed`` set false: the same body, no capture), in
    turns with the graphed tick (eager, graphed, graphed, eager): greedy
    tokens identical to phase 4's for every request in every run (the
    proof that the graph recorded the ``ctypes`` kernel launches), one
    kernel launch per layer per tick; tokens/s, tick time, ITL and TTFT of
    each run; each graphed engine's captured tick, and a slot engine's,
    replayed alone between CUDA events: its device time beside its host
    tick; every engine's device memory freed when it is dropped;
14. the slot engine at full width on phase 4's trace (the bench's
    comparison leg, run in phase 4's call): no errors, every budget met,
    tokens in [1, vocab), one capture, first tokens equal to phase 4's;
    greedy agreement, tokens/s, TTFT, ITL and KV bytes beside phase 4's;
15. post-train serving through the CLI, riding on earlier runs: phase
    10's run gains ``--generate 16 --serve --paged --prefill-chunk 64``
    (bf16 queries and pools through the kernel) and phase 11's plain
    ``-m data`` run ``--serve`` (the slot engine on bf16 weights); their
    logged ``generate``, ``serve(paged):`` and ``serve:`` lines must show
    two 16-token continuations, every request served, one decode capture
    and one kernel launch per layer per tick.  What each run served is
    held too, right after it: every budget met, tokens in [1, vocab), each
    greedy token within one bf16 step (2^-8 of max|logit|) of the plain
    forward's argmax on its own prefix; the paged engine's geometry is
    phase 3's ``bf16_serve`` case, and its trace replayed with the plain
    decode attention gives the same first tokens (the greedy agreement
    printed) within the same limit, which a planted fault (each slot
    reading its neighbour's blocks) must break.  Phase 10's run is made
    once more with a second post-train leg, ``--serve --paged --draft 6
    --spec-k 4 --kv-dtype int8 --weight-dtype int8``: its logged line shows
    every request served, the draft round and the verify captured once,
    the decode tick never, and 6 x 5 kernel launches a tick; what it served
    is held against the plain forward of the engine's int8 weights within
    the same limit;
16. the fused head (``CausalLM.loss``) against the logits path at the
    training shape (B 4, T 2048, V 32768, d 768), f32 and bf16 hidden
    states: the loss within 1e-5 (relative), each gradient within 1e-4 of
    its largest element (bf16 dh within one bf16 step), peak memory and
    time of each; then 8 bf16 train steps of the 12-layer model through
    ``loss``, their step time and peak beside phase 10's;
17. phase 10's run with ``--optimizer lamb`` and with ``--optimizer
    adafactor`` (``--lr 1e-2``): finite losses that fall, phase 10's kernel
    launches, step time, peak and optimizer state beside AdamW's
    (Adafactor's must be smaller);
18. phase 4's trace through ``PagedEngine`` with int8 KV, bf16 KV and int8
    weights over int8 KV, and through the slot engine with bf16 KV: no
    errors, every budget met, tokens in [1, vocab), one capture, one kernel
    launch a layer a tick on the paged engine; each int8 run replayed with
    the plain decode attention gives the same first tokens; agreement,
    tokens/s, tick, a replay's device time, KV and weight bytes beside
    phase 4's;
19. phase 4's trace with a 2-layer draft proposing 4 tokens a round: first
    tokens equal to phase 4's, every token within ``SPEC_GAP_TOL`` of the
    plain forward's argmax on its prefix, one capture each of the draft
    round and the verify and none of the decode tick, draft launches
    ``ticks x (spec_k + 1) x draft_layers``; acceptance and tokens/s beside
    phase 4's;
20. phase 4's trace on the model with a 256-position sliding window: the
    kernel against the plain decode (first tokens identical, agreement
    printed), one launch a layer a tick.

Phases 8-12, 16 and 17 print step time, tokens/s and peak memory.  The line before
the last is ``{"kernels": [...]}``; the last line is ``{"ok": true,
"device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor
#: cores, bf16 and TF32 dense tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
KERNEL_SOURCE = "distributed_deep_learning_tpu_torch/csrc/paged_decode.cu"
DECODE_KERNELS = ("paged_decode_kernel", "paged_combine_kernel")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
KERNEL_REPLACES = ("distributed_deep_learning_tpu/ops/paged_decode_pallas.py"
                   ":66 (_decode_kernel)")
FLASH_SOURCE = "distributed_deep_learning_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_forward": "distributed_deep_learning_tpu/ops/attention_pallas.py"
                     ":97 (_fwd_kernel, pallas_call :192)",
    "flash_backward_dq": "distributed_deep_learning_tpu/ops/"
                         "attention_pallas.py:213 (_dq_kernel, pallas_call "
                         ":331)",
    "flash_backward_dkv": "distributed_deep_learning_tpu/ops/"
                          "attention_pallas.py:248 (_dkv_kernel, "
                          "pallas_call :354)",
}

#: the serving slice's decode shape: 8 slots, GPT-2-small heads, 1024-token
#: slots in 16-position blocks, pools sized as the engine sizes them
DECODE_SHAPE = dict(B=8, Hkv=12, G=1, D=64, bs=16, Bps=64,
                    N=2 * 8 * 64 + 1)
TOL = {"f32": 1e-4, "int8": 1e-4, "int8_serve": 1e-4, "bf16": 2e-2}
#: phase 20's sliding window, held in phase 3 at the 8-slot shape
SERVE_WINDOW = 256


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


def start_builds():
    """Start one ``nvcc`` per kernel source, all together; returns
    futures of ``(path, log, seconds)`` by source name."""
    from distributed_deep_learning_tpu_torch.ops import attention
    from distributed_deep_learning_tpu_torch.ops import paged_decode

    def timed(build):
        t0 = time.perf_counter()
        path, log = build()
        return path, log, time.perf_counter() - t0

    pool = ThreadPoolExecutor(2)
    futures = {"paged_decode": pool.submit(timed, paged_decode.build),
               "flash_attention": pool.submit(timed, attention.build)}
    pool.shutdown(wait=False)
    return futures


def phase_build(future, label="build"):
    """Wait for one library's build and print its time and ptxas report;
    returns the report."""
    path, log, seconds = future.result()
    print(f"{label}: {seconds:.2f}s -> {path.relative_to(ROOT)}")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas {ln.strip()}")
    return log


#: one template argument of a mangled kernel name: a type or an integer
_TEMPLATE_ARG = re.compile(r"f|a|13__nv_bfloat16|S\d*_|Li(\d+)E")


def _template_args(text):
    """The template arguments of a mangled name, ``text`` starting just
    after its ``I``: types as ``f32``, ``int8`` or ``bf16`` (the one class
    type, so a substitution ``S.._`` names it too), integers as ints."""
    args, i = [], 0
    while i < len(text) and text[i] != "E":
        m = _TEMPLATE_ARG.match(text, i)
        if m is None:
            break
        args.append(int(m.group(1)) if m.group(1) is not None
                    else {"f": "f32", "a": "int8"}.get(m.group(0), "bf16"))
        i = m.end()
    return tuple(args)


def ptxas_summary(log, kernels):
    """``{(kernel, *template args): (registers, stack frame bytes, spill
    store bytes, spill load bytes)}`` for the named kernels, from ``nvcc
    -Xptxas=-v`` output; a flash kernel's key is ``(kernel, dtype, D)``."""
    name_re = re.compile(r"(" + "|".join(kernels) + r")I")
    out, key, spill = {}, None, (0, 0, 0)
    for ln in log.splitlines():
        m = name_re.search(ln)
        if m and ("Compiling entry" in ln or "Function properties" in ln):
            key = (m.group(1), *_template_args(ln[m.end():]))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and key:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and key:
            out[key] = (int(m.group(1)), *spill)
            key, spill = None, (0, 0, 0)
    return out


#: instantiations phase 6 must find: 3 flash kernels x 2 dtypes x 4 head
#: dims; the decode's 2 x 3 x 3 split kernels and 2 combines
FLASH_INSTANTIATIONS, DECODE_INSTANTIATIONS = 24, 20


def check_ptxas(flash_log, decode_log):
    """Print registers, stack frame and spills of every instantiation;
    raise if either library has fewer than expected or a tensor-core flash
    kernel has a stack frame or spill (the decode kernels' small spill is
    printed, not held against them)."""
    for label, found, want, strict in (
            ("flash tensor-core", ptxas_summary(flash_log, FLASH_KERNELS),
             FLASH_INSTANTIATIONS, True),
            ("paged decode", ptxas_summary(decode_log, DECODE_KERNELS),
             DECODE_INSTANTIATIONS, False)):
        for (kname, *args), (regs, frame, st, ld) in sorted(found.items()):
            what = " ".join(f"D{a}" if isinstance(a, int) else a
                            for a in args)
            print(f"ptxas {kname} {what}: {regs} registers, stack frame "
                  f"{frame} B, spill stores {st} B, spill loads {ld} B")
        spilled = [k for k, (_, frame, st, ld) in found.items()
                   if frame or st or ld]
        print(f"ptxas {label}: {len(found)} of {want} instantiations "
              f"parsed, {len(spilled)} with a stack frame or spill")
        if len(found) < want:
            raise RuntimeError(f"ptxas {label}: {len(found)} of {want} "
                               "instantiations found in the build log")
        if strict and spilled:
            raise RuntimeError(f"ptxas {label}: stack frame or spill in "
                               f"{sorted(spilled)}")


def phase_ptxas(builds):
    """Phase 6: the flash library's build, then :func:`check_ptxas` on both
    libraries' reports."""
    log = phase_build(builds["flash_attention"], label="build flash")
    _, decode_log, _ = builds["paged_decode"].result()
    check_ptxas(log, decode_log)


# --- phase 3 ---------------------------------------------------------------


def _decode_case(*, B, Hkv, G, D, bs, Bps, N, lens, kv="f32", holes=False,
                 window=None, seed=0, device="cuda"):
    """Seeded decode inputs on the card: pools of N blocks (block 0 the
    trash block), each slot's live blocks at distinct random physical ids,
    table tails trash-padded.  ``kv="int8_serve"``: int8 pools quantized
    by the serving engines' rule (``serve.quant.quantize_rows``)."""
    import torch

    from distributed_deep_learning_tpu_torch.serve import quant

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
    elif kv == "int8_serve":
        (k, scales["k_scale"]), (v, scales["v_scale"]) = (
            (qt.q, qt.s) for qt in (quant.quantize_rows(k),
                                    quant.quantize_rows(v)))
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
            {**{name: t.to(dev) for name, t in kw.items()},
             **({"window": window} if window is not None else {})})


#: GPU clock cycles (~50 ms on an H100) the card sleeps while the host
#: enqueues a span of :func:`_time_ms` (``head_start``) or :func:`_host_us`
HEAD_START_CYCLES = 100_000_000


def _time_ms(fn, reps=20, rounds=5, head_start=False):
    """Device time of one call of ``fn`` with a cold L2 (the decode reads
    pools that the other layers pushed out): each round times ``reps``
    pairs of (256 MiB write, call) and ``reps`` writes alone between CUDA
    events; the call's time is the difference over ``reps``, median over
    rounds.  The write keeps the card busy while the host enqueues the
    next call, so host launch cost is hidden unless a call's host cost
    exceeds the write (then it is counted, as for a many-op plain call).
    ``head_start``: each span waits behind a device-side sleep until the
    host has enqueued all of it, so no host cost is timed at all."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()

    def span(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
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


def _host_us(fn, calls=100, rounds=10):
    """Host cost of one call of ``fn`` in microseconds: the host clock
    around ``calls`` calls enqueued while the card sleeps, so the launch
    queue neither drains nor fills and only the host's work (Python,
    allocation, launches) is timed; median over ``rounds``."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HEAD_START_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def decode_costs():
    """The decode kernel's device ms at each timed case (``head_start``:
    no host cost) and the host's us for one wrapper call at the 8-slot
    shape, from whichever copy of the package is first on ``sys.path``, so
    a parent commit's wrapper is timed the same way."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    out = {}
    for name, spec in _timed_decode_specs().items():
        args, kw = _decode_case(seed=len(name), **spec)
        out[name] = _time_ms(lambda: paged_flash_decode(*args, **kw),
                             head_start=True)
        if name == "f32":
            out["host_us"] = _host_us(lambda: paged_flash_decode(*args, **kw))
    return out


def _timed_decode_specs():
    """The timed decode cases: the serving shape with 8 slots of 1-600
    positions, and ``f32_long``, 2 slots of the engine's 1024."""
    import numpy as np

    full = DECODE_SHAPE["Bps"] * DECODE_SHAPE["bs"]
    spread = [int(x) for x in np.linspace(1, 600, DECODE_SHAPE["B"])]
    return {"f32": dict(DECODE_SHAPE, lens=spread),
            "f32_long": dict(DECODE_SHAPE, B=2, lens=[full, full])}


def _bound_ms(args, kw):
    """Least time for the work: each input byte the function needs read
    once, the output written once, over HBM; its flops over the f32 rate."""
    q, k, _, tables, lens = args
    B, Hkv, G, D = q.shape
    bs = k.shape[1]
    window = kw.get("window")
    spans = [(max(0, x - window) if window else 0, x)
             for x in (int(y) for y in lens.tolist())]
    pos = sum(hi - lo for lo, hi in spans)
    blocks = sum(-(-hi // bs) - lo // bs for lo, hi in spans if hi > lo)
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
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos < lens.long()[:, None]
    if kw.get("window"):
        mask = mask & (kpos >= lens.long()[:, None] - kw["window"])
    mask = mask & kw["valid_pool"][t].reshape(B, T)
    q4 = q.reshape(B, Hkv * G, 1, D)
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask[:, None, None, :]))


def _decode_timing(args, kw, err):
    """Median cold-L2 ms of the kernel, the plain version and SDPA on
    these inputs, beside the bytes bound."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        paged_decode_reference, paged_flash_decode)

    rec = dict(max_abs_err=err,
               ms=_time_ms(lambda: paged_flash_decode(*args, **kw)),
               plain_ms=_time_ms(lambda: paged_decode_reference(*args, **kw)),
               library_ms=_library_ms(args, kw))
    rec["bound_ms"], rec["bound_by"] = _bound_ms(args, kw)
    return rec


def _print_splits(label, shape):
    """The split-K count the decode's rule gives at ``shape``; returns the
    count and the positions a split covers."""
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        decode_splits, sm_count)

    splits, per = decode_splits(shape["B"], shape["Hkv"], shape["Bps"],
                                shape["bs"], sm_count(torch.device("cuda")))
    print(f"kernel split-K at {label}: {splits} splits of {per} blocks "
          f"({per * shape['bs']} positions) per (slot, kv head), "
          f"{shape['B'] * shape['Hkv'] * splits} blocks")
    return splits, per * shape["bs"]


def phase_kernel():
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        paged_decode_reference, paged_flash_decode)

    shape = DECODE_SHAPE
    full = shape["Bps"] * shape["bs"]
    splits, run = _print_splits(f"the {shape['B']}-slot shape", shape)
    _print_splits("phase 15's shape", SERVE_BF16_SHAPE)
    timed = _timed_decode_specs()
    spread = timed["f32"]["lens"]
    long_tail = [full - 13 * i for i in range(1, shape["B"])]
    cases = [
        ("f32", timed["f32"]),
        ("gqa_g4", dict(shape, Hkv=3, G=4, lens=spread)),
        ("bf16", dict(shape, lens=spread, kv="bf16")),
        ("int8", dict(shape, lens=spread, kv="int8")),
        ("valid_holes", dict(shape, lens=spread, holes=True)),
        ("empty_slot", dict(shape, lens=[0] + spread[1:])),
        ("split_boundary", dict(shape, lens=[run * max(1, splits // 2)]
                                + spread[1:])),
        ("short_slot", dict(shape, lens=[max(1, run // 3)] + long_tail)),
        ("f32_long", timed["f32_long"]),
        ("bf16_serve", dict(SERVE_BF16_SHAPE, kv="bf16", lens=[
            int(x) for x in np.linspace(*SERVE_BF16_LENS,
                                        SERVE_BF16_SHAPE["B"])])),
        ("window", dict(shape, lens=[full - 7] + spread[1:],
                        window=SERVE_WINDOW)),
        ("int8_serve", dict(shape, kv="int8_serve", lens=[
            int(x) for x in np.linspace(1, full, shape["B"])])),
    ]
    main, errs = None, {}
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
        errs[name] = err
        if name in ("f32", "f32_long", "window"):
            rec = _decode_timing(args, kw, err)
            print(f"kernel {name} timing: kernel {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f}"
                  f" ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.1%}"
                  " of bound")
            if name == "f32":
                main = rec
            else:
                main[name] = rec
    main["bf16_serve_max_abs_err"] = errs["bf16_serve"]
    main["int8_serve_max_abs_err"] = errs["int8_serve"]
    costs = decode_costs()
    main["device_ms"] = costs["f32"]
    main["f32_long"]["device_ms"] = costs["f32_long"]
    main["host_us"] = costs["host_us"]
    print(f"kernel device time, no host cost: f32 {costs['f32']:.4f} ms, "
          f"f32_long {costs['f32_long']:.4f} ms; host "
          f"{costs['host_us']:.1f} us a wrapper call at the 8-slot shape")
    return main


# --- phases 4, 5, 13 and 14: serving ----------------------------------------

#: the ``gpt`` CLI default (-l 12 -s 768: 12 heads of 64, MLP 3072) with the
#: bench ``lm`` vocabulary, 1024 positions, f32, random weights from seed 0
FULL_MODEL = dict(vocab_size=32768, num_layers=12, d_model=768,
                  num_heads=12, mlp_dim=3072, max_len=1024)
FULL_LOAD = dict(n_requests=16, arrival="poisson", prompt_short=(16, 64),
                 prompt_long=(256, 512), long_frac=0.3,
                 shared_prefix_len=64, shared_frac=0.6, new_tokens=(16, 64))
FULL_ENGINE = dict(max_slots=8, kv_block_size=16, prefill_chunk=64)


def _serve(label, *, compare_engine=False):
    """Phase 4's bench call with the decode attention ``label`` ("kernel"
    or "plain")."""
    from distributed_deep_learning_tpu_torch.serve.bench import \
        paged_serving_bench

    t0 = time.perf_counter()
    rec = paged_serving_bench(seed=0, device="cuda", load_kw=FULL_LOAD,
                              model_kw=FULL_MODEL,
                              decode_attention=label,
                              compare_engine=compare_engine, **FULL_ENGINE)
    pe = rec["paged_engine"]
    print(f"serve[{label}]: {pe['generated_tokens']} tokens at "
          f"{pe['tokens_per_sec']:.1f} tok/s ({pe['total_seconds']:.2f} s "
          f"serving, {time.perf_counter() - t0:.1f} s with model build), "
          f"decode {pe['decode_seconds']:.3f} s over {pe['decode_ticks']} "
          f"ticks ({_tick_ms(pe):.3f} ms a tick, decode captures "
          f"{pe['decode_captures']}), prefill {pe['prefill_seconds']:.3f} s"
          f" over {pe['prefill_chunks']} chunks")
    print(f"serve[{label}]: {_latency_text(pe)} | prefix_hit_rate "
          f"{pe['prefix_hit_rate']:.4f}")
    return rec


def _tick_ms(rec):
    return rec["decode_seconds"] / rec["decode_ticks"] * 1e3


def _latency_text(rec):
    lat = rec["latency"]
    return (f"ttft p50 {lat['ttft_p50_s']:.4f} s p99 {lat['ttft_p99_s']:.4f}"
            f" s | itl p50 {lat['itl_p50_s']:.5f} s p99 "
            f"{lat['itl_p99_s']:.5f} s | e2e p50 {lat['e2e_p50_s']:.4f} s "
            f"p99 {lat['e2e_p99_s']:.4f} s | kv_cache_bytes "
            f"{rec['kv_cache_bytes']} | mean occupancy "
            f"{rec['mean_slot_occupancy']:.3f}")


def _check_results(label, results, budgets, vocab=FULL_MODEL["vocab_size"]):
    """Every request served to its budget, every token in [1, vocab)."""
    for uid, budget in budgets.items():
        toks = results.get(uid, [])
        if len(toks) != budget:
            raise RuntimeError(f"{label}: request {uid}: {len(toks)} tokens "
                               f"of {budget}")
        if not all(1 <= t < vocab for t in toks):
            raise RuntimeError(f"{label}: request {uid}: token outside "
                               f"[1, {vocab})")


def _check_tick(label, rec, captures):
    if rec["decode_captures"] != captures or rec["nonfinite_tokens"]:
        raise RuntimeError(f"{label}: decode captures "
                           f"{rec['decode_captures']} (expected {captures}),"
                           f" {rec['nonfinite_tokens']} non-finite tokens")


def _agreement(a, b, label):
    """Greedy agreement of two result maps; raises unless every first
    token agrees."""
    same = total = 0
    for uid, toks in a.items():
        other = b[uid]
        if toks[0] != other[0]:
            raise RuntimeError(f"{label}: request {uid}: first token "
                               f"{toks[0]} vs {other[0]}")
        same += sum(x == y for x, y in zip(toks, other))
        total += len(toks)
    print(f"{label}: first tokens identical for {len(a)} requests; greedy "
          f"agreement {same}/{total} = {same / total:.4f}")
    return same / total


def phase_serve(compare_engine=False):
    """The main path at full width, its decode tick graphed; returns its
    record and the kernel launches counted during it (the count is zeroed
    just before).  ``compare_engine``: the slot engine serves the same
    trace after it (phase 14's run), launching no kernel."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    paged_flash_decode.launches = 0
    rec = _serve("kernel", compare_engine=compare_engine)
    launches = paged_flash_decode.launches
    pe = rec["paged_engine"]
    if rec["errors"]:
        raise RuntimeError(f"serving: {rec['errors']} requests rejected")
    _check_results("serving", rec["results"], rec["budgets"])
    _check_tick("serving", pe, captures=1)
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
    _check_tick("plain replay", plain["paged_engine"], captures=1)
    return _agreement(rec["results"], plain["results"], "plain replay")


#: phase 13's paged runs once the process is warm (phase 4 pays its
#: first-use costs inside its prefill): the tick eager and graphed in turns
EAGER_AB = (False, True, True, False)


@functools.cache
def _full_width():
    """Phase 4's model (seed 0), trace and paged capacity, built once for
    the engines of phases 13 and 18-20."""
    from distributed_deep_learning_tpu_torch.serve.bench import (
        DEFAULT_LOAD, build_model, paged_max_len)
    from distributed_deep_learning_tpu_torch.serve.load import (LoadSpec,
                                                                make_load)

    model = build_model(0, "cuda", **FULL_MODEL)
    trace = make_load(LoadSpec(**{**DEFAULT_LOAD, **FULL_LOAD}),
                      vocab_size=model.vocab_size, seed=0)
    return model, trace, paged_max_len(model.max_len,
                                       FULL_ENGINE["kv_block_size"])


def _replay_ms(graph, reps=50):
    """Device ms of one replay of a captured tick: ``reps`` replays back to
    back between CUDA events, on the tick's last staged inputs (the K/V
    writes repeat in place).  A replay is enqueued in microseconds, so the
    events time the card alone."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _engine_lifetime(make, trace, label, graphed=True):
    """One engine's lifetime over ``trace``: ``make()`` builds it, its tick
    graphed or eager (``DecodeTick.graphed``).  Returns the run's output
    and, graphed, the device ms of a replay of its captured tick.  The
    device memory allocated before the engine is built and after it is
    dropped (no cyclic collection between) must agree within a tenth of
    its KV cache: a dropped engine frees its caches and its graph."""
    import torch

    before = torch.cuda.memory_allocated()
    engine = make()
    engine._tick.graphed = graphed
    out = engine.run(trace)
    replay = _replay_ms(engine._tick._graph) if graphed else None
    kv = engine.kv_cache_bytes
    del engine
    after = torch.cuda.memory_allocated()
    print(f"{label}: device memory allocated {before / 2**20:.1f} MiB "
          f"before the engine, {after / 2**20:.1f} MiB after it is dropped "
          f"(its KV cache {kv / 2**20:.1f} MiB)")
    if after - before > kv / 10:
        raise RuntimeError(f"{label}: a dropped engine kept "
                           f"{(after - before) / 2**20:.1f} MiB")
    return out, replay


def _print_replay(name, replay, stats):
    print(f"graphed tick [{name}]: {replay:.3f} ms on the card a replay, "
          f"{_tick_ms(stats):.3f} ms a tick on the host clock (replay / "
          f"host tick {replay / _tick_ms(stats):.1%}: an estimate from "
          "back-to-back replays on fixed inputs, not a trace)")


def phase_eager_replay(rec):
    """Phase 13: phase 4's trace through ``PagedEngine`` with the decode
    tick eager and graphed in turns (``EAGER_AB``); every run's greedy
    tokens must be phase 4's, request for request, and its kernel
    launches one per layer per tick.  Each graphed run, and a slot engine
    on the same trace, then replays its captured tick alone; every engine
    must free its device memory when dropped."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    model, trace, cap = _full_width()
    runs = {"graphed": [], "eager": []}
    for graphed in EAGER_AB:
        name = "graphed" if graphed else "eager"
        paged_flash_decode.launches = 0
        r, replay = _engine_lifetime(
            lambda: PagedEngine(model, max_len=cap, **FULL_ENGINE), trace,
            f"graph vs eager [{name}]", graphed=graphed)
        launches, pe = paged_flash_decode.launches, r["stats"]
        if r["errors"]:
            raise RuntimeError(f"{name} replay: {r['errors']} rejected")
        _check_tick(f"{name} replay", pe, captures=int(graphed))
        want = pe["decode_ticks"] * FULL_MODEL["num_layers"]
        if not launches == pe["paged_decode_launches"] == want:
            raise RuntimeError(f"{name} replay: {launches} kernel launches,"
                               f" expected {want}")
        differ = [uid for uid, toks in rec["results"].items()
                  if list(r["results"][uid]) != toks]
        if differ:
            raise RuntimeError(f"graph vs eager: {name} requests {differ} "
                               "differ from phase 4's")
        runs[name].append(pe)
        if graphed:
            _print_replay("paged", replay, pe)
    print(f"graph vs eager: greedy tokens identical to phase 4's for all "
          f"{len(rec['results'])} requests in {len(EAGER_AB)} runs, one "
          "launch per layer per tick in each")
    for name, rs in runs.items():
        for r in rs:
            lat = r["latency"]
            print(f"graph vs eager [{name}]: {r['tokens_per_sec']:.1f} "
                  f"tok/s, tick {_tick_ms(r):.3f} ms, itl p50 "
                  f"{lat['itl_p50_s']:.5f} s p99 {lat['itl_p99_s']:.5f} s, "
                  f"ttft p50 {lat['ttft_p50_s']:.4f} s p99 "
                  f"{lat['ttft_p99_s']:.4f} s, decode "
                  f"{r['decode_seconds']:.3f} s, prefill "
                  f"{r['prefill_seconds']:.3f} s")
    slot, replay = _engine_lifetime(
        lambda: ServeEngine(model, max_slots=FULL_ENGINE["max_slots"]),
        trace, "slot engine")
    _print_replay("slot", replay, slot["stats"])


def phase_slot_engine(rec):
    """Phase 14: the slot engine's leg of phase 4's bench call."""
    v1, pe = rec.get("engine_v1"), rec["paged_engine"]
    if v1 is None:
        raise RuntimeError("slot engine: phase 4 ran without its "
                           "comparison leg")
    if v1["errors"]:
        raise RuntimeError(f"slot engine: {v1['errors']} rejected")
    _check_results("slot engine", rec["results_v1"], rec["budgets"])
    _check_tick("slot engine", v1, captures=1)
    _agreement(rec["results"], rec["results_v1"], "slot vs paged")
    for name, r in (("paged", pe), ("slot", v1)):
        print(f"slot vs paged [{name}]: {r['tokens_per_sec']:.1f} tok/s, "
              f"tick {_tick_ms(r):.3f} ms over {r['decode_ticks']} ticks, "
              f"prefill {r['prefill_seconds']:.3f} s | {_latency_text(r)}")
    print(f"slot vs paged: speedup_vs_v1 {rec['speedup_vs_v1']:.3f}, "
          f"prefill tokens computed paged "
          f"{pe['paged']['prefill_tokens_computed']} vs slot "
          f"{v1['prefill_tokens_computed']} (saved fraction "
          f"{rec['prefill_tokens_saved_frac']:.4f})")


# --- phases 6 and 7: the flash-attention kernels ---------------------------

#: the training path's attention shape: 4 rows of 2048 tokens, 12 heads of 64
TRAIN_SHAPE = dict(B=4, H=12, Hkv=12, Tq=2048, Tk=2048, D=64)
FLASH_CASES = [
    ("f32", {}),
    ("bf16", {"dtype": "bf16"}),
    ("padding", {"pad": True}),
    ("gqa_hkv4", {"Hkv": 4}),
    ("window_256", {"window": 256}),
    ("ragged_t2000", {"Tq": 2000, "Tk": 2000}),
    ("cross_non_causal", {"Tq": 256, "causal": False}),
    # every other head dim is a tile of its own: small shapes, both dtypes
    *((f"d{d}_{dt}", {"B": 1, "H": 2, "Hkv": 2, "Tq": 512, "Tk": 512,
                      "D": d, "dtype": dt})
      for d in (16, 32, 128) for dt in ("f32", "bf16")),
]
#: (O and LSE max abs error, gradients' max abs error / max |reference|)
FLASH_TOL = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 2e-2)}


def _flash_case(*, B, H, Hkv, Tq, Tk, D, causal=True, window=None,
                dtype="f32", pad=False, seed=0):
    """Seeded q, k, v, key_valid and dO on the card.  ``pad``: rows 1 and
    2 lose their last 300 keys, row 3 all of them."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(B, Tq, H, D, generator=gen)
    k = torch.randn(B, Tk, Hkv, D, generator=gen)
    v = torch.randn(B, Tk, Hkv, D, generator=gen)
    do = torch.randn(B, Tq, H, D, generator=gen)
    valid = torch.ones(B, Tk, dtype=torch.bool)
    if pad:
        valid[1:3, Tk - 300:] = False
        valid[3] = False
    q, k, v, do = (x.to(dt).cuda() for x in (q, k, v, do))
    return q, k, v, valid.cuda(), do, dict(causal=causal,
                                            sm_scale=D ** -0.5,
                                            window=window)


def _flash_bounds(q, k, valid, kw):
    """Least time of each kernel for these inputs: the larger of its bytes
    (each input read once, each output written once) over HBM and its
    flops on the visible (query, key) pairs over the dtype's peak: bf16's
    tensor-core rate, and for f32 three TF32 products (3xTF32, the only
    way the tensor cores keep f32 accuracy) at the TF32 rate.  Also
    returns, for f32, the same flops on the f32 units."""
    import torch

    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    qp = torch.arange(Tq, device=q.device)[:, None]
    kp = torch.arange(Tk, device=q.device)[None, :]
    band = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if kw["causal"]:
        band = qp >= kp
        if kw["window"] is not None:
            band = band & (qp - kp < kw["window"])
    pairs = int((band[None] & valid[:, None, :]).sum()) * H
    item = q.element_size()
    q_el, kv_el, rows = q.numel(), k.numel(), B * H * Tq
    extra = valid.numel()                                # key_valid bytes
    work = {   # kernel: (bytes, flops)
        "flash_forward": ((2 * q_el + 2 * kv_el) * item + 4 * rows + extra,
                          4 * D * pairs),
        "flash_backward_dq": ((3 * q_el + 2 * kv_el) * item + 8 * rows
                              + extra, 6 * D * pairs),
        "flash_backward_dkv": ((2 * q_el + 4 * kv_el) * item + 8 * rows
                               + extra, 8 * D * pairs),
    }
    rate = BF16_FLOPS_PER_S if item == 2 else TF32_FLOPS_PER_S / 3
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / rate * 1e3
        f32_units = (None if item == 2 else
                     max(t_bytes, flops / F32_FLOPS_PER_S * 1e3))
        out[name] = (max(t_bytes, t_flops),
                     "bytes" if t_bytes >= t_flops else "operations",
                     f32_units)
    return out


def _flash_timings(q, k, v, valid, do, kw):
    """Median cold-L2 ms of each kernel, its plain version and SDPA, and
    of ``delta`` (the backward's one torch op besides the kernels)."""
    import torch
    import torch.nn.functional as F

    from distributed_deep_learning_tpu_torch.ops import attention as fa

    out, lse = fa.flash_forward(q, k, v, valid, **kw)
    delta = fa._delta(out, do)
    ms = {
        "flash_forward": _time_ms(
            lambda: fa.flash_forward(q, k, v, valid, **kw)),
        "flash_backward_dq": _time_ms(lambda: fa.flash_backward_dq(
            q, k, v, valid, do, lse, delta, **kw)),
        "flash_backward_dkv": _time_ms(lambda: fa.flash_backward_dkv(
            q, k, v, valid, do, lse, delta, **kw)),
        "delta": _time_ms(lambda: fa._delta(out, do)),
    }
    plain_fwd = _time_ms(lambda: fa.flash_attention_reference(
        q, k, v, key_valid=valid, **kw), reps=5)
    plain_bwd = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, valid, out, lse, do, **kw), reps=5)
    qs, ks, vs, dos = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qs.requires_grad_(True)
    ks.requires_grad_(True)
    vs.requires_grad_(True)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        return torch.autograd.grad(o, (qs, ks, vs), dos)

    lib_fwd = _time_ms(sdpa_fwd)
    lib_bwd = _time_ms(sdpa_fwd_bwd) - lib_fwd
    plain_bwd = {"flash_backward_dq": plain_bwd,
                 "flash_backward_dkv": plain_bwd, "backward": plain_bwd}
    return ms, {"flash_forward": plain_fwd, **plain_bwd}, {
        "flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
        "flash_backward_dkv": lib_bwd, "backward": lib_bwd}


def phase_flash_kernels():
    """Every case against the plain versions; timings of the f32 and bf16
    main cases.  Returns ``{dtype: {kernel: record}}``."""
    import torch

    from distributed_deep_learning_tpu_torch.ops import attention as fa

    records = {}
    for name, spec in FLASH_CASES:
        q, k, v, valid, do, kw = _flash_case(seed=len(name),
                                             **{**TRAIN_SHAPE, **spec})
        out, lse = fa.flash_forward(q, k, v, valid, **kw)
        dq, dk, dv = fa.flash_backward(q, k, v, valid, out, lse, do, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        key_valid=valid, **kw)
        ref = fa.flash_backward_reference(q, k, v, valid, out, lse, do, **kw)
        live = valid.any(1)              # rows with at least one key
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"flash case {name}: non-finite output")
        err_o = float((out.float() - ref_out.float())[live].abs().max())
        err_lse = float((lse - ref_lse)[live].abs().max())
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            diff = float((got.float() - want.float()).abs().max())
            errs[gname] = (diff, diff / max(float(want.float().abs().max()),
                                            1e-30))
        tol_o, tol_g = FLASH_TOL[spec.get("dtype", "f32")]
        print(f"flash {name}: O {err_o:.3e} LSE {err_lse:.3e} (tol "
              f"{tol_o:g}); dq/dk/dv rel "
              + "/".join(f"{r:.2e}" for _, r in errs.values())
              + f" (tol {tol_g:g})")
        if not (err_o <= tol_o and err_lse <= tol_o
                and all(r <= tol_g for _, r in errs.values())):
            raise RuntimeError(f"flash case {name}: kernel disagrees with "
                               "its plain version")
        if spec.get("pad"):
            zero = all(bool((g[~live] == 0).all()) for g in (dq, dk, dv))
            print(f"flash {name}: fully padded row finite, gradients "
                  f"exactly zero: {zero}")
            if not zero:
                raise RuntimeError("fully padded row: non-zero gradients")
        if name in ("f32", "bf16"):
            ms, plain, lib = _flash_timings(q, k, v, valid, do, kw)
            bounds = _flash_bounds(q, k, valid, kw)
            abs_err = {"flash_forward": max(err_o, err_lse),
                       "flash_backward_dq": errs["dq"][0],
                       "flash_backward_dkv": max(errs["dk"][0],
                                                 errs["dv"][0])}
            records[name] = {}
            for kname in abs_err:
                rec = dict(max_abs_err=abs_err[kname], ms=ms[kname],
                           plain_ms=plain[kname], bound_ms=bounds[kname][0],
                           bound_by=bounds[kname][1],
                           library_ms=lib[kname])
                records[name][kname] = rec
                f32_units = bounds[kname][2]
                print(f"flash {name} {kname}: kernel {rec['ms']:.4f} ms, "
                      f"plain {rec['plain_ms']:.4f} ms, sdpa "
                      f"{rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}"
                      + (", 3xTF32" if f32_units else "") + "), "
                      f"{rec['bound_ms'] / rec['ms']:.1%} of bound"
                      + (f"; f32-unit bound {f32_units:.4f} ms"
                         if f32_units else ""))
            total = (ms["delta"] + ms["flash_backward_dq"]
                     + ms["flash_backward_dkv"])
            bound = (bounds["flash_backward_dq"][0]
                     + bounds["flash_backward_dkv"][0])
            print(f"flash {name} backward total: delta {ms['delta']:.4f} + "
                  f"dq {ms['flash_backward_dq']:.4f} + dkv "
                  f"{ms['flash_backward_dkv']:.4f} = {total:.4f} ms vs sdpa "
                  f"backward {lib['backward']:.4f} ms "
                  f"({total / lib['backward']:.2f}x), plain "
                  f"{plain['backward']:.4f} ms, kernels' bound "
                  f"{bound:.4f} ms")
    return records


# --- phases 8 and 9: training through the CLI -------------------------------

TRAIN_ROWS, TRAIN_T, TRAIN_VOCAB, TRAIN_BATCH, TRAIN_LAYERS = \
    48, 2048, 32768, 4, 12
#: phase 15's decode shape, held against the plain version in phase 3: the
#: CLI's paged engine on the model trained at T 2048 (max_len 2048, so 128
#: blocks of 16 a slot, pools of 2 x 8 x 128 blocks and the trash block), 8
#: slots, bf16 queries and pools; the CLI trace's prompts of 2-8 tokens and
#: 1-16 new ones keep 2-24 positions live
SERVE_BF16_SHAPE = dict(DECODE_SHAPE, Bps=TRAIN_T // 16,
                        N=2 * 8 * (TRAIN_T // 16) + 1)
SERVE_BF16_LENS = (2, 24)


def _write_tokens() -> Path:
    """A seeded ``tokens.npy`` of +1 ramps over [1, vocab) (the synthetic
    LM rule); row 0 crosses id vocab-1, so ``lm_dataset`` finds the whole
    vocabulary."""
    import numpy as np

    rng = np.random.default_rng(0)
    start = rng.integers(1, TRAIN_VOCAB, size=(TRAIN_ROWS, 1))
    start[0, 0] = TRAIN_VOCAB - 100
    ramp = np.arange(TRAIN_T + 1)[None, :]
    rows = ((start - 1 + ramp) % (TRAIN_VOCAB - 1) + 1).astype(np.int32)
    assert rows.max() == TRAIN_VOCAB - 1 and rows.min() >= 1
    out = ROOT / "build" / "chip_smoke_tokens"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "tokens.npy", rows)
    return out


@contextlib.contextmanager
def _launch_dtypes():
    """Count the flash kernels' launches by (launcher, input dtype) while
    the block runs."""
    from distributed_deep_learning_tpu_torch.ops import attention as fa

    seen, real = collections.Counter(), fa._launch

    def counting(name, q, *args, **kw):
        seen[(name, str(q.dtype).replace("torch.", ""))] += 1
        return real(name, q, *args, **kw)

    fa._launch = counting
    try:
        yield seen
    finally:
        fa._launch = real


class _Tee:
    """A text stream that writes to stdout and keeps a copy."""

    def __init__(self):
        self.out, self.kept = sys.stdout, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _train(data_dir: Path, attention: str, *flags, label=None,
           mode="sequential"):
    """One epoch through ``main(argv)``; returns the history, the flash
    kernels' launches during it (zeroed just before) and step time,
    tokens/s, peak device memory, the decode kernel's launches (zeroed
    just before: a post-train ``--serve --paged`` launches it), the run's
    log and what its post-train serving served (:func:`_served_runs`)."""
    import torch

    from distributed_deep_learning_tpu_torch.__main__ import main as cli
    from distributed_deep_learning_tpu_torch.ops import attention as fa
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    label = label or attention
    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    for c in counters + (paged_flash_decode,):
        c.launches = 0
    gc.collect()            # the previous run's model and optimizer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tee = _Tee()
    with contextlib.redirect_stdout(tee), _served_runs() as served:
        state, hist = cli(["gpt", "-m", mode, "-l", str(TRAIN_LAYERS),
                           "-s", "768", "-e", "1", "-b", str(TRAIN_BATCH),
                           "--attention", attention, "--data-dir",
                           str(data_dir), *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    opt_state_bytes = sum(t.numel() * t.element_size()
                          for st in state.optimizer.state.values()
                          for t in st.values() if torch.is_tensor(t))
    del state
    peak = torch.cuda.max_memory_allocated()
    train = hist[0]
    losses = train.step_losses
    step_s = statistics.median(train.step_seconds[1:])
    tok_s = TRAIN_BATCH * TRAIN_T / step_s
    print(f"train[{label}]: {len(losses)} steps, losses "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"train[{label}]: {step_s:.4f} s/step (median of steps 2-"
          f"{len(losses)}), {tok_s:.1f} tokens/s, epoch loss "
          f"{train.loss:.9f}, accuracy {train.accuracy:.3f}, val loss "
          f"{hist[-2].loss:.9f}, test loss {hist[-1].loss:.9f}, peak memory "
          f"{peak / 2**30:.2f} GiB, {wall:.1f} s with model build")
    if not all(map(lambda x: x == x and abs(x) != float("inf"),
                   losses + [h.loss for h in hist])):
        raise RuntimeError(f"train[{label}]: a non-finite loss")
    return hist, launches, dict(step_s=step_s, tokens_per_s=tok_s, peak=peak,
                                decode_launches=paged_flash_decode.launches,
                                log="".join(tee.kept), served=served,
                                opt_state_bytes=opt_state_bytes)


def _phase_steps():
    """Train, validation and test steps of the smoke epoch."""
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split

    return [len(s) // TRAIN_BATCH
            for s in train_val_test_split(TRAIN_ROWS, seed=42)]


def _expected_launches(forward_per_train_step=1, backward_per_step=1):
    steps = _phase_steps()
    return {"flash_forward": (forward_per_train_step * steps[0]
                              + sum(steps[1:])) * TRAIN_LAYERS,
            "flash_backward_dq": backward_per_step * steps[0] * TRAIN_LAYERS,
            "flash_backward_dkv": backward_per_step * steps[0]
            * TRAIN_LAYERS}


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_train_flash(data_dir: Path):
    hist, launches, perf = _train(data_dir, "flash")
    steps = _phase_steps()
    losses = hist[0].step_losses
    if len(losses) != steps[0]:
        raise RuntimeError(f"train: {len(losses)} steps, expected {steps[0]}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss did not fall ({losses[0]} -> "
                           f"{losses[-1]})")
    want = _expected_launches()
    print(f"train[flash]: launches {launches}, expected {want} "
          f"(train/val/test steps {steps} x {TRAIN_LAYERS} layers)")
    if launches != want:
        raise RuntimeError("train: a layer of a step did not go through "
                           "the flash kernels")
    return hist, launches, perf


def phase_train_dense(data_dir: Path, flash_hist, flash_perf):
    hist, launches, perf = _train(data_dir, "dense")
    if any(launches.values()):
        raise RuntimeError(f"dense run launched flash kernels: {launches}")
    first = (hist[0].step_losses[0], flash_hist[0].step_losses[0])
    epoch = (hist[0].loss, flash_hist[0].loss)
    rel_first = abs(first[0] - first[1]) / abs(first[1])
    rel_epoch = abs(epoch[0] - epoch[1]) / abs(epoch[1])
    print(f"dense vs flash: first step loss rel diff {rel_first:.2e} (tol "
          f"1e-4), epoch train loss rel diff {rel_epoch:.2e} (tol 1e-2); "
          f"tokens/s dense {perf['tokens_per_s']:.1f} vs flash "
          f"{flash_perf['tokens_per_s']:.1f}; peak memory dense "
          f"{perf['peak'] / 2**30:.2f} GiB vs flash "
          f"{flash_perf['peak'] / 2**30:.2f} GiB")
    if not (rel_first <= 1e-4 and rel_epoch <= 1e-2):
        raise RuntimeError("dense and flash training disagree")


# --- phases 10-12: bf16, -m data, remat, accumulation, checkpoints ---------


#: phase 15's post-train flags on phase 10's and phase 11's runs
SERVE_PAGED_FLAGS = ("--generate", "16", "--serve", "--paged",
                     "--prefill-chunk", "64")
SERVE_SLOT_FLAGS = ("--serve",)


def phase_train_bf16(data_dir: Path, f32_hist, serve=False):
    """Phase 10: phase 8's run in bf16, every launch on the bf16
    instantiations; ``serve``: with phase 15's post-train flags."""
    with _launch_dtypes() as seen:
        hist, launches, perf = _train(
            data_dir, "flash", "--dtype", "bfloat16",
            *(SERVE_PAGED_FLAGS if serve else ()), label="bf16")
    served = perf.pop("served")
    if serve:
        perf["served"] = _hold_served(served, "post-train [bf16 serve "
                                              "--paged]")
    losses = hist[0].step_losses
    want = _expected_launches()
    print(f"train[bf16]: launches {launches}, expected {want}; by launcher "
          f"and dtype {dict(sorted(seen.items()))}")
    if launches != want or {dt for _, dt in seen} != {"bfloat16"} \
            or sum(seen.values()) != sum(launches.values()):
        raise RuntimeError("train[bf16]: a layer of a step did not go "
                           "through the bf16 flash kernels")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train[bf16]: loss did not fall ({losses[0]} "
                           f"-> {losses[-1]})")
    if f32_hist is not None:
        rel = _rel(losses[0], f32_hist[0].step_losses[0])
        print(f"bf16 vs f32: first step loss rel diff {rel:.2e} (tol 2e-2)")
        if not rel <= 2e-2:
            raise RuntimeError("bf16 and f32 training disagree")
    return hist, launches, perf


#: ``--grad-accum 2`` against the plain ``-m data`` run, each train step's
#: loss (relative): the same tokens (none padded, so the mean of the
#: microbatch means is the batch mean) through GEMMs of half the rows
ACCUM_STEP_TOL = 1e-4


@contextlib.contextmanager
def _planted_half_batch():
    """A planted fault: every second train-mode loss (the second
    microbatch of each step) keeps its value but sends a zero gradient,
    so the update sees half the batch.  Phase 11's check of
    ``--grad-accum 2`` must fail under it."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    real, calls = TokenCrossEntropy.__call__, [0]

    def planted(self, pred, y):
        loss = real(self, pred, y)
        if not torch.is_grad_enabled():
            return loss
        calls[0] += 1
        return loss if calls[0] % 2 else loss.detach() + 0.0 * loss

    TokenCrossEntropy.__call__ = planted
    try:
        yield
    finally:
        TokenCrossEntropy.__call__ = real


def phase_data_parallel(data_dir: Path, bf16_hist, bf16_perf, serve=False):
    """Phase 11: ``-m data`` at world 1 on NCCL, plain (``serve``: with
    phase 15's post-train flag), ``--remat`` under the policies
    ``nothing`` and ``dots`` (the flash Function inside a selective
    checkpoint), and ``--grad-accum 2``."""
    import torch.distributed as dist

    bf16 = ("--dtype", "bfloat16")
    plain, launches, perf = _train(
        data_dir, "flash", *bf16, *(SERVE_SLOT_FLAGS if serve else ()),
        label="data bf16", mode="data")
    served = perf.pop("served")
    if serve:
        perf["served"] = _hold_served(served, "post-train [data bf16 serve]")
    if dist.is_initialized():
        raise RuntimeError("-m data left its process group behind")
    if launches != _expected_launches():
        raise RuntimeError(f"train[data bf16]: launches {launches}")
    first = plain[0].step_losses[0]
    if bf16_hist is not None:
        rel = _rel(first, bf16_hist[0].step_losses[0])
        print(f"data vs sequential (bf16): first step loss rel diff "
              f"{rel:.2e} (tol 1e-6); tokens/s {perf['tokens_per_s']:.1f} "
              f"vs {bf16_perf['tokens_per_s']:.1f}")
        if not rel <= 1e-6:
            raise RuntimeError("-m data and -m sequential disagree")
    remat_perf = {}
    for policy in ("nothing", "dots"):
        label = "data bf16 remat" + ("" if policy == "nothing"
                                     else f" {policy}")
        remat, r_launches, r_perf = _train(
            data_dir, "flash", *bf16, "--remat", "--remat-policy", policy,
            label=label, mode="data")
        want = _expected_launches(forward_per_train_step=2)
        rel = _rel(remat[0].step_losses[0], first)
        print(f"remat {policy}: launches {r_launches}, expected {want}; "
              f"first step loss rel diff {rel:.2e} (tol 1e-6); peak memory "
              f"{r_perf['peak'] / 2**30:.2f} GiB vs "
              f"{perf['peak'] / 2**30:.2f} GiB without remat and "
              + (f"{bf16_perf['peak'] / 2**30:.2f} GiB in phase 10"
                 if bf16_perf else "phase 10 not run"))
        if r_launches != want or not rel <= 1e-6:
            raise RuntimeError(f"--remat --remat-policy {policy}: wrong "
                               "launches or a different loss")
        remat_perf[policy] = r_perf
    want = _expected_launches(forward_per_train_step=2, backward_per_step=2)
    ref = bf16_hist if bf16_hist is not None else plain
    passed = {}
    for planted in (False, True):
        label = "data bf16 grad-accum 2" + (" planted" if planted else "")
        with _planted_half_batch() if planted else contextlib.nullcontext():
            accum, a_launches, _ = _train(data_dir, "flash", *bf16,
                                          "--grad-accum", "2", label=label,
                                          mode="data")
        rel = _rel(accum[0].loss, ref[0].loss)
        steps = [_rel(a, b) for a, b in zip(accum[0].step_losses,
                                             plain[0].step_losses)]
        print(f"{label}: launches {a_launches}, expected {want}; epoch loss "
              f"rel diff {rel:.2e} from phase 10's (tol 1e-2); per-step "
              "loss rel diff from the plain -m data run "
              + " ".join(f"{x:.2e}" for x in steps)
              + f" (tol {ACCUM_STEP_TOL:.0e} each)")
        passed[planted] = (a_launches == want and rel <= 1e-2
                         and max(steps) <= ACCUM_STEP_TOL)
    if not passed[False]:
        raise RuntimeError("--grad-accum 2: wrong launches, epoch loss or "
                           "step losses")
    if passed[True]:
        raise RuntimeError("--grad-accum 2: the check passed a planted "
                           "fault (the second microbatch's gradient "
                           "dropped)")
    return perf, remat_perf


# --- phase 15: serving after training, through the CLI ---------------------

_GENERATE_LINE = re.compile(r'"generate prompt=\[([\d, ]+)\] '
                            r'continuation=\[([\d, ]*)\]"')
_SERVE_PAGED_LINE = re.compile(
    r'"serve\(paged\): (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, '
    r'prefix hit ([\d.]+), cow (\d+), decode captures=(\d+) ticks=(\d+) '
    r'launches=(\d+)')
_SERVE_SLOT_LINE = re.compile(
    r'"serve: (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, occupancy '
    r'([\d.]+)/(\d+), decode captures=(\d+) ticks=(\d+)"')
#: the CLI's serve trace: max(2 x --max-slots, 8) requests
SERVE_REQUESTS = 16


def _one(pattern, log, label):
    found = pattern.findall(log)
    if len(found) != 1:
        raise RuntimeError(f"{label}: {len(found)} matching log lines")
    return [float(x) for x in found[0]]


#: a served greedy token against the plain forward on its own prefix: the
#: reference's top logit minus the token's, over the row's max|logit|, at
#: most one bf16 step (2^-8).  The tests' 2e-2 near-tie rule is too loose
#: here: 8 steps on uniform random ids leave logits whose top tokens crowd
#: within 1% of max|logit|, so any token near the top would pass it.
SERVE_GAP_TOL = 2.0 ** -8


@contextlib.contextmanager
def _served_runs():
    """Record what each engine ``run`` serves while the block runs: the
    engine's class, its model and geometry, the trace and the output (not
    the engine, so its caches go when its caller drops it)."""
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    runs, real = [], {cls: cls.run for cls in (PagedEngine, ServeEngine)}

    def recording(cls):
        def run(self, requests, *args, **kw):
            requests = list(requests)
            out = real[cls](self, requests, *args, **kw)
            geometry = dict(max_slots=self.max_slots, max_len=self.max_len)
            if cls is PagedEngine:
                geometry.update(
                    kv_block_size=self.block_size, num_blocks=self.num_blocks,
                    prefill_chunk=self.chunk,
                    blocks_per_slot=self.blocks_per_slot,
                    kv_dtype=str(self.pools[0]["cached_key"].dtype))
            runs.append(dict(engine=cls.__name__, model=self.model,
                             requests=requests, out=out, geometry=geometry))
            return out
        return run

    for cls in real:
        cls.run = recording(cls)
    try:
        yield runs
    finally:
        for cls, fn in real.items():
            cls.run = fn


def served_margins(model, requests, results):
    """Hold served greedy tokens against ``model``'s plain cached forward
    of each request's prompt and tokens in one call, position by position
    on the served prefix (so one flipped near-tie does not part the rest of
    a stream).  Returns the worst gap (the reference's top logit minus the
    served token's, over the row's max|logit|; 0 where the token is the
    reference's argmax) and the fraction of tokens with gap 0."""
    import numpy as np
    import torch

    dev = next(model.parameters()).device
    worst, same, total = 0.0, 0, 0
    with torch.no_grad():
        for r in requests:
            toks = torch.as_tensor(np.asarray(results[r.uid]),
                                   device=dev).long()
            seq = torch.cat([torch.as_tensor(np.asarray(r.prompt),
                                             device=dev).long(), toks[:-1]])
            hidden = model.cached_forward(
                seq[None], model.init_cache(1, seq.shape[0]))
            logits = model.logits_from(hidden[0, len(r.prompt) - 1:])
            scale = logits.abs().amax(-1)
            if model.pad_id is not None:       # never picked by an engine
                logits[:, model.pad_id] = -torch.inf
            top = logits.amax(-1)
            gap = (top - logits.gather(1, toks[:, None])[:, 0]) / scale
            worst = max(worst, float(gap.max()))
            same += int((gap == 0).sum())
            total += toks.numel()
    return worst, same / total


def _slots_swapped(q, k, v, tables, seq_lens, **kw):
    """A planted decode fault: the plain decode attention with each slot
    reading the next slot's blocks and length (a staging mix-up)."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_decode_reference

    return paged_decode_reference(q, k, v, tables.roll(1, 0),
                                  seq_lens.roll(1, 0), **kw)


def _hold_served(runs, label):
    """Phase 15's hold on what one post-train CLI run served (recorded by
    :func:`_served_runs`): no request rejected, every budget met, tokens in
    [1, vocab), each greedy token within ``SERVE_GAP_TOL`` of the plain
    forward's argmax on its prefix (:func:`served_margins`).  For the
    paged engine also: its geometry is phase 3's ``bf16_serve`` case, and
    the trace replayed with the plain decode attention gives the same
    first tokens (the greedy agreement printed) and gaps within the
    limit, while a planted fault (:func:`_slots_swapped`) must break
    it.  Returns a summary for phase 15's report."""
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    if len(runs) != 1:
        raise RuntimeError(f"{label}: {len(runs)} serving runs recorded")
    run = runs.pop()
    model, reqs, out, geo = (run[k] for k in ("model", "requests", "out",
                                              "geometry"))
    if out["errors"]:
        raise RuntimeError(f"{label}: {out['errors']} rejected")
    _check_results(label, out["results"], {r.uid: r.max_new_tokens
                                           for r in reqs},
                   vocab=model.vocab_size)
    gap, agree = served_margins(model, reqs, out["results"])
    print(f"{label}: {run['engine']} {geo}; greedy tokens against the "
          f"plain forward on their prefix: worst gap {gap:.3e} of "
          f"max|logit| (tol {SERVE_GAP_TOL:g}), argmax agreement "
          f"{agree:.4f}")
    if not gap <= SERVE_GAP_TOL:
        raise RuntimeError(f"{label}: a served token {gap:.3e} of "
                           "max|logit| below the reference's argmax")
    summary = dict(engine=run["engine"], gap=gap, agreement=agree)
    if run["engine"] != "PagedEngine":
        return summary
    shape = SERVE_BF16_SHAPE
    want = dict(max_slots=shape["B"], kv_block_size=shape["bs"],
                blocks_per_slot=shape["Bps"], num_blocks=shape["N"] - 1,
                kv_dtype=str(torch.bfloat16))
    if any(geo[k] != v for k, v in want.items()):
        raise RuntimeError(f"{label}: engine geometry {geo} is not phase "
                           f"3's bf16_serve case {want}")
    before = paged_flash_decode.launches
    for name, attention in (("plain", None), ("planted", _slots_swapped)):
        engine = PagedEngine(
            model, device=next(model.parameters()).device,
            max_slots=geo["max_slots"], max_len=geo["max_len"],
            kv_block_size=geo["kv_block_size"],
            num_blocks=geo["num_blocks"],
            prefill_chunk=geo["prefill_chunk"], decode_attention="plain")
        if attention is not None:
            engine.attention = attention
        replay = engine.run(reqs)
        del engine
        if replay["errors"]:
            raise RuntimeError(f"{label} {name}: {replay['errors']} "
                               "rejected")
        r_gap, r_agree = served_margins(model, reqs, replay["results"])
        print(f"{label} {name} replay: worst gap {r_gap:.3e} of "
              f"max|logit|, argmax agreement {r_agree:.4f}")
        summary[name] = dict(gap=r_gap, agreement=r_agree)
        if name == "plain":
            summary["plain_agreement"] = _agreement(
                out["results"], replay["results"], f"{label} vs plain")
            if not r_gap <= SERVE_GAP_TOL:
                raise RuntimeError(f"{label}: the plain replay is outside "
                                   "the gap limit")
        elif r_gap <= SERVE_GAP_TOL:
            raise RuntimeError(f"{label}: the gap check passed a planted "
                               "fault (each slot read its neighbour's "
                               "blocks)")
    if paged_flash_decode.launches != before:
        raise RuntimeError(f"{label}: a plain replay launched the kernel")
    return summary


def phase_post_train_serving(bf16_perf, data_perf):
    """Phase 15: the ``generate``, ``serve(paged):`` and ``serve:`` lines
    of phase 10's and phase 11's runs (each given when it ran), and that
    :func:`_hold_served` held what each served.  Returns the decode
    kernel's launches in phase 10's run."""
    for perf, engine in ((bf16_perf, "PagedEngine"),
                         (data_perf, "ServeEngine")):
        if perf is not None and perf.get("served", {}).get("engine") \
                != engine:
            raise RuntimeError(f"post-train: no {engine} run was held")
    launches = None
    if bf16_perf is not None:
        log = bf16_perf["log"]
        lens = [len(c.split(",")) for _, c in _GENERATE_LINE.findall(log)]
        print(f"post-train [bf16]: {len(lens)} generate lines, "
              f"continuations of {lens} tokens")
        if lens != [16, 16]:
            raise RuntimeError("post-train generate: expected two "
                               "continuations of 16 tokens")
        req, tok, tps, hit, _, cap, ticks, logged = _one(
            _SERVE_PAGED_LINE, log, "serve(paged)")
        launches = bf16_perf["decode_launches"]
        want = int(ticks) * TRAIN_LAYERS
        print(f"post-train [bf16 serve --paged]: {int(req)} requests, "
              f"{int(tok)} tokens at {tps:.1f} tok/s, prefix hit {hit:.3f},"
              f" decode captures {int(cap)}, {int(ticks)} ticks, "
              f"paged_flash_decode launches {launches} (logged "
              f"{int(logged)}), ticks x layers {want}")
        if int(req) != SERVE_REQUESTS or int(cap) != 1 or \
                not launches == int(logged) == want:
            raise RuntimeError("post-train serve --paged: a request "
                               "rejected, not one capture, or not one "
                               "kernel launch per layer per tick")
    if data_perf is not None:
        req, tok, tps, occ, slots, cap, ticks = _one(
            _SERVE_SLOT_LINE, data_perf["log"], "serve")
        print(f"post-train [data bf16 serve]: {int(req)} requests, "
              f"{int(tok)} tokens at {tps:.1f} tok/s, occupancy "
              f"{occ:.2f}/{int(slots)}, decode captures {int(cap)}, "
              f"{int(ticks)} ticks")
        if int(req) != SERVE_REQUESTS or int(cap) != 1:
            raise RuntimeError("post-train serve: a request rejected or "
                               "not one capture")
    return launches


def phase_checkpoint(data_dir: Path):
    """Phase 12: a mid-epoch save, the final step removed, ``--resume``."""
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    flags = ("--dtype", "bfloat16", "--dropout", "0.1", "--checkpoint-dir",
             str(ckdir), "--checkpoint-every", "4")
    t0 = time.perf_counter()
    whole, _, _ = _train(data_dir, "flash", *flags, label="ckpt whole",
                         mode="data")
    ckpt = Checkpointer(ckdir)
    steps = _phase_steps()[0]
    print(f"checkpoint: steps {ckpt.all_steps()} after the whole run "
          f"({time.perf_counter() - t0:.1f} s with saves)")
    if ckpt.all_steps() != [4, steps]:
        raise RuntimeError(f"checkpoint: steps {ckpt.all_steps()}, expected "
                           f"[4, {steps}]")
    first_manifest = ckpt.read_manifest(steps)
    for name in (f"ckpt-{steps}.pt", f"extra-{steps}.json",
                 f"manifest-{steps}.json"):
        (ckdir / name).unlink()
    resumed, _, _ = _train(data_dir, "flash", *flags, "--resume",
                           label="ckpt resumed", mode="data")
    got, want = resumed[0].step_losses, whole[0].step_losses[4:]
    worst = max(_rel(a, b) for a, b in zip(got, want)) if got else 1.0
    print(f"checkpoint: resumed at batch 4, steps 5-{steps} losses rel diff "
          f"{worst:.2e} from the run never stopped (tol 1e-6)")
    if len(got) != steps - 4 or not worst <= 1e-6:
        raise RuntimeError("checkpoint: the resumed run differs")
    t0 = time.perf_counter()
    ckpt.load(steps)                    # raises unless every CRC matches
    manifest = ckpt.read_manifest(steps)
    same = sum(manifest["leaves"][k]["crc32"] == r["crc32"]
               for k, r in first_manifest["leaves"].items())
    print(f"checkpoint: step {steps} verifies against its manifest "
          f"({len(manifest['leaves'])} leaves, {time.perf_counter() - t0:.1f}"
          f" s); {same} of {len(first_manifest['leaves'])} leaf CRCs equal "
          "to the uninterrupted run's")
    shutil.rmtree(ckdir)


# --- phase 16: the fused head at the training shape -----------------------

#: fused head vs the logits path: the loss (relative) and each gradient
#: over its largest |element|; dh of bf16 hidden states is bf16 on both
#: sides, each rounded from f32 sums in other orders, so it is held to one
#: bf16 step (2^-7 of an element, at most 2^-7 of the largest)
FUSED_TOL = {"loss": 1e-5, "grad": 1e-4, "bf16_dh": 2.0 ** -7}


def _head_pass(model, h, targets, fused):
    """Loss, dh, dW, the peak bytes allocated above the start and the
    median ms of 3 forward+backward passes of the tied head with the token
    cross-entropy: ``CausalLM.loss`` (fused) or the training path's
    ``token_cross_entropy`` over ``logits_from``."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    ce, times, peak = TokenCrossEntropy(), [], 0
    for _ in range(3):
        x = h.detach().requires_grad_()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = model.loss(x, targets) if fused else \
            ce(model.logits_from(x), targets)
        loss.backward()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return (loss.item(), x.grad.float(), model.tok.weight.grad.float(),
            peak, statistics.median(times))


def phase_fused_head(data_dir: Path, bf16_perf):
    """Phase 16: ``CausalLM.loss`` against the logits path at the training
    shape (B 4, T 2048, V 32768, d 768; the last 64 targets of each row
    are pad), f32 and bf16 hidden states: loss, gradients, peak memory and
    time; then 8 bf16 train steps of the 12-layer model through
    ``loss`` (flash attention, AdamW) beside phase 10's.  Returns a
    summary."""
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.models.transformer import \
        CausalLM
    from distributed_deep_learning_tpu_torch.workloads.base import adamw

    gen = torch.Generator().manual_seed(16)
    model = CausalLM(vocab_size=TRAIN_VOCAB, num_layers=TRAIN_LAYERS,
                     d_model=768, num_heads=12, mlp_dim=3072,
                     max_len=TRAIN_T, attention="flash")
    model.reset_parameters(gen)
    model.cuda()
    h32 = torch.randn(TRAIN_BATCH, TRAIN_T, 768, generator=gen).cuda()
    targets = torch.randint(1, TRAIN_VOCAB, (TRAIN_BATCH, TRAIN_T),
                            generator=gen)
    targets[:, -64:] = 0
    targets = targets.cuda()
    summary = {}
    for label, h in (("f32", h32), ("bf16", h32.bfloat16())):
        fused = _head_pass(model, h, targets, fused=True)
        ref = _head_pass(model, h, targets, fused=False)
        rel = abs(fused[0] - ref[0]) / abs(ref[0])
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(fused[1:3], ref[1:3])]
        dh_tol = FUSED_TOL["bf16_dh" if label == "bf16" else "grad"]
        print(f"fused head [{label}]: loss {fused[0]:.7f} vs logits path "
              f"{ref[0]:.7f}, rel diff {rel:.2e} (tol {FUSED_TOL['loss']:g});"
              f" dh max err {errs[0]:.2e} of max|ref| (tol {dh_tol:g}), dW "
              f"{errs[1]:.2e} (tol {FUSED_TOL['grad']:g}); peak "
              f"{fused[3] / 2**20:.1f} MiB vs {ref[3] / 2**20:.1f} MiB; "
              f"forward+backward {fused[4]:.3f} ms vs {ref[4]:.3f} ms")
        if not (rel <= FUSED_TOL["loss"] and errs[0] <= dh_tol
                and errs[1] <= FUSED_TOL["grad"]):
            raise RuntimeError(f"fused head [{label}]: disagrees with the "
                               "logits path")
        summary[label] = dict(rel=rel, dh=errs[0], dw=errs[1],
                              peak=fused[3], ref_peak=ref[3], ms=fused[4],
                              ref_ms=ref[4])
    del model, h32, h
    gc.collect()

    model = CausalLM(vocab_size=TRAIN_VOCAB, num_layers=TRAIN_LAYERS,
                     d_model=768, num_heads=12, mlp_dim=3072,
                     max_len=TRAIN_T, attention="flash",
                     dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(42))
    model.cuda().train()
    opt = adamw(1e-3).build(model.named_parameters())
    rows = torch.as_tensor(np.load(data_dir / "tokens.npy")[:TRAIN_BATCH],
                           device="cuda").long()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(8):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(model(rows[:, :-1]), rows[:, 1:])
        loss.backward()
        opt.step()
        b.record()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    losses = [float(x) for x in losses]
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"train[bf16 fused head]: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {step_s:.4f} s/step, {TRAIN_BATCH * TRAIN_T / step_s:.1f} "
          f"tokens/s, peak {peak / 2**30:.2f} GiB"
          + (f" | phase 10 (logits head, CLI): {bf16_perf['step_s']:.4f} "
             f"s/step, {bf16_perf['tokens_per_s']:.1f} tokens/s, peak "
             f"{bf16_perf['peak'] / 2**30:.2f} GiB" if bf16_perf else ""))
    if not all(np.isfinite(losses)):
        raise RuntimeError("train[bf16 fused head]: a non-finite loss")
    summary["train"] = dict(step_s=step_s, peak=peak, losses=losses)
    del model, opt
    gc.collect()
    return summary


# --- phase 17: LAMB and Adafactor through the CLI ---------------------------

#: phase 17's learning rate, ten times phase 10's: LAMB's trust ratio and
#: Adafactor's parameter scale make a step about lr times a parameter's
#: norm.  The losses' fall over 8 different batches is mostly the batches'
#: own (phase 11's runs all fall alike), so it is no check of the
#: optimizers' arithmetic: :func:`_optimizer_gap` is.
OPT_LR = "1e-2"
#: the hold of each optimizer's arithmetic on the card: OPT_HOLD_STEPS
#: updates of a full-width CausalLM cut to OPT_HOLD_LAYERS layers, the same
#: seeded gradients on the card and on the CPU; the parameters must agree
#: within OPT_HOLD_ATOL (absolute, test_torch_optimizers' limit), and the
#: planted control, the card's run at learning rate 0, must not
OPT_HOLD_STEPS, OPT_HOLD_LAYERS, OPT_HOLD_ATOL = 3, 2, 1e-5


def _optimizer_params(opt, lr, device):
    """The parameters (on the CPU) after OPT_HOLD_STEPS updates of the
    CLI's ``--optimizer opt --lr lr`` recipe on ``device``, from seed 0,
    each step's gradients N(0, 1e-3) drawn on the CPU from one seed."""
    import torch

    from distributed_deep_learning_tpu_torch.models.transformer import \
        CausalLM
    from distributed_deep_learning_tpu_torch.train.state import \
        create_train_state
    from distributed_deep_learning_tpu_torch.utils import config as tconfig
    from distributed_deep_learning_tpu_torch.workloads import base, northstar

    cfg = tconfig.parse_args(["--optimizer", opt, "--lr", lr], "gpt")
    tx = base.build_optimizer(northstar.GPT_SPEC, cfg, epoch_steps=8)
    model = CausalLM(**{**FULL_MODEL, "num_layers": OPT_HOLD_LAYERS})
    state = create_train_state(model, 0, tx, device=device)
    gen = torch.Generator().manual_seed(0)
    for _ in range(OPT_HOLD_STEPS):
        for p in state.model.parameters():
            p.grad = (torch.randn(p.shape, generator=gen) * 1e-3).to(device)
        state.apply_gradients()
    return [p.detach().cpu() for p in state.model.parameters()]


def _optimizer_gap(opt):
    """``(gap, control)``: max |card - CPU| over the parameters after
    :func:`_optimizer_params` at ``OPT_LR``, and the same with the card at
    learning rate 0 (the planted control)."""
    want = _optimizer_params(opt, OPT_LR, "cpu")

    def gap(lr):
        got = _optimizer_params(opt, lr, "cuda")
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    return gap(OPT_LR), gap("0")


def phase_optimizers(data_dir: Path, bf16_perf):
    """Phase 17: each optimizer's steps on the card held against the CPU's
    (:func:`_optimizer_gap`); then phase 10's run with ``--optimizer
    lamb`` and ``adafactor`` (``--lr`` ``OPT_LR``): finite losses that
    fall, phase 10's kernel launches; step time, peak memory and optimizer
    state beside AdamW's."""
    out = {}
    for opt in ("lamb", "adafactor"):
        gap, control = _optimizer_gap(opt)
        print(f"optimizer[{opt}]: {OPT_HOLD_STEPS} steps of a "
              f"{OPT_HOLD_LAYERS}-layer full-width model, card vs CPU max "
              f"|diff| {gap:.3e} (limit {OPT_HOLD_ATOL:g}); planted control "
              f"(card at lr 0) {control:.3e}")
        if not gap <= OPT_HOLD_ATOL:
            raise RuntimeError(f"optimizer[{opt}]: the card's steps differ "
                               f"from the CPU's by {gap:.3e}")
        if not control > OPT_HOLD_ATOL:
            raise RuntimeError(f"optimizer[{opt}]: the hold cannot tell a "
                               "step at lr 0 from the CPU's")
    for opt in ("lamb", "adafactor"):
        hist, launches, perf = _train(
            data_dir, "flash", "--dtype", "bfloat16", "--optimizer", opt,
            "--lr", OPT_LR, label=f"bf16 {opt}")
        perf.pop("served")
        losses = hist[0].step_losses
        print(f"train[bf16 {opt}]: launches {launches}; optimizer state "
              f"{perf['opt_state_bytes'] / 2**20:.1f} MiB"
              + (f" | AdamW (phase 10): {bf16_perf['step_s']:.4f} s/step, "
                 f"peak {bf16_perf['peak'] / 2**30:.2f} GiB, state "
                 f"{bf16_perf['opt_state_bytes'] / 2**20:.1f} MiB"
                 if bf16_perf else ""))
        if launches != _expected_launches():
            raise RuntimeError(f"train[bf16 {opt}]: a layer of a step did "
                               "not go through the flash kernels")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"train[bf16 {opt}]: loss did not fall "
                               f"({losses[0]} -> {losses[-1]})")
        out[opt] = perf
    if bf16_perf and not out["adafactor"]["opt_state_bytes"] < \
            bf16_perf["opt_state_bytes"]:
        raise RuntimeError("adafactor: its state is not smaller than "
                           "AdamW's")
    return out


# --- phases 18-20: quantized, speculative and windowed serving --------------


def _serve_run(label, make, trace, layers=FULL_MODEL["num_layers"],
               launches_per_tick=None):
    """One engine lifetime over phase 4's trace with the decode counter
    zeroed just before: no request rejected, every budget met, tokens in
    [1, vocab), finite outputs, and ``launches_per_tick`` decode kernel
    launches a tick (one a layer unless given; 0 for the slot engine).
    Returns the output and the launches; the stats gain ``replay_ms``, the
    card's ms a replay of each captured tick (:func:`_replay_ms`), which
    a run's first-use costs do not reach."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    paged_flash_decode.launches = 0
    engine = make()
    out = engine.run(trace)
    launches, s = paged_flash_decode.launches, out["stats"]
    s["replay_ms"] = {
        name: _replay_ms(tick._graph)
        for name, tick in (("decode", engine._tick),
                           ("draft", getattr(engine, "_draft_tick", None)),
                           ("verify", getattr(engine, "_verify_tick", None)))
        if tick is not None and tick._graph is not None}
    del engine
    if out["errors"]:
        raise RuntimeError(f"{label}: {out['errors']} rejected")
    _check_results(label, out["results"],
                   {r.uid: r.max_new_tokens for r in trace})
    if s["nonfinite_tokens"]:
        raise RuntimeError(f"{label}: {s['nonfinite_tokens']} non-finite")
    per_tick = layers if launches_per_tick is None else launches_per_tick
    if not launches == s.get("paged_decode_launches", 0) == \
            s["decode_ticks"] * per_tick:
        raise RuntimeError(f"{label}: {launches} decode launches, expected "
                           f"{s['decode_ticks']} ticks x {per_tick}")
    return out, launches


def _serve_line(label, s, rec4, results):
    pe = rec4["paged_engine"]
    same = sum(a == b for uid, toks in rec4["results"].items()
               for a, b in zip(toks, results[uid]))
    total = sum(len(t) for t in rec4["results"].values())
    print(f"{label}: agreement with phase 4 {same}/{total} = "
          f"{same / total:.4f}; {s['tokens_per_sec']:.1f} tok/s vs "
          f"{pe['tokens_per_sec']:.1f}; tick {_tick_ms(s):.3f} ms vs "
          f"{_tick_ms(pe):.3f} ms over {s['decode_ticks']} ticks; on the "
          f"card a replay of " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                           s["replay_ms"].items())
          + f"; kv_cache_bytes {s['kv_cache_bytes']} vs "
          f"{pe['kv_cache_bytes']}; weight_bytes {s['weight_bytes']}")


def phase_quant_serving(rec4):
    """Phase 18: phase 4's trace through ``PagedEngine`` with int8 KV, bf16
    KV and int8 weights over int8 KV, and through the slot engine with
    bf16 KV: each graphed tick captured once, one kernel launch a layer a
    tick (none for the slot engine); each int8 run replayed with the plain
    decode attention gives the same first tokens.  Returns the kernel's
    launches in the paged runs."""
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    model, trace, cap = _full_width()
    runs = [("paged kv int8", dict(kv_dtype="int8")),
            ("paged kv bf16", dict(kv_dtype="bf16")),
            ("paged kv int8 weights int8",
             dict(kv_dtype="int8", weight_dtype="int8"))]
    launches = 0
    for label, opts in runs:
        out, n = _serve_run(f"quantized [{label}]", lambda: PagedEngine(
            model, max_len=cap, **FULL_ENGINE, **opts), trace)
        launches += n
        s = out["stats"]
        _check_tick(f"quantized [{label}]", s, captures=1)
        _serve_line(f"quantized [{label}]", s, rec4, out["results"])
        if "int8" in opts.values():
            plain, _ = _serve_run(
                f"quantized [{label}] plain", lambda: PagedEngine(
                    model, max_len=cap, decode_attention="plain",
                    **FULL_ENGINE, **opts), trace, launches_per_tick=0)
            _agreement(out["results"], plain["results"],
                       f"quantized [{label}] vs plain")
    slot, _ = _serve_run("quantized [slot kv bf16]", lambda: ServeEngine(
        model, max_slots=FULL_ENGINE["max_slots"], kv_dtype="bf16"), trace,
        launches_per_tick=0)
    _check_tick("quantized [slot kv bf16]", slot["stats"], captures=1)
    _serve_line("quantized [slot kv bf16]", slot["stats"], rec4,
                slot["results"])
    return launches


#: phase 19's draft and proposals a round
SPEC = dict(draft_layers=2, spec_k=4)
#: a speculatively served f32 token against the plain forward's argmax on
#: its own prefix (``served_margins``), over max|logit|: the verify is the
#: plain forward's arithmetic over the same f32 cache, in another order,
#: so only a top-2 tie within f32 rounding may flip (measured: 0 on the
#: H100, every token the reference's argmax)
SPEC_GAP_TOL = 1e-5


def phase_spec(rec4):
    """Phase 19: phase 4's trace with a 2-layer draft proposing 4 tokens a
    round: first tokens equal phase 4's, every token within
    ``SPEC_GAP_TOL`` of the plain forward's argmax on its prefix, one
    capture each of the draft round and the verify and none of the decode
    tick, and the kernel launched ``spec_k + 1`` times a draft layer a
    speculative tick.  Returns the launches."""
    from distributed_deep_learning_tpu_torch.serve.bench import paged_max_len
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    model, trace, _ = _full_width()
    cap = paged_max_len(model.max_len, FULL_ENGINE["kv_block_size"], True,
                        SPEC["spec_k"])
    out, launches = _serve_run(
        "spec", lambda: PagedEngine(model, max_len=cap, **FULL_ENGINE,
                                    **SPEC), trace,
        launches_per_tick=(SPEC["spec_k"] + 1) * SPEC["draft_layers"])
    s, sp = out["stats"], out["stats"]["spec"]
    captures = (s["decode_captures"], s["draft_captures"],
                s["verify_captures"])
    print(f"spec: captures decode/draft/verify {captures}; "
          f"{launches} draft launches = {s['decode_ticks']} speculative "
          f"ticks x {SPEC['spec_k'] + 1} steps x {SPEC['draft_layers']} "
          f"layers; rounds {sp['rounds']}, proposed {sp['proposed']}, "
          f"accepted {sp['accepted']}, acceptance {sp['acceptance_rate']:.4f}")
    if captures != (0, 1, 1) or sp["proposed"] != \
            sp["rounds"] * SPEC["spec_k"]:
        raise RuntimeError("spec: not one capture of the draft round and "
                           "of the verify and none of the decode tick, or "
                           "proposals not spec_k a round")
    _agreement(rec4["results"], out["results"], "spec vs phase 4")
    gap, agree = served_margins(model, trace, out["results"])
    print(f"spec: greedy tokens against the plain forward on their prefix: "
          f"worst gap {gap:.3e} of max|logit| (tol {SPEC_GAP_TOL:g}), "
          f"argmax agreement {agree:.4f}")
    if not gap <= SPEC_GAP_TOL:
        raise RuntimeError(f"spec: a served token {gap:.3e} of max|logit| "
                           "below the reference's argmax")
    _serve_line("spec", s, rec4, out["results"])
    return launches


def phase_window(rec4):
    """Phase 20: phase 4's trace on the same model with a 256-position
    sliding window (prompts reach 512 past a 64-token prefix): the kernel
    against the plain decode, the same first tokens and agreement
    printed, one launch a layer a tick.  Returns the launches."""
    from distributed_deep_learning_tpu_torch.serve.bench import build_model
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    _, trace, cap = _full_width()
    model = build_model(0, "cuda", **FULL_MODEL,
                        attention_window=SERVE_WINDOW)
    runs = {}
    for label in ("kernel", "plain"):
        out, n = _serve_run(
            f"window [{label}]", lambda: PagedEngine(
                model, max_len=cap, decode_attention=label, **FULL_ENGINE),
            trace, launches_per_tick=None if label == "kernel" else 0)
        _check_tick(f"window [{label}]", out["stats"], captures=1)
        runs[label] = (out, n)
    _agreement(runs["kernel"][0]["results"], runs["plain"][0]["results"],
               f"window {SERVE_WINDOW} kernel vs plain")
    s = runs["kernel"][0]["stats"]
    print(f"window [kernel]: {s['tokens_per_sec']:.1f} tok/s, tick "
          f"{_tick_ms(s):.3f} ms over {s['decode_ticks']} ticks (a replay "
          f"{s['replay_ms']['decode']:.3f} ms on the card), "
          f"{runs['kernel'][1]} launches")
    return runs["kernel"][1]


#: the CLI's second post-train leg on phase 10's run: speculation with a
#: 6-layer draft over int8 KV and int8 weights
SERVE_SPEC_FLAGS = ("--serve", "--paged", "--prefill-chunk", "64", "--draft",
                    "6", "--spec-k", "4", "--kv-dtype", "int8",
                    "--weight-dtype", "int8")
_SERVE_SPEC_LINE = re.compile(
    r'"serve\(paged\): (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, '
    r'prefix hit ([\d.]+), cow (\d+), decode captures=(\d+) ticks=(\d+) '
    r'launches=(\d+), draft captures=(\d+) verify captures=(\d+), spec '
    r'acceptance ([\d.]+)')


def phase_cli_spec_quant(data_dir: Path):
    """Phase 10's run with ``SERVE_SPEC_FLAGS``: its ``serve(paged):`` line
    shows every request served, the draft round and the verify captured
    once and the decode tick never, and 6 x 5 kernel launches a tick;
    what it served is held as phase 15 holds it."""
    hist, _, perf = _train(data_dir, "flash", "--dtype", "bfloat16",
                           *SERVE_SPEC_FLAGS, label="bf16 serve spec int8")
    runs = perf.pop("served")
    req, tok, tps, hit, _, dcap, ticks, logged, drcap, vcap, acc = _one(
        _SERVE_SPEC_LINE, perf["log"], "serve(paged) spec")
    launches = perf["decode_launches"]
    want = int(ticks) * 6 * 5
    print(f"post-train [bf16 serve --paged --draft 6 --spec-k 4 --kv-dtype "
          f"int8 --weight-dtype int8]: {int(req)} requests, {int(tok)} "
          f"tokens at {tps:.1f} tok/s, captures decode/draft/verify "
          f"{int(dcap)}/{int(drcap)}/{int(vcap)}, {int(ticks)} ticks, "
          f"launches {launches} (logged {int(logged)}, expected {want}), "
          f"spec acceptance {acc:.3f}")
    if int(req) != SERVE_REQUESTS or (int(dcap), int(drcap), int(vcap)) \
            != (0, 1, 1) or not launches == int(logged) == want:
        raise RuntimeError("post-train spec int8: a request rejected, "
                           "wrong captures or launches")
    if len(runs) != 1:
        raise RuntimeError(f"post-train spec int8: {len(runs)} runs")
    run = runs.pop()
    model, reqs, out = run["model"], run["requests"], run["out"]
    if out["errors"]:
        raise RuntimeError(f"post-train spec int8: {out['errors']}")
    _check_results("post-train spec int8", out["results"],
                   {r.uid: r.max_new_tokens for r in reqs},
                   vocab=model.vocab_size)
    gap, agree = served_margins(model, reqs, out["results"])
    print(f"post-train spec int8: {run['engine']} {run['geometry']}; "
          f"greedy tokens against the plain forward (int8 weights) on their"
          f" prefix: worst gap {gap:.3e} of max|logit| (tol "
          f"{SERVE_GAP_TOL:g}), argmax agreement {agree:.4f}")
    if not gap <= SERVE_GAP_TOL:
        raise RuntimeError(f"post-train spec int8: a served token {gap:.3e}"
                           " of max|logit| below the reference's argmax")
    return dict(launches=launches, gap=gap, agreement=agree,
                acceptance=acc)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default=",".join(str(i) for i in range(1, 21)),
                    help="comma-separated phases to run; the result lines "
                         "are printed only when all run")
    ap.add_argument("--waves", type=int, default=None,
                    help="the decode's split rule aims at this many blocks "
                         "an SM instead of paged_decode.WAVES (a sweep; no "
                         "result lines)")
    opts = ap.parse_args(argv)
    phases = {int(x) for x in opts.phases.split(",")}
    complete = phases == set(range(1, 21)) and opts.waves is None
    if opts.waves is not None:
        from distributed_deep_learning_tpu_torch.ops import paged_decode
        paged_decode.WAVES = opts.waves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    builds = start_builds()
    kernels = []
    if 2 in phases:
        phase_build(builds["paged_decode"])
    decode = rec = None
    if phases & {3, 4, 5, 13, 14, 18, 19, 20}:
        timing = phase_kernel() if 3 in phases else {}
        if phases & {4, 5, 13, 14, 18, 19, 20}:
            rec, launches = phase_serve(compare_engine=14 in phases)
            decode = {"name": "paged_flash_decode", "route": "cuda",
                      "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                      "launches": launches, **timing}
            kernels.append(decode)
            if 5 in phases:
                phase_plain_replay(rec)
            if 13 in phases:
                phase_eager_replay(rec)
            if 14 in phases:
                phase_slot_engine(rec)
            if 18 in phases:
                decode["quant_serve_launches"] = phase_quant_serving(rec)
            if 19 in phases:
                decode["spec_launches"] = phase_spec(rec)
            if 20 in phases:
                decode["window_launches"] = phase_window(rec)
        # phases 13 and 18-20's model: off the card before the training
        # phases read their peaks
        _full_width.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
    if 6 in phases:
        phase_ptxas(builds)
    records = phase_flash_kernels() if 7 in phases else {}
    if phases & {8, 9, 10, 11, 12, 15, 16, 17}:
        data_dir = _write_tokens()
        hist = launches = perf = None
        if phases & {8, 9}:
            hist, launches, perf = phase_train_flash(data_dir)
        if 9 in phases:
            phase_train_dense(data_dir, hist, perf)
        bf16_hist = bf16_launches = bf16_perf = data_perf = None
        if phases & {10, 11, 15, 16, 17}:
            bf16_hist, bf16_launches, bf16_perf = phase_train_bf16(
                data_dir, hist, serve=15 in phases)
        if 11 in phases:
            data_perf, _ = phase_data_parallel(data_dir, bf16_hist, bf16_perf,
                                               serve=15 in phases)
        if 15 in phases:
            serve_launches = phase_post_train_serving(bf16_perf, data_perf)
            spec_cli = phase_cli_spec_quant(data_dir)
            if decode is not None:
                decode["bf16_serve_launches"] = serve_launches
                decode["cli_spec_int8_launches"] = spec_cli["launches"]
        if 16 in phases:
            phase_fused_head(data_dir, bf16_perf)
        if 17 in phases:
            phase_optimizers(data_dir, bf16_perf)
        if 12 in phases:
            phase_checkpoint(data_dir)
        for name in FLASH_REPLACES:
            rec = records.get("f32", {}).get(name, {})
            kernels.append({"name": name, "route": "cuda",
                            "source": FLASH_SOURCE,
                            "replaces": FLASH_REPLACES[name],
                            "launches": (launches or {}).get(name), **rec,
                            "bf16": records.get("bf16", {}).get(name),
                            "bf16_train_launches":
                                (bf16_launches or {}).get(name)})
    print(f"phases {sorted(phases)} done in {time.perf_counter() - t0:.1f} s")
    if not complete:
        return 0
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
