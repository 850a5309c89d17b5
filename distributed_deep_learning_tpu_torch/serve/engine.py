"""Continuous-batching engines: the port of ``ServeEngine`` and
``PagedEngine`` from ``distributed_deep_learning_tpu/serve/engine.py``.

The host logic is the JAX engines'.  Both place arrived requests FIFO
into free slots, validate each request at submit (an invalid one lands in
``errors`` and the rest of the trace is served), run one decode tick for
every slot per engine tick, retire rows on EOS or budget and jump an idle
engine to the next arrival; latencies anchor at the wall time a request's
arrival tick is first reached, so queue wait counts.

* :class:`ServeEngine`, the slot engine: a static slot table
  (:mod:`.cache`, one row of ``max_len`` positions a slot).  A placed
  request is prefilled at its true length in one cached call, sampled at
  its last position, and its row is written whole.  (The flax engine pads
  each prompt to a power-of-two bucket so that XLA compiles one program a
  bucket; eager PyTorch has nothing to compile, so the port has no
  buckets.)  The decode attends for every slot over its whole row with
  the causal prefix mask at the slot's own position, plain PyTorch, as
  the flax engine's is plain dense attention outside any kernel.
* :class:`PagedEngine`, the paged engine: block pools with refcounts,
  prefix match and shared blocks by reference, copy-on-write before any
  write into a shared block, chunked prefill under a per-tick chunk budget
  (round-robin between prefilling slots), per-request SLO scoring.  A
  chunk prefill (one slot, ``prefill_chunk`` tokens) gathers the slot's
  logical KV, overlays the chunk's fresh K/V, attends with the causal
  prefix mask and the stored validity (plain PyTorch, as in the flax
  engine) and scatters the live positions to their blocks.  The decode
  writes every slot's new K/V into the pools (free and prefilling slots
  write to TRASH), then attends off the pools with the paged flash-decode
  kernel (:func:`..ops.paged_decode.paged_flash_decode`) at ``seq_lens =
  positions + 1``; no slot's cache is gathered.

Both decode ticks run through :class:`.graphs.DecodeTick`: staged host
numbers, then a body captured once in a CUDA graph on the card and
replayed every tick (``stats["decode_captures"]`` is 1 for an engine's
lifetime there and 0 on the CPU).

The JAX engines' serving options:

* ``kv_dtype`` (:mod:`.quant`): caches at rest in bf16, or in int8 with a
  scale per position per head (the paged engine only).  Computed K/V are
  quantized where they are written and dequantized to the compute dtype
  where a prefill or a verify gathers them; the decode kernel reads the
  int8 or bf16 pools itself.
* ``weight_dtype``: the engine serves an at-rest copy of the model
  (:func:`.quant.quantize_weights`) whose weights are dequantized where
  each is used.
* ``draft_layers`` (:mod:`.spec`, paged engine): speculative decoding.  A
  truncated draft sharing the target's weights proposes ``spec_k`` tokens
  in ``spec_k + 1`` steps, each attending off the draft's own pools through
  the decode kernel; the target verifies all ``spec_k + 1`` positions in
  one cached forward over each slot's gathered cache, in plain torch as
  the chunk prefill is.  The draft round and the verify are each captured
  once in a CUDA graph (``draft_captures``, ``verify_captures``), and the
  plain decode tick is then never run.  Greedy only.
* a model's ``attention_window``: every path attends over the last
  ``window`` positions, ``qpos - kpos < window``.

Preemption and migration, and the supervision hooks, raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, causal_prefix_attention, pick_tokens, sample_tokens,
    validate_sampling)
from distributed_deep_learning_tpu_torch.obs.metrics import Histogram
from distributed_deep_learning_tpu_torch.ops.paged_decode import (
    paged_decode_reference, paged_flash_decode)
from distributed_deep_learning_tpu_torch.serve import cache as slot_cache
from distributed_deep_learning_tpu_torch.serve import paged, quant
from distributed_deep_learning_tpu_torch.serve.graphs import DecodeTick, head
from distributed_deep_learning_tpu_torch.serve.load import slo_report
from distributed_deep_learning_tpu_torch.serve.prefill import (
    chunk_tokens, plan_chunks, write_targets)
from distributed_deep_learning_tpu_torch.serve.scheduler import (
    PagedScheduler, Request, SlotScheduler)
from distributed_deep_learning_tpu_torch.serve.spec import (greedy_accept,
                                                            truncated_draft)

#: decode attention implementations; "plain" exists so that tests and
#: chip_smoke.py can hold the kernel against its plain version in place
DECODE_ATTENTION = {"kernel": paged_flash_decode,
                    "plain": paged_decode_reference}


def _unported(option: str, item: str):
    return NotImplementedError(
        f"{option} is not ported to the PyTorch engine yet "
        f"(ROADMAP.md {item})")


def _latency(h_ttft: Histogram, h_itl: Histogram, h_e2e: Histogram) -> dict:
    return {
        "ttft_p50_s": h_ttft.percentile(50),
        "ttft_p99_s": h_ttft.percentile(99),
        "ttft_mean_s": h_ttft.mean,
        "itl_p50_s": h_itl.percentile(50),
        "itl_p99_s": h_itl.percentile(99),
        "e2e_p50_s": h_e2e.percentile(50),
        "e2e_p99_s": h_e2e.percentile(99),
        "e2e_max_s": h_e2e.max if h_e2e.count else None,
        "measured_requests": h_e2e.count,
    }


class _Engine:
    """What the two engines share: the model (or its at-rest copy under
    ``weight_dtype``) on its device, sampling, and the end of a decode
    tick."""

    def __init__(self, model: CausalLM, device, max_slots: int, eos_id,
                 temperature: float, top_k, top_p, generator, kv_dtype,
                 weight_dtype):
        validate_sampling(top_k, top_p)
        quant.check_dtype("kv_dtype", kv_dtype)
        quant.check_dtype("weight_dtype", weight_dtype)
        self.kv_dtype, self.weight_dtype = kv_dtype, weight_dtype
        self.device = resolve_device(device)
        if weight_dtype is not None:
            model = quant.quantize_weights(model, weight_dtype)
        self.model = model.to(self.device).eval()
        self.weight_bytes = quant.weight_bytes(self.model)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.eos_id = eos_id
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.generator = generator
        self.pad_fill = model.pad_id if model.pad_id is not None else 0

    def _tensor(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _sample(self, hidden_last):
        return sample_tokens(self.model, hidden_last,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p, generator=self.generator)

    def _decode(self) -> np.ndarray:
        """Run the staged tick; returns ``(2, max_slots)``: each slot's
        token and whether its hidden state was finite.  The token is the
        tick's greedy argmax, or at ``temperature > 0`` a sample drawn
        eagerly from its logits (a graph captures no generator)."""
        logits, picked = self._tick(self)
        if self.temperature > 0.0:
            picked = torch.stack([pick_tokens(
                self.model, logits.clone(), temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p,
                generator=self.generator), picked[1]])
        return picked.cpu().numpy()           # host fetch = device barrier


class ServeEngine(_Engine):
    """Continuous batching over a static slot table (see the module
    docstring) for a :class:`..models.transformer.CausalLM` holding its
    weights; the engine moves it to ``device`` (``cuda`` unless the caller
    passes ``"cpu"``).  The table persists across ``run()`` calls, and
    every run replays the one captured decode tick.  ``kv_dtype="bf16"``
    stores the table in bf16 (the attention reads it back in the compute
    dtype, the tick's own position unrounded, as the flax engine's cached
    forward does); int8 KV needs the paged engine."""

    def __init__(self, model: CausalLM, *, device="cuda", max_slots: int = 8,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None):
        quant.check_dtype("kv_dtype", kv_dtype)
        if kv_dtype == "int8":
            raise ValueError(
                "kv_dtype='int8' requires the paged engine (PagedEngine /"
                " --paged): int8 KV stores per-position scales alongside "
                "the block pools; the v1 slot table supports bf16 only")
        super().__init__(model, device, max_slots, eos_id, temperature,
                         top_k, top_p, generator, kv_dtype, weight_dtype)
        self.max_len = int(max_len if max_len is not None else model.max_len)
        if self.max_len > model.max_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"max_len {model.max_len}")
        self.slots = slot_cache.allocate_slots(
            self.model, self.max_slots, self.max_len, self.device,
            dtype=torch.bfloat16 if kv_dtype == "bf16" else None)
        self.kv_cache_bytes = slot_cache.kv_cache_bytes(self.slots)
        self._rows = torch.arange(self.max_slots, device=self.device)
        # staged: row 0 the slots' tokens, row 1 their positions
        self._tick = DecodeTick(ServeEngine._decode_body, (2, self.max_slots),
                                self.device)

    # --- device programs ----------------------------------------------------
    @torch.no_grad()
    def _prefill(self, prompt, slot: int) -> int:
        """The whole prompt in one cached call into a fresh row, written
        over slot ``slot``; returns the token sampled at its last
        position."""
        toks = self._tensor(prompt, torch.long)[None]
        fresh = self.model.init_cache(1, self.max_len)
        hidden = self.model.cached_forward(toks, fresh)
        slot_cache.write_slot(self.slots, fresh, slot)
        return int(self._sample(hidden[:, -1])[0])

    @torch.no_grad()
    def _decode_body(self, staged):
        """One token for every slot: write its K/V at its position, attend
        over its row up to that position."""
        toks, pos = staged[0][:, None], staged[1]
        valid = self.model.token_valid(toks)[:, 0]
        rows, window = self._rows, self.model.attention_window

        def attend(i, q, k, v):
            layer = self.slots["layers"][i]
            ck, cv = layer["cached_key"], layer["cached_value"]
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
            layer[slot_cache.VALID_LEAF][rows, pos] = valid
            if ck.dtype != k.dtype:           # a bf16 table: read it back
                read = quant.cast_kv(layer, k.dtype)
                ck, cv = read["cached_key"], read["cached_value"]
                ck[rows, pos] = k[:, 0]
                cv[rows, pos] = v[:, 0]
            a = self.model.layers[i].self_attn
            return causal_prefix_attention(
                q, a.expand(ck), a.expand(cv),
                layer[slot_cache.VALID_LEAF], pos, window=window)

        hidden = self.model.run(toks, pos[:, None], attend)
        return head(self.model, hidden[:, 0])

    # --- host side ----------------------------------------------------------
    def _validate(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds the slot "
                f"capacity max_len={self.max_len}")

    def reset(self) -> None:
        raise _unported("warm restart (reset)", "queue 1 item 13")

    def swap_params(self, new_params) -> None:
        raise _unported("hot weight swap (swap_params)", "queue 1 item 13")

    def run(self, requests: Iterable[Request], telemetry=None,
            on_tick=None, admission=None) -> dict:
        """Serve a whole trace; returns ``{"results", "errors", "stats"}``
        (uid -> generated tokens; uid -> why a request was rejected at
        submit; throughput, occupancy, ``decode_captures`` and the
        ``latency`` percentiles)."""
        if telemetry is not None:
            raise _unported("serving telemetry", "queue 1 item 14")
        if on_tick is not None or admission is not None:
            raise _unported("tick hooks and admission control (on_tick, "
                            "admission)", "queue 1 item 13")
        sched = SlotScheduler(self.max_slots)
        n_req = 0
        errors: dict[int, str] = {}
        for req in requests:
            try:
                self._validate(req)
            except ValueError as e:
                errors[req.uid] = str(e)
                continue
            sched.submit(req)
            n_req += 1

        h_ttft, h_itl, h_e2e = Histogram(), Histogram(), Histogram()
        first_wall: dict[int, float] = {}   # uid -> first-token wall time

        def retire(req, now):
            h_e2e.observe(now - sched.arrival_wall.get(req.uid, now))
            n_tok = len(sched.finished[req.uid])
            fw = first_wall.pop(req.uid, None)
            if fw is not None and n_tok > 1:
                h_itl.observe((now - fw) / (n_tok - 1))

        t_start = time.perf_counter()
        t_prefill = t_decode = 0.0
        tick = prefill_calls = decode_ticks = occupancy_sum = nonfinite = 0
        while sched.pending or sched.occupancy:
            sched.mark_arrivals(tick, time.perf_counter())
            # admit every arrived request a free slot can take; a row
            # retired below frees its slot for the very next tick's admit
            while True:
                placed = sched.place(tick)
                if placed is None:
                    break
                idx, req = placed
                t0 = time.perf_counter()
                first = self._prefill(req.prompt, idx)
                now = time.perf_counter()
                t_prefill += now - t0
                prefill_calls += 1
                first_wall[req.uid] = now
                h_ttft.observe(now - sched.arrival_wall.get(req.uid, t0))
                done = sched.record(idx, first, self.eos_id)
                if done is not None:
                    retire(done, now)

            if not sched.occupancy:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                tick = max(tick, nxt)     # idle engine: jump to arrival
                continue

            occupancy_sum += sched.occupancy
            self._tick.host[0] = sched.last_tokens()
            self._tick.host[1] = slot_cache.tick_positions(self.slots)
            t0 = time.perf_counter()
            out, finite = self._decode()
            now = time.perf_counter()
            t_decode += now - t0
            decode_ticks += 1
            self.slots["index"] += 1      # every slot advances, as in flax
            for idx in sched.active_slots:
                nonfinite += int(not finite[idx])
                done = sched.record(idx, int(out[idx]), self.eos_id)
                if done is not None:
                    retire(done, now)
            tick += 1

        total = time.perf_counter() - t_start
        tokens = int(sum(len(v) for v in sched.finished.values()))
        stats = {
            "engine": "slot",
            "device": str(self.device),
            "requests": n_req,
            "rejected": len(errors),
            "generated_tokens": tokens,
            "tokens_per_sec": tokens / total if total else None,
            "total_seconds": total,
            "prefill_seconds": t_prefill,
            "decode_seconds": t_decode,
            "prefill_calls": prefill_calls,
            "decode_ticks": decode_ticks,
            "mean_slot_occupancy":
                occupancy_sum / decode_ticks if decode_ticks else 0.0,
            "max_slots": self.max_slots,
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "weight_bytes": self.weight_bytes,
            "decode_captures": self._tick.captures,
            "nonfinite_tokens": nonfinite,
            "latency": _latency(h_ttft, h_itl, h_e2e),
        }
        return {"results": sched.finished, "errors": errors, "stats": stats}


class PagedEngine(_Engine):
    """Paged continuous batching with prefix reuse and chunked prefill
    (see the module docstring).

    ``model`` is a :class:`..models.transformer.CausalLM` holding its
    weights; the engine moves it to ``device`` (``cuda`` unless the caller
    passes ``"cpu"``).  The block pools and the prefix index persist
    across ``run()`` calls, so a later trace sharing prompts with an
    earlier one starts with a warm prefix cache.

    ``draft_layers`` turns speculative decoding on (``spec_k`` proposals a
    round, greedy only); each slot's logical buffer then gets ``spec_k +
    1`` positions of headroom past ``max_len``, in whole blocks, and the
    draft's pools inherit ``kv_dtype``."""

    def __init__(self, model: CausalLM, *, device="cuda", max_slots: int = 8,
                 max_len: Optional[int] = None, kv_block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 prefill_chunks_per_tick: int = 1,
                 draft_layers: Optional[int] = None, spec_k: int = 4,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 preempt: bool = False, migrate: str = "host",
                 decode_attention: str = "kernel"):
        if preempt or migrate != "host":
            raise _unported("preemption and KV spill (preempt, migrate)",
                            "queue 1 item 13")
        if decode_attention not in DECODE_ATTENTION:
            raise ValueError(f"decode_attention must be one of "
                             f"{sorted(DECODE_ATTENTION)}, got "
                             f"{decode_attention!r}")
        self.spec_k = int(spec_k)
        self.draft_layers = draft_layers
        if draft_layers is not None:
            if temperature != 0.0:
                raise ValueError("speculative decoding is greedy-only "
                                 "(acceptance is exact-match against the "
                                 "target argmax); set temperature=0")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        super().__init__(model, device, max_slots, eos_id, temperature,
                         top_k, top_p, generator, kv_dtype, weight_dtype)
        self.attention = DECODE_ATTENTION[decode_attention]
        self.window = model.attention_window
        self.max_len = int(max_len if max_len is not None else model.max_len)

        bs = int(kv_block_size)
        if bs < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {bs}")
        self.block_size = bs
        self.chunk = int(prefill_chunk)
        if self.chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.chunks_per_tick = max(1, int(prefill_chunks_per_tick))
        # speculation writes up to spec_k positions past the stream's tip
        headroom = self.spec_k + 1 if draft_layers is not None else 0
        self.padded_len = -(-(self.max_len + headroom) // bs) * bs
        if self.padded_len > model.max_len:
            raise ValueError(
                f"slot buffer {self.padded_len} (max_len {self.max_len} + "
                f"speculative headroom {headroom}, in whole blocks) "
                f"exceeds the model's max_len {model.max_len}; lower "
                f"max_len or spec_k")
        if self.chunk > self.padded_len:
            raise ValueError(f"prefill_chunk {self.chunk} exceeds the "
                             f"slot buffer {self.padded_len}")
        self.blocks_per_slot = self.padded_len // bs
        if num_blocks is None:
            # 1x for the live slots + 1x retention headroom so the prefix
            # index can keep blocks alive after their request
            num_blocks = 2 * self.max_slots * self.blocks_per_slot
        self.num_blocks = int(num_blocks)
        self.manager = paged.BlockManager(num_blocks, bs, self.max_slots,
                                          self.blocks_per_slot)
        self.pools = self._build_pools(self.model)
        self.kv_cache_bytes = paged.pool_bytes(self.pools)
        # staged, a row per slot: its block table, then position, token,
        # write block and write offset
        self._tick = DecodeTick(PagedEngine._decode_body,
                                (self.max_slots, self.blocks_per_slot + 4),
                                self.device, counters=(paged_flash_decode,))
        self.draft = self.draft_pools = None
        if draft_layers is not None:
            self.draft = truncated_draft(self.model, draft_layers)
            self.draft_pools = self._build_pools(self.draft)
            self.kv_cache_bytes += paged.pool_bytes(self.draft_pools)
            # staged, a row per slot: its block table, position, pending
            # token, then the round's spec_k + 1 write blocks and offsets
            T = self.spec_k + 1
            shape = (self.max_slots, self.blocks_per_slot + 2 + 2 * T)
            self._draft_tick = DecodeTick(PagedEngine._draft_body, shape,
                                          self.device,
                                          counters=(paged_flash_decode,))
            self._verify_tick = DecodeTick(PagedEngine._verify_body, shape,
                                           self.device)
            self._verify_tick.host = self._draft_tick.host
            # the draft round's proposals, read by the verify
            self._props = torch.zeros(self.max_slots, self.spec_k,
                                      dtype=torch.int64, device=self.device)

    def _build_pools(self, model):
        attn = model.layers[0].self_attn
        return paged.build_pools(
            model.num_layers, self.num_blocks + 1, self.block_size,
            attn.kv_heads, attn.head_dim, dtype=model.dtype,
            device=self.device, kv_dtype=self.kv_dtype)

    # --- device programs ----------------------------------------------------
    def _scatter(self, layer, k, v, valid, wb, wo):
        """Write fresh K/V rows into one layer's pools in their at-rest
        form."""
        if self.kv_dtype is not None:
            k = quant.quantize_kv(k, self.kv_dtype)
            v = quant.quantize_kv(v, self.kv_dtype)
        paged.scatter_span(layer, k, v, valid, wb, wo)

    def _gather(self, layer, tables, dtype):
        """The slots' logical caches from one layer's pools in the
        compute dtype (int8 dequantized as ``q * s`` in f32)."""
        return quant.dequant_cache(paged.gather_slot(layer, tables.long()),
                                   dtype)

    def _prefill_chunk(self, model, pools, toks, table, pos: int, wb, wo):
        """``model``'s hidden states for one slot's chunk ``toks`` ``(1,
        n)`` at ``pos``: each layer gathers the slot's cache, overlays the
        chunk's fresh K/V, attends with the causal prefix mask, the stored
        validity and the window, and scatters the live positions."""
        valid = model.token_valid(toks)
        n = toks.shape[1]

        def attend(i, q, k, v):
            layer = pools[i]
            cache = self._gather(layer, table, k.dtype)
            ck, cv, cvalid = (cache["cached_key"], cache["cached_value"],
                              cache[paged.VALID_LEAF])
            ck[:, pos:pos + n] = k
            cv[:, pos:pos + n] = v
            cvalid[:, pos:pos + n] = valid
            a = model.layers[i].self_attn
            y = causal_prefix_attention(q, a.expand(ck), a.expand(cv),
                                        cvalid, pos, window=self.window)
            self._scatter(layer, k[0], v[0], valid[0], wb, wo)
            return y

        positions = pos + torch.arange(n, device=self.device)
        return model.run(toks, positions, attend)

    @torch.no_grad()
    def _chunk(self, tokens, table, pos: int, logit_idx: int, wb, wo):
        """One prefill chunk for one slot (the draft's K/V for it too,
        when speculating); returns the token sampled at ``logit_idx`` as a
        device scalar (meaningful on the final chunk)."""
        toks = self._tensor(tokens, torch.long)[None]
        table = self._tensor(table, torch.long)
        wb, wo = self._tensor(wb, torch.long), self._tensor(wo, torch.long)
        hidden = self._prefill_chunk(self.model, self.pools, toks, table,
                                     pos, wb, wo)
        if self.draft is not None:
            self._prefill_chunk(self.draft, self.draft_pools, toks, table,
                                pos, wb, wo)
        return self._sample(hidden[0, logit_idx:logit_idx + 1])[0]

    def _paged_attend(self, model, pools, tables, seq_lens, wb, wo, valid):
        """``attend(i, q, k, v)`` for one new position a slot: write its
        K/V (validity ``valid``) at ``wb``/``wo``, then attend off the
        pools through the decode attention."""
        S = tables.shape[0]

        def attend(i, q, k, v):
            layer = pools[i]
            self._scatter(layer, k[:, 0], v[:, 0], valid, wb, wo)
            a = model.layers[i].self_attn
            qg = q[:, 0].reshape(S, a.kv_heads, a.group, a.head_dim)
            kp, vp = layer["cached_key"], layer["cached_value"]
            kw = {}
            if quant.is_quant(kp):
                kp, vp, kw = kp.q, vp.q, dict(k_scale=kp.s, v_scale=vp.s)
            out = self.attention(qg.contiguous(), kp, vp, tables, seq_lens,
                                 valid_pool=layer[paged.VALID_LEAF],
                                 window=self.window, **kw)
            return out.reshape(S, 1, a.num_heads, a.head_dim)

        return attend

    @torch.no_grad()
    def _decode_body(self, staged):
        """One token for every slot.  Each layer writes its new K/V first,
        then attends off the pools."""
        bps = self.blocks_per_slot
        tables = staged[:, :bps].to(torch.int32).contiguous()
        pos, toks = staged[:, bps], staged[:, bps + 1:bps + 2]
        attend = self._paged_attend(
            self.model, self.pools, tables, (pos + 1).to(torch.int32),
            staged[:, bps + 2], staged[:, bps + 3],
            self.model.token_valid(toks)[:, 0])
        hidden = self.model.run(toks, pos[:, None], attend)
        return head(self.model, hidden[:, 0])

    def _staged_round(self, staged):
        """A speculative round's staged row per slot: block table,
        position, pending token, ``spec_k + 1`` write blocks and offsets."""
        bps, T = self.blocks_per_slot, self.spec_k + 1
        return (staged[:, :bps].to(torch.int32).contiguous(),
                staged[:, bps], staged[:, bps + 1],
                staged[:, bps + 2:bps + 2 + T],
                staged[:, bps + 2 + T:bps + 2 + 2 * T])

    @torch.no_grad()
    def _draft_body(self, staged):
        """The draft's round: ``spec_k + 1`` greedy steps a slot, each
        writing the draft's K/V at ``pos + j`` and attending off the
        draft's pools through the decode attention; the first ``spec_k``
        proposals go to :attr:`_props` (the last step only writes its
        K/V)."""
        tables, pos, tok, wb, wo = self._staged_round(staged)
        draft, outs = self.draft, []
        for j in range(self.spec_k + 1):
            toks = tok[:, None]
            attend = self._paged_attend(
                draft, self.draft_pools, tables,
                (pos + j + 1).to(torch.int32), wb[:, j], wo[:, j],
                draft.token_valid(toks)[:, 0])
            hidden = draft.run(toks, (pos + j)[:, None], attend)
            tok = pick_tokens(draft, draft.logits_from(hidden[:, 0]))
            outs.append(tok)
        self._props.copy_(torch.stack(outs[:self.spec_k], 1))
        return self._props

    @torch.no_grad()
    def _verify_body(self, staged):
        """The target's verify: one cached forward a slot of the pending
        token and the ``spec_k`` proposals at ``pos .. pos + spec_k``, over
        the slot's gathered cache with the fresh K/V overlaid (plain torch,
        as the chunk prefill); writes their K/V.  Returns ``(S, 2 spec_k +
        2)``: the proposals, the target's greedy token at each of the
        ``spec_k + 1`` positions, and a 0/1 flag that the slot's hidden
        states are finite."""
        tables, pos, tok, wb, wo = self._staged_round(staged)
        T = self.spec_k + 1
        model = self.model
        toks = torch.cat([tok[:, None], self._props], 1)          # (S, T)
        valid = model.token_valid(toks)
        positions = pos[:, None] + torch.arange(T, device=self.device)
        rows = torch.arange(toks.shape[0], device=self.device)[:, None]

        def attend(i, q, k, v):
            layer = self.pools[i]
            cache = self._gather(layer, tables, k.dtype)
            ck, cv, cvalid = (cache["cached_key"], cache["cached_value"],
                              cache[paged.VALID_LEAF])
            ck[rows, positions] = k
            cv[rows, positions] = v
            cvalid[rows, positions] = valid
            a = model.layers[i].self_attn
            y = causal_prefix_attention(q, a.expand(ck), a.expand(cv),
                                        cvalid, pos, window=self.window)
            self._scatter(layer, k.flatten(0, 1), v.flatten(0, 1),
                          valid.flatten(), wb.flatten(), wo.flatten())
            return y

        hidden = model.run(toks, positions, attend)                # (S, T, d)
        logits = model.logits_from(hidden).flatten(0, 1)
        greedy = pick_tokens(model, logits).view(-1, T)
        finite = torch.isfinite(hidden).all(-1).all(-1)
        return torch.cat([self._props, greedy, finite[:, None].long()], 1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- host side ----------------------------------------------------------
    def _make_writable(self, idx: int, lo_pos: int, hi_pos: int) -> int:
        """Copy-on-write over every logical block touched by positions
        ``[lo_pos, hi_pos]``, before the scatter targets are computed (the
        check may swap table entries).  Returns the blocks copied."""
        copies = 0
        for lg in range(lo_pos // self.block_size,
                        hi_pos // self.block_size + 1):
            pair = self.manager.writable(idx, lg)
            if pair is not None:
                paged.copy_block(self.pools, *pair)
                if self.draft_pools is not None:   # the tables are shared
                    paged.copy_block(self.draft_pools, *pair)
                copies += 1
        return copies

    def _capacity_len(self, req: Request) -> int:
        """Stream positions a request may ever write (with the speculative
        headroom): its whole block budget, reserved at admission (so the
        pool cannot deadlock)."""
        extra = self.spec_k + 1 if self.draft is not None else 0
        return min(len(req.prompt) + req.max_new_tokens + extra,
                   self.padded_len)

    def _validate(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds the serving "
                f"capacity max_len={self.max_len}")
        worst = -(-self._capacity_len(req) // self.block_size)
        if worst > self.num_blocks:
            raise ValueError(
                f"request {req.uid}: needs up to {worst} KV blocks "
                f"({self._capacity_len(req)} positions at block size "
                f"{self.block_size}) but the pool holds only "
                f"{self.num_blocks}")

    def run(self, requests: Iterable[Request], telemetry=None) -> dict:
        """Serve a trace; returns ``{"results", "errors", "stats"}``.

        ``results`` maps uid -> generated token array; ``errors`` maps the
        uid of each request rejected at submit to its reason; ``stats``
        carries throughput, occupancy, the ``paged`` block-pool record,
        ``slo`` attainment, ``latency`` percentiles (TTFT anchors at the
        wall time a request's arrival tick is first reached, so queue wait
        counts), ``decode_captures`` and ``paged_decode_launches``, the
        kernel launches of this run (the draft's, when speculating), and
        ``spec``: rounds (one a decoding slot a speculative tick), tokens
        proposed and accepted, and the acceptance rate."""
        if telemetry is not None:
            raise _unported("serving telemetry", "queue 1 item 14")
        sched = PagedScheduler(self.max_slots)
        mgr = self.manager
        bs = self.block_size
        bps = self.blocks_per_slot
        errors: dict[int, str] = {}
        accepted: list[Request] = []
        for req in requests:
            try:
                self._validate(req)
            except ValueError as e:
                errors[req.uid] = str(e)
                continue
            sched.submit(req)
            accepted.append(req)

        h_ttft, h_itl, h_e2e = Histogram(), Histogram(), Histogram()
        stream: dict[int, list] = {}
        committed: dict[int, int] = {}
        plans: dict[int, list] = {}
        pendtok: dict[int, int] = {}
        first_wall: dict[int, float] = {}
        ttft_s: dict[int, float] = {}
        e2e_s: dict[int, float] = {}
        shared_tokens = prompt_tokens = chunk_calls = 0
        decode_ticks = occupancy_sum = nonfinite = 0
        spec_rounds = proposed_total = accepted_total = 0
        t_prefill = t_decode = 0.0
        launches0 = paged_flash_decode.launches

        def retire(req, idx, now):
            mgr.release(idx)
            for d in (stream, committed, plans, pendtok):
                d.pop(idx, None)
            e2e_s[req.uid] = now - sched.arrival_wall.get(req.uid, now)
            h_e2e.observe(e2e_s[req.uid])
            n_tok = len(sched.finished[req.uid])
            fw = first_wall.pop(req.uid, None)
            if fw is not None and n_tok > 1:
                h_itl.observe((now - fw) / (n_tok - 1))

        def emit(idx, token, now):
            """Record one token; True when the slot retired."""
            done = sched.record(idx, token, self.eos_id)
            if done is not None:
                retire(done, idx, now)
            return done is not None

        def run_chunk(idx):
            nonlocal chunk_calls, t_prefill
            req = sched.slots[idx].request
            plan = plans[idx].pop(0)
            toks = chunk_tokens(stream[idx], plan, self.chunk, self.pad_fill)
            self._make_writable(idx, committed[idx], plan.commit_to - 1)
            wb, wo, _ = write_targets(plan.feed_start, self.chunk,
                                      committed[idx], len(req.prompt),
                                      mgr.tables[idx], bs)
            t0 = time.perf_counter()
            tok = self._chunk(toks, mgr.tables[idx], plan.feed_start,
                              max(plan.logit_index, 0), wb, wo)
            committed[idx] = plan.commit_to
            mgr.register_committed(idx, stream[idx], committed[idx])
            chunk_calls += 1
            sched.note_chunk(idx)
            if plan.is_last:
                first = int(tok)            # host fetch = device barrier
                now = time.perf_counter()
                t_prefill += now - t0
                pendtok[idx] = first
                first_wall[req.uid] = now
                ttft_s[req.uid] = now - sched.arrival_wall.get(req.uid, now)
                h_ttft.observe(ttft_s[req.uid])
                stream[idx].append(first)
                emit(idx, first, now)
            else:
                self._sync()
                t_prefill += time.perf_counter() - t0

        t_start = time.perf_counter()
        tick = 0
        while sched.pending or sched.occupancy:
            sched.mark_arrivals(tick, time.perf_counter())
            # admission: FIFO while a slot AND its whole block budget are
            # available (no partial admission, no pool deadlock)
            while sched.occupancy < self.max_slots:
                head_req = sched.peek(tick)
                if head_req is None:
                    break
                sp = mgr.match_prefix(head_req.prompt)
                if not mgr.can_admit(sp, self._capacity_len(head_req)):
                    break              # wait for retirements to free KV
                idx, req = sched.place(tick)
                shared = mgr.admit(idx, sp, self._capacity_len(req))
                L = len(req.prompt)
                stream[idx] = [int(t) for t in req.prompt]
                committed[idx] = shared
                plans[idx] = plan_chunks(shared, L, self.chunk)
                sched.begin_prefill(idx, len(plans[idx]))
                shared_tokens += shared
                prompt_tokens += L

            if not sched.occupancy:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                tick = max(tick, nxt)  # idle engine: jump to arrival
                continue
            occupancy_sum += sched.occupancy

            # chunked prefill under the per-tick budget, round-robin
            budget = self.chunks_per_tick
            while budget > 0 and sched.prefilling:
                for idx in sched.chunk_order():
                    if budget == 0:
                        break
                    if idx not in sched.prefilling:
                        continue       # finished earlier this pass
                    run_chunk(idx)
                    budget -= 1

            # decode every tick: live streams advance regardless of how
            # much prefill work is queued — the stall bound
            dec = sched.decoding_slots()
            if dec and self.draft is not None:
                k, T = self.spec_k, self.spec_k + 1
                host = self._draft_tick.host
                host[:, bps:] = 0               # free and prefilling slots:
                host[:, bps + 2:bps + 2 + T] = paged.TRASH  # write to TRASH
                for i in dec:
                    c = committed[i]
                    self._make_writable(i, c, c + k)
                    pp = np.arange(c, c + T)
                    host[i, bps:bps + 2] = (c, pendtok[i])
                    host[i, bps + 2:bps + 2 + T] = mgr.tables[i][pp // bs]
                    host[i, bps + 2 + T:] = pp % bs
                host[:, :bps] = mgr.tables
                t0 = time.perf_counter()
                self._draft_tick(self)
                res = self._verify_tick(self).cpu().numpy()  # = barrier
                now = time.perf_counter()
                t_decode += now - t0
                decode_ticks += 1
                spec_rounds += len(dec)
                for i in dec:
                    a, emitted = greedy_accept(res[i, :k], res[i, k:k + T])
                    nonfinite += int(not res[i, -1])
                    proposed_total += k
                    accepted_total += a
                    committed[i] += a + 1
                    retired = False
                    for tok in emitted:
                        stream[i].append(tok)
                        if emit(i, tok, now):
                            retired = True
                            break
                    if not retired:
                        pendtok[i] = emitted[-1]
                        mgr.register_committed(i, stream[i], committed[i])
            elif dec:
                host = self._tick.host
                host[:, bps:] = 0               # free and prefilling slots:
                host[:, bps + 2] = paged.TRASH  # token 0 written to TRASH
                for i in dec:
                    c = committed[i]
                    self._make_writable(i, c, c)
                    host[i, bps:] = (c, pendtok[i], mgr.tables[i, c // bs],
                                     c % bs)
                host[:, :bps] = mgr.tables
                t0 = time.perf_counter()
                out, finite = self._decode()
                now = time.perf_counter()
                t_decode += now - t0
                decode_ticks += 1
                for i in dec:
                    tok = int(out[i])
                    nonfinite += int(not finite[i])
                    committed[i] += 1
                    stream[i].append(tok)
                    mgr.register_committed(i, stream[i], committed[i])
                    pendtok[i] = tok
                    emit(i, tok, now)
            tick += 1

        total = time.perf_counter() - t_start
        tokens = int(sum(len(v) for v in sched.finished.values()))
        hit = shared_tokens / prompt_tokens if prompt_tokens else 0.0
        speculating = self.draft is not None
        stats = {
            "engine": "paged",
            "device": str(self.device),
            "requests": len(accepted),
            "rejected": len(errors),
            "generated_tokens": tokens,
            "tokens_per_sec": tokens / total if total else None,
            "total_seconds": total,
            "prefill_seconds": t_prefill,
            "decode_seconds": t_decode,
            "prefill_chunks": chunk_calls,
            "decode_ticks": decode_ticks,
            "mean_slot_occupancy":
                occupancy_sum / decode_ticks if decode_ticks else 0.0,
            "max_slots": self.max_slots,
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "weight_bytes": self.weight_bytes,
            "kv_block_size": bs,
            "prefill_chunk": self.chunk,
            "decode_captures": self._tick.captures,
            "draft_captures":
                self._draft_tick.captures if speculating else 0,
            "verify_captures":
                self._verify_tick.captures if speculating else 0,
            "nonfinite_tokens": nonfinite,
            "paged_decode_launches": paged_flash_decode.launches - launches0,
            "paged": {
                **mgr.stats(),
                "prefix_hit_rate": hit,
                "shared_tokens": shared_tokens,
                "prompt_tokens": prompt_tokens,
                "prefill_tokens_computed": chunk_calls * self.chunk,
            },
            "spec": {
                "enabled": speculating,
                "k": self.spec_k if speculating else 0,
                "draft_layers": self.draft_layers,
                "rounds": spec_rounds,
                "proposed": proposed_total,
                "accepted": accepted_total,
                "acceptance_rate": accepted_total / proposed_total
                if proposed_total else None,
            },
            "slo": slo_report(accepted, ttft_s, e2e_s),
            "latency": _latency(h_ttft, h_itl, h_e2e),
        }
        return {"results": sched.finished, "errors": errors, "stats": stats}
