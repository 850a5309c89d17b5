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

The supervision seams (the JAX engines' ``reset``, ``swap_params``,
``run(on_tick=..., admission=...)``, the canary and preemption), kept
valid under the captured tick:

* ``run(on_tick=...)`` hands a :class:`TickReport` to the hook after
  every tick's compute and BEFORE its tokens are committed; its
  ``finite`` flags and ``logprob`` come from inside the captured tick
  (:func:`.graphs.head`), in the tick's one host copy.  A raising hook
  discards the tick (the supervisor's containment seam).
* ``reset()`` zeroes the caches and the prefix index in place: the graph
  holds their addresses, so ``decode_captures`` stays 1.
* ``swap_params()`` copies new weights into the live ones under
  ``no_grad`` (rebinding a parameter would leave the graph reading the
  old weights), after JAX's geometry check.
* ``begin_canary``/``end_canary`` (paged): candidate weights live in a
  second weight copy with its own captured tick, sharing the pools; each
  tick runs both, the canary's tick routing the other slots' KV writes
  to :data:`.paged.TRASH`.  Promote copies the candidate into the live
  weights in place.
* ``preempt=True`` (paged): a higher-priority arrival spills the
  lowest-priority decoding slot's KV at rest, through pinned host memory
  (``migrate="host"``, and npz under ``spill_dir``) or into a tensor on
  the card (``migrate="device"``, digest-checked on resume), and resumes
  it bit-exactly later.
* ``admission`` (:class:`.admission.AdmissionController`) is asked before
  each placement and fed the live signals after each tick.

Telemetry (``telemetry=``) raises ``NotImplementedError`` naming
ROADMAP.md queue 1 item 14.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.models.transformer import (
    CausalLM, causal_prefix_attention, pick_tokens, sample_tokens,
    validate_sampling)
from distributed_deep_learning_tpu_torch.obs.metrics import Histogram
from distributed_deep_learning_tpu_torch.obs.window import LiveSignals
from distributed_deep_learning_tpu_torch.ops.paged_decode import (
    paged_decode_reference, paged_flash_decode)
from distributed_deep_learning_tpu_torch.serve import cache as slot_cache
from distributed_deep_learning_tpu_torch.serve import migrate as migrate_mod
from distributed_deep_learning_tpu_torch.serve import paged, quant
from distributed_deep_learning_tpu_torch.serve.graphs import (
    DecodeTick, chosen_logprob, head)
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


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one engine tick produced, handed to ``run(on_tick=...)``
    BEFORE the tokens are recorded into the scheduler.

    This ordering is the crash-containment contract: a hook that raises
    (watchdog anomaly, injected fault) discards the tick's tokens, so a
    supervisor that replays from the committed streams regenerates
    them.

    ``finite`` carries DEVICE-computed per-request flags (``isfinite``
    over the sampled hidden state): NaN/inf anywhere in a request's
    attention window poisons its flag, which is how KV corruption
    surfaces one tick after injection.  ``logprob`` is the chosen
    token's log-probability under the engine's own head — the drift
    signal canary comparison feeds on.
    """

    tick: int
    kind: str                      # "prefill" | "decode"
    elapsed_s: float
    emitted: list                  # [(uid, token), ...] in commit order
    finite: dict                   # uid -> bool
    logprob: dict                  # uid -> float
    slots: list                    # active slot indices this tick
    engine: object
    queue_depth: int = 0


@dataclasses.dataclass
class _CanaryState:
    """Live canary: candidate weights serving a slice of slots.

    Per canary slot per tick it feeds ``observe`` with the old-vs-new
    argmax agreement and chosen log-prob drift; the reload manager turns
    those into windowed signals and a promote/rollback verdict."""

    params: object
    slots: frozenset
    observe: Optional[Callable] = None
    compared: int = 0
    agreed: int = 0
    drift_sum: float = 0.0
    nonfinite: int = 0

    def note(self, agree: bool, drift: float, finite: bool,
             now: float) -> None:
        self.compared += 1
        self.agreed += int(agree)
        self.drift_sum += drift
        self.nonfinite += int(not finite)
        if self.observe is not None:
            self.observe(agree=agree, drift=drift, finite=finite, now=now)

    def summary(self) -> dict:
        return {
            "compared": self.compared,
            "agreed": self.agreed,
            "acceptance": (self.agreed / self.compared
                           if self.compared else None),
            "mean_abs_logprob_drift": (self.drift_sum / self.compared
                                       if self.compared else None),
            "nonfinite": self.nonfinite,
            "canary_slots": sorted(self.slots),
        }


def _as_tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _check_swappable(old: dict, new: dict) -> None:
    """New weights must be drop-in for the captured ticks: the same
    names, per-leaf shape and dtype."""
    if set(old) != set(new):
        raise ValueError("swap_params: new params tree structure differs "
                         "from the engine's (cannot hot-swap)")
    for i, (name, a) in enumerate(old.items()):
        b = _as_tensor(new[name])
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(
                f"swap_params: leaf {i} mismatch — engine has "
                f"{tuple(a.shape)}/{a.dtype}, new params have "
                f"{tuple(b.shape)}/{b.dtype}; hot swap requires identical "
                f"geometry")


@torch.no_grad()
def _copy_into(module, state: dict) -> None:
    """``copy_`` every tensor of ``state`` into ``module``'s own, in
    place: a captured graph keeps reading the same addresses."""
    live = module.state_dict(keep_vars=True)
    for name, value in state.items():
        live[name].copy_(_as_tensor(value))


def _zero_(t) -> None:
    if quant.is_quant(t):
        t.q.zero_()
        t.s.zero_()
    else:
        t.zero_()


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
        # the caller's full-precision model: a quantized engine's swap
        # takes new weights to their at-rest form through a copy of it
        self._source = model if weight_dtype is not None else None
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
        self.restarts = 0
        self.weight_swaps = 0

    @property
    def params(self) -> dict:
        """The served weights in full precision, under the names of
        :class:`..models.transformer.CausalLM`'s ``state_dict`` (what a
        publication carries and :meth:`swap_params` takes)."""
        if self.weight_dtype is None:
            return self.model.state_dict()
        dq = quant.dequantize_weights(self.model)
        return {k: dq[k] for k in self._source.state_dict()}

    def _tensor(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _sample(self, hidden_last):
        return sample_tokens(self.model, hidden_last,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p, generator=self.generator)

    def _sample_report(self, model, hidden_last):
        """``(3, n)`` f64 on device: the sampled tokens, a 0/1 flag that
        each row's hidden state is finite, and the tokens'
        log-probabilities (one host copy reads all three)."""
        tok = sample_tokens(model, hidden_last, temperature=self.temperature,
                            top_k=self.top_k, top_p=self.top_p,
                            generator=self.generator)
        lp = chosen_logprob(model.logits_from(hidden_last), tok)
        ok = torch.isfinite(hidden_last).all(dim=-1)
        return torch.stack([tok.double(), ok.double(), lp.double()])

    def _decode(self, tick=None):
        """Run a staged tick (``tick``, the engine's own by default);
        returns host arrays ``(tokens, finite, logprob)``, a row a slot.
        The token is the tick's greedy argmax, or at ``temperature > 0`` a
        sample drawn eagerly from its logits (a graph captures no
        generator).  ``_last_logits`` keeps the tick's logits (valid until
        the next tick) for a measuring ``on_tick`` hook."""
        logits, picked = (tick or self._tick)(self)
        self._last_logits = logits
        if self.temperature > 0.0:
            tok = pick_tokens(self.model, logits.clone(),
                              temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p,
                              generator=self.generator)
            picked = torch.stack([tok.double(), picked[1],
                                  chosen_logprob(logits, tok).double()])
        out = picked.cpu().numpy()            # host fetch = device barrier
        return out[0].astype(np.int64), out[1] > 0, out[2]

    def _swappable(self, new_params) -> dict:
        """``new_params`` (a full-precision ``state_dict``) in the served
        form, checked against the live weights: quantized first under
        ``weight_dtype``, so the check compares like with like."""
        _check_swappable(self.params, new_params)
        if self.weight_dtype is None:
            return new_params
        fp = copy.deepcopy(self._source)
        _copy_into(fp, new_params)
        return quant.quantize_weights(fp, self.weight_dtype).to(
            self.device).state_dict()

    def swap_params(self, new_params) -> None:
        """Hot weight swap between ticks: geometry-checked weights are
        copied into the live ones in place (a captured tick reads the
        same addresses), so nothing is captured again."""
        _copy_into(self.model, self._swappable(new_params))
        self.weight_swaps += 1


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
    def _prefill(self, prompt, slot: int):
        """The whole prompt in one cached call into a fresh row, written
        over slot ``slot``; returns the token sampled at its last
        position, whether that hidden state is finite and the token's
        log-probability."""
        toks = self._tensor(prompt, torch.long)[None]
        fresh = self.model.init_cache(1, self.max_len)
        hidden = self.model.cached_forward(toks, fresh)
        slot_cache.write_slot(self.slots, fresh, slot)
        tok, ok, lp = self._sample_report(self.model,
                                          hidden[:, -1])[:, 0].tolist()
        return int(tok), bool(ok), lp

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
        """Warm restart after a contained fault: the slot table zeroed in
        place (any poisoned KV dies here) under the same captured tick,
        so ``decode_captures`` stays where it was."""
        for layer in self.slots["layers"]:
            for t in layer.values():
                t.zero_()
        self.slots["index"][:] = 0
        self.restarts += 1

    def run(self, requests: Iterable[Request], telemetry=None,
            on_tick: Optional[Callable] = None, admission=None) -> dict:
        """Serve a whole trace; returns ``{"results", "errors", "stats"}``
        (uid -> generated tokens; uid -> why a request was rejected at
        submit or shed; throughput, occupancy, ``decode_captures`` and the
        ``latency`` percentiles).  ``on_tick`` receives a
        :class:`TickReport` after every tick's compute, before its tokens
        are recorded; ``admission`` is asked before each placement."""
        if telemetry is not None:
            raise _unported("serving telemetry", "queue 1 item 14")
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
        live = LiveSignals()
        last_tok_wall: dict[int, float] = {}  # uid -> last emit wall

        def retire(req, now):
            h_e2e.observe(now - sched.arrival_wall.get(req.uid, now))
            n_tok = len(sched.finished[req.uid])
            fw = first_wall.pop(req.uid, None)
            if fw is not None and n_tok > 1:
                h_itl.observe((now - fw) / (n_tok - 1))
            last_tok_wall.pop(req.uid, None)

        t_start = time.perf_counter()
        t_prefill = t_decode = 0.0
        tick = prefill_calls = decode_ticks = occupancy_sum = nonfinite = 0
        while sched.pending or sched.occupancy:
            sched.mark_arrivals(tick, time.perf_counter())
            # admit every arrived request a free slot can take; a row
            # retired below frees its slot for the very next tick's admit
            while True:
                head_req = sched.peek(tick)
                if head_req is None:
                    break
                if admission is not None:
                    reason = admission.should_shed(
                        head_req, sched.queue_depth(tick))
                    if reason is not None:
                        shed_req = sched.drop_head(tick)
                        errors[shed_req.uid] = f"shed: {reason}"
                        continue
                placed = sched.place(tick)
                if placed is None:
                    break
                idx, req = placed
                t0 = time.perf_counter()
                first, ok, lp = self._prefill(req.prompt, idx)
                now = time.perf_counter()
                t_prefill += now - t0
                prefill_calls += 1
                first_wall[req.uid] = now
                ttft = now - sched.arrival_wall.get(req.uid, t0)
                h_ttft.observe(ttft)
                live.observe_ttft(ttft, now)
                last_tok_wall[req.uid] = now
                if on_tick is not None:
                    on_tick(TickReport(
                        tick=tick, kind="prefill", elapsed_s=now - t0,
                        emitted=[(req.uid, first)], finite={req.uid: ok},
                        logprob={req.uid: lp}, slots=[idx], engine=self,
                        queue_depth=sched.queue_depth(tick)))
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
            out, finite, lp = self._decode()
            now = time.perf_counter()
            t_decode += now - t0
            decode_ticks += 1
            live.sample(sched.queue_depth(tick), sched.occupancy, now)
            if admission is not None:
                admission.observe(live, sched.queue_depth(tick), now)
                admission.apply(self)
            act = sched.active_slots
            if on_tick is not None:
                uids = [sched.slots[i].request.uid for i in act]
                on_tick(TickReport(
                    tick=tick, kind="decode", elapsed_s=now - t0,
                    emitted=[(u, int(out[i])) for u, i in zip(uids, act)],
                    finite={u: bool(finite[i]) for u, i in zip(uids, act)},
                    logprob={u: float(lp[i]) for u, i in zip(uids, act)},
                    slots=list(act), engine=self,
                    queue_depth=sched.queue_depth(tick)))
            self.slots["index"] += 1      # every slot advances, as in flax
            for idx in act:
                r = sched.slots[idx].request
                lt = last_tok_wall.get(r.uid)
                if lt is not None:
                    live.observe_itl(now - lt, now)
                last_tok_wall[r.uid] = now
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
            "restarts": self.restarts,
            "weight_swaps": self.weight_swaps,
            "latency": _latency(h_ttft, h_itl, h_e2e),
            "window": live.signals(),
        }
        return {"results": sched.finished, "errors": errors, "stats": stats}


@dataclasses.dataclass
class _SpillRecord:
    """A preempted request parked off its slot: its scheduler identity
    plus the slot image needed to resume bit-exactly — the token stream,
    commit watermark, pending (emitted, unfed) token, and the whole-slot
    KV copy in the pools' at-rest form (a list of tensors, each layer's
    key, value (int8 payload and scales) and validity).  Draft pools are
    not captured: a resumed request restarts speculation cold, which
    only costs acceptance (verification stays exact)."""

    request: Request
    generated: list
    stream: list
    committed: int
    pendtok: int
    kv: list                         # pinned host tensors, or tensors on
                                     #   the card under migrate="device"
    seq: int                         # spill order, FIFO tiebreak
    digest: Optional[bytes] = None   # end-to-end integrity (device path)


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
    draft's pools inherit ``kv_dtype``.

    ``preempt=True`` turns on priority preemption (a higher-priority
    arrival spills the lowest-priority decoding slot and resumes it
    later); ``migrate`` picks where the spilled slot parks: ``"host"``
    (pinned host memory, and an npz audit file under ``spill_dir``) or
    ``"device"`` (a tensor on the card, its blake2b digest checked on
    resume)."""

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
                 preempt: bool = False, spill_dir: Optional[str] = None,
                 migrate: str = "host", decode_attention: str = "kernel"):
        if spill_dir is not None and not preempt:
            raise ValueError("spill_dir requires preempt=True (it is the "
                             "preemption spill audit directory)")
        if migrate not in ("host", "device"):
            raise ValueError(f"migrate must be 'host' or 'device', got "
                             f"{migrate!r}")
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
        self._preempt = bool(preempt)
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.migrate_kind = migrate
        #: fault-injection seam: callable payload -> payload applied to a
        #: device-path spill after its digest (the ``migrate_drop`` chaos
        #: kind); the resume-side digest check turns any corruption into
        #: a MigrationError the supervisor replays
        self._migrate_chaos = None
        self._spill_moves = 0
        self._spill_move_bytes = 0
        self._spill_move_seconds = 0.0
        self._spec_enabled = draft_layers is not None
        self._base_chunks_per_tick = self.chunks_per_tick
        self._canary: Optional[_CanaryState] = None
        # the canary's weight copy and its own captured tick, made at the
        # first canary and kept (each later candidate is copied in)
        self._canary_model = None
        self._canary_tick = None

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
        when speculating); returns ``(3,)`` f64 on device: the token
        sampled at ``logit_idx``, whether that hidden state is finite and
        the token's log-probability (meaningful on the final chunk)."""
        toks = self._tensor(tokens, torch.long)[None]
        table = self._tensor(table, torch.long)
        wb, wo = self._tensor(wb, torch.long), self._tensor(wo, torch.long)
        hidden = self._prefill_chunk(self.model, self.pools, toks, table,
                                     pos, wb, wo)
        if self.draft is not None:
            self._prefill_chunk(self.draft, self.draft_pools, toks, table,
                                pos, wb, wo)
        return self._sample_report(
            self.model, hidden[0, logit_idx:logit_idx + 1])[:, 0]

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
    def _decode_body(self, staged, model=None):
        """One token for every slot under ``model`` (the live weights by
        default).  Each layer writes its new K/V first, then attends off
        the pools."""
        model = self.model if model is None else model
        bps = self.blocks_per_slot
        tables = staged[:, :bps].to(torch.int32).contiguous()
        pos, toks = staged[:, bps], staged[:, bps + 1:bps + 2]
        attend = self._paged_attend(
            model, self.pools, tables, (pos + 1).to(torch.int32),
            staged[:, bps + 2], staged[:, bps + 3],
            model.token_valid(toks)[:, 0])
        hidden = model.run(toks, pos[:, None], attend)
        return head(model, hidden[:, 0])

    def _canary_body(self, staged):
        """The canary's tick: :meth:`_decode_body` under the candidate
        weight copy, over the same pools."""
        return self._decode_body(staged, self._canary_model)

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
        3)`` f64: the proposals, the target's greedy token at each of the
        ``spec_k + 1`` positions, a 0/1 flag that the slot's hidden states
        are finite and the log-probability of the first greedy token."""
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
        flat = pick_tokens(model, logits)
        greedy = flat.view(-1, T)
        lp0 = chosen_logprob(logits, flat).view(-1, T)[:, :1]
        finite = torch.isfinite(hidden).all(-1).all(-1)
        return torch.cat([self._props.double(), greedy.double(),
                          finite[:, None].double(), lp0.double()], 1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- resilience seams ---------------------------------------------------
    def reset(self) -> None:
        """Warm restart after a contained fault: the pools zeroed in
        place and a fresh block manager (so poisoned KV AND the prefix
        index that could resurrect it both die), under the same captured
        ticks — the graphs hold the pools' addresses, so
        ``decode_captures`` stays where it was."""
        self._canary = None
        self.manager = paged.BlockManager(self.num_blocks, self.block_size,
                                          self.max_slots,
                                          self.blocks_per_slot)
        for pools in (self.pools, self.draft_pools or []):
            for layer in pools:
                for t in layer.values():
                    _zero_(t)
        self.restarts += 1

    def swap_params(self, new_params) -> None:
        """Hot weight swap between ticks (see :meth:`_Engine.swap_params`;
        the draft shares the target's tensors, so it follows).  The
        prefix index is flushed: its KV was computed under the old
        weights, and matching it under the new ones would mix
        generations."""
        super().swap_params(new_params)
        self.manager.flush_index()

    def set_spec_enabled(self, enabled: bool) -> bool:
        """Toggle speculative decoding at runtime (admission control's
        first degradation step).  Returns the effective state; always
        False when the engine has no draft.  Greedy outputs are
        unaffected either way: disabling only changes the forward count,
        and re-enabling after a gap costs acceptance (the draft's cache
        has holes; verification stays exact)."""
        if self.draft_layers is None:
            return False
        self._spec_enabled = bool(enabled)
        return self._spec_enabled

    def begin_canary(self, new_params, slots: Iterable[int],
                     observe: Optional[Callable] = None) -> None:
        """Route ``slots`` to candidate weights while everyone else
        stays on the stable ones: the candidate is copied into the
        canary's weight copy, whose own captured tick runs after the
        live one every tick (:meth:`_canary_decode`), so neither
        generation's cache sees the other's."""
        if self._canary is not None:
            raise RuntimeError("a canary is already active")
        if self.draft_layers is not None:
            raise RuntimeError(
                "canary mode requires a non-speculative engine (the "
                "draft's shared cache cannot serve two weight sets)")
        served = self._swappable(new_params)
        sl = frozenset(int(x) for x in slots)
        if not sl or not all(0 <= x < self.max_slots for x in sl):
            raise ValueError(f"canary slots {sorted(sl)} must be a "
                             f"non-empty subset of 0..{self.max_slots - 1}")
        if len(sl) >= self.max_slots:
            raise ValueError("canary cannot take every slot (no stable "
                             "traffic left to compare against)")
        if self._canary_model is None:
            self._canary_model = copy.deepcopy(self.model)
            self._canary_tick = DecodeTick(
                PagedEngine._canary_body, self._tick.host.shape,
                self.device, counters=(paged_flash_decode,))
        _copy_into(self._canary_model, served)
        self._canary = _CanaryState(params=new_params, slots=sl,
                                    observe=observe)

    def end_canary(self, promote: bool) -> dict:
        """Finish the canary: promote copies the candidate into the live
        weights for ALL slots (prefix index flushed); rollback just drops
        it.  Either way returns the engine-side comparison summary."""
        if self._canary is None:
            raise RuntimeError("no canary is active")
        can, self._canary = self._canary, None
        if promote:
            _copy_into(self.model, self._canary_model.state_dict())
            self.manager.flush_index()
            self.weight_swaps += 1
        return can.summary()

    def _canary_decode(self, dec):
        """One decode tick under an active canary: the live tick, then
        the canary's tick with every other slot's KV write trashed, both
        staged from the live tick's host rows.  Each tick attends over
        the K/V it has just written (the decode reads its own position
        off the pools), so the live tick writes every slot and the
        canary's tick then overwrites its slots' new position with the
        candidate's K/V: each generation's cache stays self-consistent,
        as under JAX's cross-routed writes.  Tokens merge per slot;
        canary slots contribute agreement and drift samples."""
        can, bps = self._canary, self.blocks_per_slot
        new = self._canary_tick.host
        new[:] = self._tick.host
        for i in range(self.max_slots):
            if i not in can.slots:
                new[i, bps + 2] = paged.TRASH
        out_o, ok_o, lp_o = self._decode()
        out_n, ok_n, lp_n = self._decode(self._canary_tick)
        now = time.perf_counter()
        out, ok, lp = out_o.copy(), ok_o.copy(), lp_o.copy()
        for i in can.slots:
            out[i], ok[i], lp[i] = out_n[i], ok_n[i], lp_n[i]
        for i in dec:
            if i in can.slots:
                drift = abs(float(lp_n[i]) - float(lp_o[i]))
                can.note(agree=int(out_o[i]) == int(out_n[i]),
                         drift=drift if np.isfinite(drift) else np.inf,
                         finite=bool(ok_n[i]), now=now)
        return out, ok, lp

    # --- preemption spill ---------------------------------------------------
    def _pool_leaves(self, layer):
        for name in ("cached_key", "cached_value", paged.VALID_LEAF):
            t = layer[name]
            yield from ((t.q, t.s) if quant.is_quant(t) else (t,))

    def _slot_image(self, table, committed: int) -> list:
        """The blocks of one slot's logical cache that hold its
        ``committed`` positions, in their at-rest form (no dequant: an
        int8 pool spills payload and scales, so the round trip is
        bit-exact), a tensor per pool leaf of every layer, each ``(n,
        block_size, ...)``.  (JAX spills the whole slot, its compiled
        gather's one shape.)"""
        n = -(-committed // self.block_size)
        idx = self._tensor(table[:n], torch.long)
        return [leaf[idx] for layer in self.pools
                for leaf in self._pool_leaves(layer)]

    @torch.no_grad()
    def _restore_image(self, kv: list, committed: int, table) -> None:
        """Write a spilled slot image back: positions ``< committed`` land
        in the resumed slot's blocks, the rest of the image's last block
        goes to trash."""
        pidx = np.arange(kv[0].shape[0] * self.block_size)
        blocks = self._tensor(np.where(pidx < committed,
                                       table[pidx // self.block_size],
                                       paged.TRASH), torch.long)
        offsets = self._tensor(pidx % self.block_size, torch.long)
        leaves = iter(kv)
        for layer in self.pools:
            for pool in self._pool_leaves(layer):
                img = next(leaves).to(self.device)
                pool[blocks, offsets] = img.reshape(
                    (-1,) + tuple(img.shape[2:]))

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

    def run(self, requests: Iterable[Request], telemetry=None,
            keep_timeline: bool = False, on_tick: Optional[Callable] = None,
            admission=None) -> dict:
        """Serve a trace; returns ``{"results", "errors", "stats"}`` (plus
        ``"timeline"`` under ``keep_timeline``: one dict a tick with the
        uids ``placed``, ``chunks``, ``decoded``, ``shed``, ``preempted``
        and ``resumed``).

        ``results`` maps uid -> generated token array; ``errors`` maps the
        uid of each request rejected at submit (or shed by ``admission``)
        to its reason; ``stats`` carries throughput, occupancy, the
        ``paged`` block-pool record, ``slo`` attainment, ``latency``
        percentiles (TTFT anchors at the wall time a request's arrival
        tick is first reached, so queue wait counts), ``decode_captures``
        and ``paged_decode_launches``, the kernel launches of this run
        (the draft's and the canary's too), ``spec``, and ``preempt``
        (preemptions, resumes, the spill path and its moves).

        ``on_tick`` receives a :class:`TickReport` after every tick's
        compute but BEFORE its tokens are recorded — a raising hook
        discards the tick.  ``admission``
        (:class:`.admission.AdmissionController`) is consulted before
        each placement; shed requests land in ``errors`` as ``"shed:
        ..."``."""
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
        # per-slot host state: the token stream (prompt + emitted), how
        # many positions hold committed KV, remaining chunk plans, and the
        # pending token (emitted, not yet fed)
        stream: dict[int, list] = {}
        committed: dict[int, int] = {}
        plans: dict[int, list] = {}
        pendtok: dict[int, int] = {}
        first_wall: dict[int, float] = {}
        ttft_s: dict[int, float] = {}
        e2e_s: dict[int, float] = {}
        timeline = [] if keep_timeline else None
        live = LiveSignals()
        last_tok_wall: dict[int, float] = {}
        shared_tokens = prompt_tokens = chunk_calls = 0
        decode_ticks = occupancy_sum = nonfinite = 0
        spec_rounds = proposed_total = accepted_total = 0
        t_prefill = t_decode = 0.0
        launches0 = paged_flash_decode.launches
        tick = 0

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
            last_tok_wall.pop(req.uid, None)

        def emit(idx, token, now):
            """Record one token; True when the slot retired."""
            uid = sched.slots[idx].request.uid
            lt = last_tok_wall.get(uid)
            if lt is not None:
                live.observe_itl(now - lt, now)
            last_tok_wall[uid] = now
            done = sched.record(idx, token, self.eos_id)
            if done is not None:
                retire(done, idx, now)
            return done is not None

        def run_chunk(idx, ev):
            nonlocal chunk_calls, t_prefill
            req = sched.slots[idx].request
            plan = plans[idx].pop(0)
            toks = chunk_tokens(stream[idx], plan, self.chunk, self.pad_fill)
            self._make_writable(idx, committed[idx], plan.commit_to - 1)
            wb, wo, _ = write_targets(plan.feed_start, self.chunk,
                                      committed[idx], len(req.prompt),
                                      mgr.tables[idx], bs)
            t0 = time.perf_counter()
            rep = self._chunk(toks, mgr.tables[idx], plan.feed_start,
                              max(plan.logit_index, 0), wb, wo)
            committed[idx] = plan.commit_to
            mgr.register_committed(idx, stream[idx], committed[idx])
            chunk_calls += 1
            if ev is not None:
                ev["chunks"].append(req.uid)
            sched.note_chunk(idx)
            if plan.is_last:
                tok, ok, lp = rep.tolist()  # host fetch = device barrier
                first = int(tok)
                now = time.perf_counter()
                t_prefill += now - t0
                pendtok[idx] = first
                first_wall[req.uid] = now
                ttft_s[req.uid] = now - sched.arrival_wall.get(req.uid, now)
                h_ttft.observe(ttft_s[req.uid])
                live.observe_ttft(ttft_s[req.uid], now)
                if on_tick is not None:
                    on_tick(TickReport(
                        tick=tick, kind="prefill", elapsed_s=now - t0,
                        emitted=[(req.uid, first)],
                        finite={req.uid: bool(ok)},
                        logprob={req.uid: float(lp)}, slots=[idx],
                        engine=self, queue_depth=sched.queue_depth(tick)))
                stream[idx].append(first)
                emit(idx, first, now)
            else:
                self._sync()
                t_prefill += time.perf_counter() - t0

        # --- priority preemption (opt-in): spilled-slot parking lot ------
        spilled: list[_SpillRecord] = []
        preempt_count = resume_count = spill_seq = 0

        def preempt_one(head_req, ev):
            """Spill ONE victim slot to make room for ``head_req``: the
            lowest-priority decoding slot strictly below it (priority 0 is
            never preempted: nothing outranks it), most-progressed first
            so the evicted work is the cheapest to finish later.  False
            when no eligible victim exists."""
            nonlocal preempt_count, spill_seq
            cands = [i for i in sched.decoding_slots()
                     if sched.slots[i].request.priority > head_req.priority]
            if not cands:
                return False
            victim = sorted(
                cands,
                key=lambda i: (-sched.slots[i].request.priority,
                               len(sched.slots[i].generated), i))[0]
            t0 = time.perf_counter()
            image = self._slot_image(mgr.tables[victim], committed[victim])
            if self.migrate_kind == "device":
                # park the at-rest image in a tensor on the card, its
                # digest taken first (the audit the resume rechecks)
                digest = migrate_mod.tree_digest(image)
                payload = image
                if self._migrate_chaos is not None:
                    payload = self._migrate_chaos(payload)
                kv = migrate_mod.offload(payload, self.device)
                self._spill_moves += 1
                self._spill_move_bytes += migrate_mod.tree_bytes(image)
                self._spill_move_seconds += time.perf_counter() - t0
            else:
                kv = [migrate_mod.to_host(t) for t in image]  # = barrier
                digest = None
            req, gen = sched.preempt(victim)
            mgr.release(victim)
            rec = _SpillRecord(request=req, generated=gen,
                               stream=stream.pop(victim),
                               committed=committed.pop(victim),
                               pendtok=pendtok.pop(victim),
                               kv=kv, seq=spill_seq, digest=digest)
            plans.pop(victim, None)
            spill_seq += 1
            spilled.append(rec)
            preempt_count += 1
            if self.spill_dir is not None:
                np.savez(os.path.join(
                    self.spill_dir, f"spill-{req.uid}-{rec.seq}.npz"),
                    **{f"leaf_{i:05d}": migrate_mod.host_array(leaf)
                       for i, leaf in enumerate(kv)})
            if ev is not None:
                ev["preempted"].append(req.uid)
            return True

        def resume_one(ev):
            """Un-park the best spilled request (highest priority, then
            FIFO) into a free slot: a fresh block budget, the committed KV
            image scattered back, the host stream state restored.  Every
            committed position returns in its at-rest form, so the resumed
            continuation is the uncontended one.  False when no slot or
            budget is available."""
            nonlocal resume_count
            if not spilled or sched.occupancy >= self.max_slots:
                return False
            rec = min(spilled, key=lambda r: (r.request.priority, r.seq))
            need = self._capacity_len(rec.request)
            sp0 = paged.SharedPrefix([], None, 0, b"")
            if not mgr.can_admit(sp0, need):
                return False
            idx = sched.restore(rec.request, rec.generated)
            if idx is None:
                return False
            mgr.admit(idx, sp0, need)
            kv_in = rec.kv
            if self.migrate_kind == "device":
                # verify the round trip end to end: a transfer lost or
                # corrupted surfaces here, before anything is scattered
                t0 = time.perf_counter()
                kv_in = migrate_mod.offload(rec.kv, self.device)
                if rec.digest is not None and \
                        migrate_mod.tree_digest(kv_in) != rec.digest:
                    raise migrate_mod.MigrationError(
                        f"device spill/resume of request "
                        f"{rec.request.uid} failed its digest check — KV "
                        f"transfer lost or corrupted; replay from the "
                        f"ledger")
                self._spill_moves += 1
                self._spill_move_bytes += migrate_mod.tree_bytes(kv_in)
                self._spill_move_seconds += time.perf_counter() - t0
            self._restore_image(kv_in, rec.committed, mgr.tables[idx])
            stream[idx] = rec.stream
            committed[idx] = rec.committed
            pendtok[idx] = rec.pendtok
            plans.pop(idx, None)
            mgr.register_committed(idx, stream[idx], committed[idx])
            spilled.remove(rec)
            resume_count += 1
            if ev is not None:
                ev["resumed"].append(rec.request.uid)
            return True

        def report(dec, out, ok, lp, elapsed):
            if on_tick is None:
                return
            on_tick(TickReport(
                tick=tick, kind="decode", elapsed_s=elapsed,
                emitted=[(sched.slots[i].request.uid, int(t))
                         for i in dec for t in out[i]],
                finite={sched.slots[i].request.uid: bool(ok[i])
                        for i in dec},
                logprob={sched.slots[i].request.uid: float(lp[i])
                         for i in dec},
                slots=list(dec), engine=self,
                queue_depth=sched.queue_depth(tick)))

        t_start = time.perf_counter()
        while sched.pending or sched.occupancy or spilled:
            sched.mark_arrivals(tick, time.perf_counter())
            ev = ({"tick": tick, "placed": [], "chunks": [], "decoded": [],
                   "shed": [], "preempted": [], "resumed": []}
                  if keep_timeline else None)
            # admission: FIFO while a slot AND its whole block budget are
            # available (no partial admission, no pool deadlock); an
            # admission controller may shed the head first, and under
            # preemption a parked or arriving request of higher priority
            # may take a lower one's slot
            while True:
                can_place = sched.occupancy < self.max_slots
                if not can_place and not self._preempt:
                    break              # a full house just waits
                head_req = sched.peek(tick)
                # resume politeness: a parked request was admitted once
                # already — it outranks any queue head of equal or lower
                # priority for the next free slot
                if self._preempt and spilled and can_place:
                    best = min(spilled,
                               key=lambda r: (r.request.priority, r.seq))
                    if head_req is None or \
                            best.request.priority <= head_req.priority:
                        if resume_one(ev):
                            continue
                if head_req is None:
                    break
                if admission is not None:
                    reason = admission.should_shed(
                        head_req, sched.queue_depth(tick))
                    if reason is not None:
                        shed_req = sched.drop_head(tick)
                        errors[shed_req.uid] = f"shed: {reason}"
                        if ev is not None:
                            ev["shed"].append(shed_req.uid)
                        continue
                if not can_place:
                    # slot pressure: evict a strictly-lower-priority
                    # victim so the head can take its slot
                    if not preempt_one(head_req, ev):
                        break
                    continue
                sp = mgr.match_prefix(head_req.prompt)
                need_ok = mgr.can_admit(sp, self._capacity_len(head_req))
                while not need_ok and self._preempt:
                    # make room by spilling strictly-lower-priority slots;
                    # re-match after every eviction (releasing a victim can
                    # change the shareable prefix)
                    if not preempt_one(head_req, ev):
                        break
                    sp = mgr.match_prefix(head_req.prompt)
                    need_ok = mgr.can_admit(sp,
                                            self._capacity_len(head_req))
                if not need_ok:
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
                if ev is not None:
                    ev["placed"].append(req.uid)

            if not sched.occupancy:
                nxt = sched.next_arrival()
                if nxt is None:
                    if spilled:
                        continue       # parked work only: resume next pass
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
                    run_chunk(idx, ev)
                    budget -= 1

            # decode every tick: live streams advance regardless of how
            # much prefill work is queued — the stall bound
            dec = sched.decoding_slots()
            if dec and self.draft is not None and self._spec_enabled:
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
                # acceptance decided BEFORE any state mutates, so the
                # tick report (and a hook that rejects it) sees exactly
                # what would be committed
                acc = {i: greedy_accept(res[i, :k].astype(np.int64),
                                        res[i, k:k + T].astype(np.int64))
                       for i in dec}
                report(dec, {i: acc[i][1] for i in dec},
                       {i: res[i, -2] > 0 for i in dec}, res[:, -1],
                       now - t0)
                for i in dec:
                    a, emitted = acc[i]
                    nonfinite += int(not res[i, -2] > 0)
                    proposed_total += k
                    accepted_total += a
                    committed[i] += a + 1
                    if ev is not None:
                        ev["decoded"].append(sched.slots[i].request.uid)
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
                if self._canary is not None:
                    out, finite, lp = self._canary_decode(dec)
                else:
                    out, finite, lp = self._decode()
                now = time.perf_counter()
                t_decode += now - t0
                decode_ticks += 1
                report(dec, {i: [out[i]] for i in dec}, finite, lp,
                       now - t0)
                for i in dec:
                    tok = int(out[i])
                    nonfinite += int(not finite[i])
                    committed[i] += 1
                    stream[i].append(tok)
                    mgr.register_committed(i, stream[i], committed[i])
                    pendtok[i] = tok
                    if ev is not None:
                        ev["decoded"].append(sched.slots[i].request.uid)
                    emit(i, tok, now)
            noww = time.perf_counter()
            live.sample(sched.queue_depth(tick), sched.occupancy, noww)
            if admission is not None:
                admission.observe(live, sched.queue_depth(tick), noww)
                admission.apply(self)
            if ev is not None:
                timeline.append(ev)
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
            "canary_captures":
                self._canary_tick.captures if self._canary_tick else 0,
            "draft_captures":
                self._draft_tick.captures if speculating else 0,
            "verify_captures":
                self._verify_tick.captures if speculating else 0,
            "restarts": self.restarts,
            "weight_swaps": self.weight_swaps,
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
                "active_at_end": self._spec_enabled,
                "k": self.spec_k if speculating else 0,
                "draft_layers": self.draft_layers,
                "rounds": spec_rounds,
                "proposed": proposed_total,
                "accepted": accepted_total,
                "acceptance_rate": accepted_total / proposed_total
                if proposed_total else None,
            },
            "preempt": {
                "enabled": self._preempt,
                "preemptions": preempt_count,
                "resumes": resume_count,
                "still_spilled": len(spilled),
                "spill_path": self.migrate_kind,
                # engine-lifetime device-path accounting (0 under "host")
                "migration_moves": self._spill_moves,
                "migration_bytes": self._spill_move_bytes,
                "migration_seconds": round(self._spill_move_seconds, 6),
            },
            "slo": slo_report(accepted, ttft_s, e2e_s),
            "latency": _latency(h_ttft, h_itl, h_e2e),
            "window": live.signals(),
        }
        out = {"results": sched.finished, "errors": errors, "stats": stats}
        if keep_timeline:
            out["timeline"] = timeline
        return out
