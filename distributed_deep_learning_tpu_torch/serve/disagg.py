"""Disaggregated prefill/decode serving: the port of
``distributed_deep_learning_tpu/serve/disagg.py``.

A unified :class:`.engine.PagedEngine` runs the compute-bound prefill and
the latency-bound decode on the same device: every prompt chunk stalls
the decode streams beside it.  Disaggregation gives each phase its own
worker pool and joins them with the KV-block migration of
:mod:`.migrate`:

* **Prefill workers** run chunked prefill over ``prefill_streams``
  prompts at once in ONE batched chunk forward (JAX vmaps its unified
  chunk program; the port runs the unified engine's own
  :meth:`.engine.PagedEngine._prefill_chunk` over the rows).  Rows the
  scheduler leaves empty compute on padding and write to
  :data:`.paged.TRASH`.  Each worker owns a :class:`.paged.BlockManager`
  with prefix reuse and copy-on-write, so a shared system prompt is
  computed once a worker.
* **Decode workers** are slot-bound :class:`.engine.PagedEngine` s and
  run the unified engine's own captured decode tick through the paged
  decode kernel (:func:`..ops.paged_decode.paged_flash_decode`).
  Migrated blocks arrive with refcount 1 and are never prefix-indexed
  on the decode side, so decode never copies on write.  Decode pools
  are exact-fit.
* **Migration** hands a finished prompt's committed blocks to the
  least-loaded decode worker as one packed transfer
  (:class:`.migrate.BlockMigrator`, the moved blocks only).  The gather
  copies the blocks before the prefill stream's blocks are released.

``devices`` is a list of ``torch.device``, default the visible CUDA
devices; it may repeat a device (both pools on one card, or two CPU
"devices" in the tests).  JAX's refusal of fewer than two devices
stands, so one card must be passed twice explicitly.

``run()`` honours the engines' ``{"results", "errors", "stats"}``
contract with ``stats["engine"] == "disagg"`` and a migration record.
The decode ticks' kernel launches are ``stats["paged_decode_launches"]``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.models.transformer import CausalLM
from distributed_deep_learning_tpu_torch.obs.metrics import MetricsRegistry
from distributed_deep_learning_tpu_torch.obs.window import LiveSignals
from distributed_deep_learning_tpu_torch.ops.paged_decode import \
    paged_flash_decode
from distributed_deep_learning_tpu_torch.serve import migrate as migrate_mod
from distributed_deep_learning_tpu_torch.serve import paged
from distributed_deep_learning_tpu_torch.serve.engine import (PagedEngine,
                                                              TickReport)
from distributed_deep_learning_tpu_torch.serve.load import slo_report
from distributed_deep_learning_tpu_torch.serve.prefill import (
    chunk_tokens, plan_chunks, write_targets)
from distributed_deep_learning_tpu_torch.serve.scheduler import Request


@dataclasses.dataclass
class _Stream:
    """One in-flight prefill on a prefill worker."""

    req: Request
    plans: list
    stream: list          # prompt tokens (host ints)
    committed: int
    shared: int


@dataclasses.dataclass
class _Slot:
    """One decoding request on a decode worker."""

    req: Request
    stream: list          # prompt + generated
    committed: int
    pendtok: int
    generated: list


@dataclasses.dataclass
class _Ready:
    """A finished prefill awaiting migration to a decode worker."""

    worker: int
    si: int
    req: Request
    stream: list
    L: int
    pendtok: int


class _Worker:
    """A device-pinned :class:`PagedEngine` used for its pools, manager
    and decode tick, never for its ``run()`` loop."""

    def __init__(self, wid: int, eng: PagedEngine, device):
        self.wid = wid
        self.eng = eng
        self.device = device
        self.streams: dict[int, _Stream] = {}   # prefill role
        self.slots: dict[int, _Slot] = {}       # decode role


class DisaggEngine:
    """Prefill/decode-disaggregated serving over >= 2 devices.

    ``prefill_workers`` + ``decode_workers`` devices are taken from
    ``devices`` in order: prefill pools first, then decode.  Every worker
    shares one model geometry and the same at-rest KV representation
    (``kv_dtype``), so migration round trips are exact.  ``wire`` selects
    the migration wire (``"at_rest"`` exact, ``"int8"`` re-quantized).
    ``model`` holds the weights; a worker on another device than the
    model's gets its own copy."""

    def __init__(self, model: CausalLM, *,
                 prefill_workers: int = 1, decode_workers: int = 1,
                 prefill_streams: int = 4, max_slots: int = 8,
                 max_len: Optional[int] = None, kv_block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None, wire: str = "at_rest",
                 decode_passes: int = 2, devices=None, telemetry=None):
        if prefill_workers < 1 or decode_workers < 1:
            raise ValueError(f"need >= 1 worker of each kind, got "
                             f"prefill={prefill_workers} "
                             f"decode={decode_workers}")
        if prefill_streams < 1:
            raise ValueError(f"prefill_streams must be >= 1, got "
                             f"{prefill_streams}")
        if decode_passes < 1:
            raise ValueError(f"decode_passes must be >= 1, got "
                             f"{decode_passes}")
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        need = prefill_workers + decode_workers
        if len(devices) < 2:
            raise ValueError(
                "disaggregated serving needs >= 2 local devices (one "
                "per pool); only 1 is visible — run under a "
                "multi-device mesh or use the unified PagedEngine")
        if need > len(devices):
            raise ValueError(
                f"{prefill_workers} prefill + {decode_workers} decode "
                f"workers need {need} devices; only {len(devices)} "
                f"visible")
        if wire == "int8" and kv_dtype == "int8":
            raise ValueError(
                "wire='int8' over int8+scales pools is a no-op with "
                "extra loss (the at-rest wire already moves int8); use "
                "wire='at_rest'")
        kw = dict(max_len=max_len, kv_block_size=kv_block_size,
                  prefill_chunk=prefill_chunk, eos_id=eos_id,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  generator=generator, kv_dtype=kv_dtype,
                  weight_dtype=weight_dtype)
        # kept for role elasticity: reassign() rebuilds a worker engine
        # with the other role's geometry on the same device
        self._engine_kw = dict(kw)
        self._model = model
        self._models: dict = {}
        self._num_blocks = num_blocks
        # prefill pools keep the 2x default (or the caller's override) so
        # the prefix index can retain shared blocks; decode pools are
        # exact-fit: decode never prefix-matches
        self.prefill = [
            _Worker(w, self._engine(devices[w], prefill_streams,
                                    num_blocks), devices[w])
            for w in range(prefill_workers)]
        bs = int(kv_block_size)
        plen = self.prefill[0].eng.padded_len
        self.decode = [
            _Worker(w, self._engine(devices[prefill_workers + w], max_slots,
                                    max_slots * (plen // bs)),
                    devices[prefill_workers + w])
            for w in range(decode_workers)]
        e0 = self.decode[0].eng
        self.model = model
        self.eos_id = eos_id
        self.temperature = temperature
        self.max_slots = int(max_slots)
        self.prefill_streams = int(prefill_streams)
        self.block_size = e0.block_size
        self.chunk = e0.chunk
        self.max_len = e0.max_len
        self.padded_len = e0.padded_len
        self.pad_fill = e0.pad_fill
        self.kv_dtype, self.weight_dtype = kv_dtype, weight_dtype
        self.wire = wire
        # a prefill call is prefill_streams prompts wide, so the decode
        # pool ticks decode_passes times an iteration to keep its cadence
        # near the unified engine's one chunk to one tick
        self.decode_passes = int(decode_passes)
        reg = telemetry.registry if telemetry is not None else None
        self.migrator = migrate_mod.BlockMigrator(
            e0.blocks_per_slot, wire=wire, registry=reg,
            tracer=getattr(telemetry, "tracer", None))
        self.kv_cache_bytes = sum(w.eng.kv_cache_bytes
                                  for w in self.prefill + self.decode)
        self.restarts = 0
        self.pool_reassignments = 0

    def _engine(self, device, max_slots: int, num_blocks) -> PagedEngine:
        """A worker engine on ``device``: the caller's model where it
        lives there, else one copy a device (engines move their model)."""
        model = self._model
        if next(model.parameters()).device != device:
            if device not in self._models:
                self._models[device] = copy.deepcopy(model).to(device)
            model = self._models[device]
        return PagedEngine(model, device=device, max_slots=max_slots,
                           num_blocks=num_blocks, **self._engine_kw)

    # --- the batched chunk --------------------------------------------------
    @torch.no_grad()
    def _batch_chunk(self, eng: PagedEngine, toks, tables, pos, logit_idx,
                     wb, wo):
        """One chunk for every row of a prefill worker (the engine's own
        chunk program, ``P`` rows wide; inactive rows write to TRASH).
        Returns ``(3, P)`` f64 on the device: each row's token sampled at
        ``logit_idx``, its finite flag and log-probability."""
        def t(x):
            return eng._tensor(x, torch.long)

        hidden = eng._prefill_chunk(eng.model, eng.pools, t(toks),
                                    t(tables), t(pos), t(wb), t(wo))
        rows = torch.arange(hidden.shape[0], device=eng.device)
        return eng._sample_report(eng.model, hidden[rows, t(logit_idx)])

    # --- host helpers -------------------------------------------------------
    def _validate(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds the serving "
                f"capacity max_len={self.max_len}")
        worst = -(-min(len(req.prompt) + req.max_new_tokens,
                       self.padded_len) // self.block_size)
        cap = min(min(w.eng.num_blocks for w in self.prefill),
                  min(w.eng.num_blocks for w in self.decode))
        if worst > cap:
            raise ValueError(
                f"request {req.uid}: needs up to {worst} KV blocks but "
                f"the smallest worker pool holds only {cap}")

    def _admit_prefill(self, req: Request, shared_out: list) -> bool:
        """Place a request on the least-loaded prefill worker that can
        hold it, reusing that worker's prefix index."""
        L = len(req.prompt)
        for pw in sorted(self.prefill,
                         key=lambda w: (len(w.streams), w.wid)):
            if len(pw.streams) >= self.prefill_streams:
                continue
            mgr = pw.eng.manager
            sp = mgr.match_prefix(req.prompt)
            if not mgr.can_admit(sp, L):
                continue
            si = min(i for i in range(self.prefill_streams)
                     if i not in pw.streams)
            shared = mgr.admit(si, sp, L)
            pw.streams[si] = _Stream(
                req=req, plans=plan_chunks(shared, L, self.chunk),
                stream=[int(t) for t in req.prompt],
                committed=shared, shared=shared)
            shared_out.append(shared)
            return True
        return False

    def _admit_decode(self, item: _Ready) -> bool:
        """Migrate a finished prefill's committed blocks to the
        least-loaded decode worker and free the prefill stream; False
        when no decode worker has a slot and the blocks (backpressure:
        the blocks stay parked on the prefill worker)."""
        bs = self.block_size
        sp0 = paged.SharedPrefix([], None, 0, b"")
        total = min(item.L + item.req.max_new_tokens, self.padded_len)
        pw = self.prefill[item.worker]
        for dw in sorted(self.decode,
                         key=lambda d: (len(d.slots), d.wid)):
            if len(dw.slots) >= dw.eng.max_slots:
                continue
            if not dw.eng.manager.can_admit(sp0, total):
                continue
            slot = min(i for i in range(dw.eng.max_slots)
                       if i not in dw.slots)
            dw.eng.manager.admit(slot, sp0, total)
            nb = -(-item.L // bs)
            src_ids = [int(b) for b in
                       pw.eng.manager.tables[item.si][:nb]]
            dst_ids = [int(b) for b in
                       dw.eng.manager.tables[slot][:nb]]
            dw.eng.pools = self.migrator.migrate(
                pw.eng.pools, dw.eng.pools, src_ids, dst_ids,
                device=dw.device, trace_id=item.req.trace_id)
            # the gather copied the blocks, so the stream's blocks can be
            # released now; the prefix index keeps the reusable ones
            pw.eng.manager.release(item.si)
            del pw.streams[item.si]
            dw.slots[slot] = _Slot(
                req=item.req, stream=list(item.stream),
                committed=item.L, pendtok=item.pendtok,
                generated=[item.pendtok])
            return True
        return False

    def reassign(self, direction: str) -> bool:
        """Move one IDLE worker's device between the prefill and decode
        pools (role elasticity on sustained ``prefill_util`` skew; the
        :class:`.autoscaler.PoolRebalancer` decides, this actuates).  The
        worker's engine is rebuilt with the new role's geometry on the
        same device.

        ``"to_prefill"`` takes an idle decode worker (no live slots);
        ``"to_decode"`` takes the newest idle prefill worker (only the
        tail is removable).  Keeps >= 1 worker a role; returns False when
        no worker is eligible."""
        if direction not in ("to_prefill", "to_decode"):
            raise ValueError(f"direction must be 'to_prefill' or "
                             f"'to_decode', got {direction!r}")
        bs = self.block_size
        plen = self.padded_len
        if direction == "to_prefill":
            if len(self.decode) < 2:
                return False
            victim = next((d for d in reversed(self.decode)
                           if not d.slots), None)
            if victim is None:
                return False
            self.decode.remove(victim)
            eng = self._engine(victim.device, self.prefill_streams,
                               self._num_blocks)
            self.prefill.append(_Worker(len(self.prefill), eng,
                                        victim.device))
        else:
            if len(self.prefill) < 2 or self.prefill[-1].streams:
                return False
            victim = self.prefill.pop()
            eng = self._engine(victim.device, self.max_slots,
                               self.max_slots * (plen // bs))
            self.decode.append(_Worker(len(self.decode), eng,
                                       victim.device))
        self.kv_cache_bytes = sum(x.eng.kv_cache_bytes
                                  for x in self.prefill + self.decode)
        self.pool_reassignments += 1
        return True

    def reset(self) -> None:
        """Warm restart: every worker's pools zeroed in place and a fresh
        manager, under the same captured decode ticks."""
        for w in self.prefill + self.decode:
            w.eng.reset()
            w.streams.clear()
            w.slots.clear()
        self.restarts += 1

    # --- main loop ----------------------------------------------------------
    def run(self, requests: Iterable[Request], telemetry=None,
            on_tick=None) -> dict:
        reg = telemetry.registry if telemetry is not None \
            else MetricsRegistry()
        h_ttft = reg.histogram("serve_ttft_seconds")
        h_itl = reg.histogram("serve_intertoken_seconds")
        h_e2e = reg.histogram("serve_e2e_seconds")
        h_tick = reg.histogram("serve_decode_tick_seconds")
        g_queue = reg.gauge("serve_queue_depth")
        g_occ = reg.gauge("serve_slot_occupancy")
        live = LiveSignals()

        errors: dict = {}
        finished: dict = {}
        queue: list[Request] = []
        for r in sorted(requests, key=lambda r: (r.arrival_tick, r.uid)):
            try:
                self._validate(r)
                queue.append(r)
            except ValueError as exc:
                errors[r.uid] = str(exc)
        ready: list[_Ready] = []
        accepted: list[Request] = []
        arrival_wall: dict[int, float] = {}
        first_wall: dict[int, float] = {}
        last_wall: dict[int, float] = {}
        ttft_s: dict[int, float] = {}
        e2e_s: dict[int, float] = {}
        shared_counts: list[int] = []
        prompt_tokens = sum(len(r.prompt) for r in queue)
        chunk_calls = chunk_rows = decode_ticks = 0
        occupancy_sum = 0
        t_prefill = t_decode = 0.0
        rejected = len(errors)
        bs = self.block_size
        launches0 = paged_flash_decode.launches

        def retire(uid, req, gen, now):
            finished[uid] = np.asarray(gen, dtype=req.prompt.dtype)
            arr = arrival_wall.get(uid, now)
            e2e_s[uid] = now - arr
            h_e2e.observe(e2e_s[uid])
            fw = first_wall.get(uid)
            if fw is not None and len(gen) > 1:
                h_itl.observe((now - fw) / (len(gen) - 1))

        def emit(uid, now):
            lt = last_wall.get(uid)
            if lt is not None:
                live.observe_itl(now - lt, now)
            last_wall[uid] = now

        def finish_prefill(pw, si, st, tok, now):
            """First token sampled: emit it; retire single-token or
            instant-EOS requests on the spot, park the rest for
            migration."""
            uid = st.req.uid
            ttft_s[uid] = now - arrival_wall.get(uid, now)
            h_ttft.observe(ttft_s[uid])
            live.observe_ttft(ttft_s[uid], now)
            first_wall[uid] = now
            emit(uid, now)
            done = st.req.max_new_tokens <= 1 or \
                (self.eos_id is not None and tok == self.eos_id)
            if done:
                retire(uid, st.req, [tok], now)
                pw.eng.manager.release(si)
                del pw.streams[si]
            else:
                ready.append(_Ready(worker=pw.wid, si=si, req=st.req,
                                    stream=st.stream + [tok],
                                    L=len(st.req.prompt), pendtok=tok))

        def drain_ready():
            moved = False
            while ready and self._admit_decode(ready[0]):
                ready.pop(0)
                moved = True
            return moved

        t_start = time.perf_counter()
        tick = 0
        while queue or ready or any(w.streams for w in self.prefill) \
                or any(d.slots for d in self.decode):
            now = time.perf_counter()
            qd = 0
            for r in queue:
                if r.arrival_tick > tick:
                    break
                arrival_wall.setdefault(r.uid, now)
                qd += 1
            g_queue.set(qd)
            # 1) migrate finished prefills (FIFO) while decode has room
            progressed = drain_ready()

            # 2) admit arrivals into prefill streams, decode-aware: a
            # prefill starts only when the decode pool will have a slot
            # for its handoff, so queue wait is paid before the first
            # token (TTFT) rather than after it (ITL)
            cap = sum(d.eng.max_slots for d in self.decode)
            in_system = len(ready) \
                + sum(len(w.streams) for w in self.prefill) \
                + sum(len(d.slots) for d in self.decode)
            while queue and queue[0].arrival_tick <= tick \
                    and in_system < cap:
                if not self._admit_prefill(queue[0], shared_counts):
                    break
                accepted.append(queue.pop(0))
                in_system += 1
                progressed = True

            # 3) one batched chunk a prefill worker with work; the host
            # waits only on workers that finished a prompt (their first
            # token is needed)
            for pw in self.prefill:
                active = []
                P = self.prefill_streams
                toks = np.full((P, self.chunk), self.pad_fill, np.int64)
                pos = np.zeros(P, np.int64)
                li = np.zeros(P, np.int64)
                wb = np.full((P, self.chunk), paged.TRASH, np.int64)
                wo = np.zeros((P, self.chunk), np.int64)
                mgr = pw.eng.manager
                for si, st in sorted(pw.streams.items()):
                    if not st.plans:
                        continue            # parked, awaiting migration
                    plan = st.plans.pop(0)
                    L = len(st.req.prompt)
                    pw.eng._make_writable(si, st.committed,
                                          plan.commit_to - 1)
                    toks[si] = chunk_tokens(st.stream, plan, self.chunk,
                                            self.pad_fill)
                    b_r, o_r, _ = write_targets(
                        plan.feed_start, self.chunk, st.committed, L,
                        mgr.tables[si], bs)
                    wb[si], wo[si] = b_r, o_r
                    pos[si] = plan.feed_start
                    li[si] = max(plan.logit_index, 0)
                    active.append((si, st, plan))
                if not active:
                    continue
                t0 = time.perf_counter()
                rep = self._batch_chunk(pw.eng, toks, np.asarray(
                    mgr.tables), pos, li, wb, wo)
                finals = [a for a in active if a[2].is_last]
                rep_h = rep.cpu().numpy() if finals else None  # = barrier
                now = time.perf_counter()
                t_prefill += now - t0
                chunk_calls += 1
                chunk_rows += len(active)
                progressed = True
                for si, st, plan in active:
                    st.committed = plan.commit_to
                    mgr.register_committed(si, st.stream, st.committed)
                if on_tick is not None:
                    on_tick(TickReport(
                        tick=tick, kind="prefill", elapsed_s=now - t0,
                        emitted=[(st.req.uid, int(rep_h[0, si]))
                                 for si, st, _ in finals],
                        finite={st.req.uid: bool(rep_h[1, si] > 0)
                                for si, st, _ in finals},
                        logprob={}, slots=[si for si, _, _ in active],
                        engine=self, queue_depth=qd))
                for si, st, plan in finals:
                    finish_prefill(pw, si, st, int(rep_h[0, si]), now)

            # 3b) hand fresh finishes to decode now: the request's second
            # token lands one tick sooner (ITL)
            progressed = drain_ready() or progressed

            # 4) decode ticks: the unified engine's own captured tick,
            # decode_passes times an iteration; finished prefills drain
            # into freed slots between passes
            for _pass in range(self.decode_passes):
                if _pass:
                    drain_ready()
                if not any(d.slots for d in self.decode):
                    break
                for dw in self.decode:
                    if not dw.slots:
                        continue
                    eng, mgr = dw.eng, dw.eng.manager
                    dec = sorted(dw.slots)
                    eng._stage_tick([(i, dw.slots[i].committed,
                                      dw.slots[i].pendtok) for i in dec])
                    t0 = time.perf_counter()
                    out, ok_h, lp_h = eng._decode()   # host fetch = barrier
                    # the tick's logits, for a measuring on_tick hook
                    self._last_logits = eng._last_logits
                    now = time.perf_counter()
                    t_decode += now - t0
                    h_tick.observe(now - t0)
                    decode_ticks += 1
                    occupancy_sum += len(dec)
                    progressed = True
                    if on_tick is not None:
                        on_tick(TickReport(
                            tick=tick, kind="decode", elapsed_s=now - t0,
                            emitted=[(dw.slots[i].req.uid, int(out[i]))
                                     for i in dec],
                            finite={dw.slots[i].req.uid: bool(ok_h[i])
                                    for i in dec},
                            logprob={dw.slots[i].req.uid: float(lp_h[i])
                                     for i in dec},
                            slots=dec, engine=self, queue_depth=qd))
                    for i in dec:
                        sl = dw.slots[i]
                        tok = int(out[i])
                        sl.committed += 1
                        sl.stream.append(tok)
                        sl.pendtok = tok
                        sl.generated.append(tok)
                        uid = sl.req.uid
                        emit(uid, now)
                        if len(sl.generated) >= sl.req.max_new_tokens or \
                                (self.eos_id is not None
                                 and tok == self.eos_id):
                            retire(uid, sl.req, sl.generated, now)
                            mgr.release(i)
                            del dw.slots[i]
            g_occ.set(sum(len(d.slots) for d in self.decode))
            live.sample(qd, sum(len(d.slots) for d in self.decode), now)

            in_flight = ready or any(w.streams for w in self.prefill) \
                or any(d.slots for d in self.decode)
            if not progressed and not in_flight:
                if queue and queue[0].arrival_tick > tick:
                    tick = queue[0].arrival_tick
                    continue
                if queue:       # arrived but unplaceable: fail loudly
                    r = queue.pop(0)
                    errors[r.uid] = ("disagg: admission stalled with "
                                     "idle workers (request larger "
                                     "than any worker pool?)")
                    rejected += 1
                    continue
            tick += 1

        total = time.perf_counter() - t_start
        generated = sum(len(v) for v in finished.values())
        latency = {
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
        stats = {
            "engine": "disagg",
            "requests": len(finished) + len(errors),
            "rejected": rejected,
            "generated_tokens": generated,
            "tokens_per_sec": generated / total if total else 0.0,
            "total_seconds": total,
            "prefill_seconds": t_prefill,
            "decode_seconds": t_decode,
            "prefill_chunks": chunk_rows,
            "prefill_chunk_calls": chunk_calls,
            "decode_ticks": decode_ticks,
            "mean_slot_occupancy":
                occupancy_sum / decode_ticks if decode_ticks else 0.0,
            "prefill_workers": len(self.prefill),
            "decode_workers": len(self.decode),
            "prefill_streams": self.prefill_streams,
            "max_slots": self.max_slots,
            # useful rows per dispatched row of the batched chunk
            "prefill_util":
                chunk_rows / (chunk_calls * self.prefill_streams)
                if chunk_calls else 0.0,
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_block_size": bs,
            "prefill_chunk": self.chunk,
            "wire": self.wire,
            "decode_captures": max(d.eng._tick.captures
                                   for d in self.decode),
            "decode_captures_per_worker": [d.eng._tick.captures
                                           for d in self.decode],
            "paged_decode_launches": paged_flash_decode.launches - launches0,
            "restarts": self.restarts,
            "pool_reassignments": self.pool_reassignments,
            "migration": self.migrator.stats.as_dict(),
            "paged": {
                "prefill_workers": [w.eng.manager.stats()
                                    for w in self.prefill],
                "prefix_hit_rate":
                    sum(shared_counts) / prompt_tokens
                    if prompt_tokens else 0.0,
                "shared_tokens": int(sum(shared_counts)),
                "prompt_tokens": int(prompt_tokens),
                "prefill_tokens_computed": chunk_rows * self.chunk,
            },
            "slo": slo_report(accepted, ttft_s, e2e_s),
            "latency": latency,
            "window": live.signals(),
        }
        if telemetry is not None:
            telemetry.writer.emit("obs_serve", stats=stats)
        return {"results": finished, "errors": errors, "stats": stats}
