"""Host-side slot scheduler: queue, occupancy, retirement.

Pure Python bookkeeping, a copy of the JAX package's module.  The
engine owns the device work; this class decides WHICH request sits in
WHICH slot at every tick, retires rows the moment they hit EOS or their token budget, and
hands the freed slot to the next arrived request — so device throughput
tracks slot occupancy instead of the slowest request in a batch
(the failure mode of run-to-completion ``generate()``).

Arrivals are measured in DECODE TICKS (``arrival_tick``), not wall
seconds: a seeded trace then exercises identical scheduling decisions on
any machine, which is what the compile-count and parity tests need.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int token array; generation runs until
    ``max_new_tokens`` tokens exist or the engine's ``eos_id`` is
    emitted (EOS counts as the final token, mirroring the usual serving
    contract).
    """

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_tick: int = 0
    # per-request service-level objectives, milliseconds; None = no SLO.
    # The engine measures, serve/load.py:slo_report scores attainment.
    slo_ttft_ms: Optional[float] = None
    slo_e2e_ms: Optional[float] = None
    # admission priority class: 0 = interactive (never shed), larger =
    # more sheddable (serve/admission.py sheds classes >= its floor
    # under overload).  The default 1 is "normal" traffic.
    priority: int = 1

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt)
        if self.prompt.ndim != 1 or self.prompt.size < 1:
            raise ValueError(f"request {self.uid}: prompt must be a "
                             f"non-empty 1-D token array, got shape "
                             f"{self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must "
                             f"be >= 1, got {self.max_new_tokens}")
        for name in ("slo_ttft_ms", "slo_e2e_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"request {self.uid}: {name} must be "
                                 f"positive, got {v}")
        if not isinstance(self.priority, int) or self.priority < 0:
            raise ValueError(f"request {self.uid}: priority must be a "
                             f"non-negative int, got {self.priority!r}")

    @property
    def trace_id(self) -> str:
        """Stable per-request trace id (obs.trace span correlation)."""
        return f"req-{self.uid}"


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: Optional[list] = None

    @property
    def active(self) -> bool:
        return self.request is not None


class SlotScheduler:
    """FIFO admission over a fixed slot table."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[Request] = []   # arrival-tick then submit order
        self.finished: dict[int, np.ndarray] = {}
        # uid -> wall time its arrival tick was first reached (stamped by
        # mark_arrivals; latency measurements anchor here so TTFT includes
        # queue wait, not just prefill)
        self.arrival_wall: dict[int, float] = {}

    # --- queue -----------------------------------------------------------
    def submit(self, request: Request) -> None:
        self._queue.append(request)
        # stable sort: same-tick arrivals keep submission order
        self._queue.sort(key=lambda r: r.arrival_tick)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.active]

    @property
    def occupancy(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def next_arrival(self) -> Optional[int]:
        return self._queue[0].arrival_tick if self._queue else None

    def mark_arrivals(self, tick: int, now: float) -> None:
        """Stamp the wall time every newly-arrived request became
        visible (``arrival_tick <= tick``).  The queue is sorted by
        arrival tick, so this walks only the arrived prefix; re-marking
        is a no-op (the FIRST sighting is the arrival)."""
        for req in self._queue:
            if req.arrival_tick > tick:
                break
            self.arrival_wall.setdefault(req.uid, now)

    def queue_depth(self, tick: int) -> int:
        """Requests that have ARRIVED but hold no slot yet — the depth a
        user-facing queue gauge should report (future-tick arrivals are
        not waiting on anyone)."""
        depth = 0
        for req in self._queue:
            if req.arrival_tick > tick:
                break
            depth += 1
        return depth

    # --- placement / retirement ------------------------------------------
    def peek(self, tick: int) -> Optional[Request]:
        """The request :meth:`place` would pop next, if one has arrived
        — lets the engine test admission (block-pool budget, load shed)
        BEFORE committing a slot to it."""
        if self._queue and self._queue[0].arrival_tick <= tick:
            return self._queue[0]
        return None

    def drop_head(self, tick: int) -> Optional[Request]:
        """Pop and return the arrived head WITHOUT placing it — the
        shed path of admission control.  The caller owns reporting the
        drop (the engine records it in ``errors``); placed slots are
        never touched, so shedding cannot starve an admitted request."""
        if self._queue and self._queue[0].arrival_tick <= tick:
            return self._queue.pop(0)
        return None

    def place(self, tick: int) -> Optional[tuple[int, Request]]:
        """Pop the next ARRIVED request into the lowest free slot, or
        None when no slot is free / nothing has arrived yet."""
        if not self._queue or self._queue[0].arrival_tick > tick:
            return None
        for i, slot in enumerate(self.slots):
            if not slot.active:
                req = self._queue.pop(0)
                slot.request = req
                slot.generated = []
                return i, req
        return None

    def record(self, slot_idx: int, token: int,
               eos_id: Optional[int]) -> Optional[Request]:
        """Append one generated token to a slot; retire and return the
        request when it hits EOS or its budget (else None).  The freed
        slot is immediately placeable."""
        slot = self.slots[slot_idx]
        if not slot.active:
            raise ValueError(f"slot {slot_idx} is not active")
        slot.generated.append(int(token))
        req = slot.request
        done = len(slot.generated) >= req.max_new_tokens or \
            (eos_id is not None and int(token) == eos_id)
        if not done:
            return None
        self.finished[req.uid] = np.asarray(slot.generated,
                                            dtype=req.prompt.dtype)
        slot.request = None
        slot.generated = None
        return req

    def preempt(self, slot_idx: int) -> tuple[Request, list]:
        """Evict a placed request from its slot WITHOUT retiring it,
        returning ``(request, generated_so_far)`` so the caller can park
        the pair (KV spilled to host) and later :meth:`restore` it.  The
        freed slot is immediately placeable; ``arrival_wall`` is left
        untouched so TTFT/e2e clocks keep running across the gap — a
        preempted user is still waiting."""
        slot = self.slots[slot_idx]
        if not slot.active:
            raise ValueError(f"slot {slot_idx} is not active")
        req, gen = slot.request, slot.generated
        slot.request = None
        slot.generated = None
        return req, gen

    def restore(self, request: Request, generated: list) -> Optional[int]:
        """Re-place a preempted request into the lowest free slot with
        its generated-token history intact, bypassing the arrival queue
        (it already waited once).  Returns the slot index, or None when
        no slot is free."""
        for i, slot in enumerate(self.slots):
            if not slot.active:
                slot.request = request
                slot.generated = list(generated)
                return i
        return None

    def last_tokens(self, fill: int = 0) -> np.ndarray:
        """Per-slot feedback tokens for the next decode tick: the slot's
        most recent token, ``fill`` for free slots (their compute is
        discarded; the value only has to be a legal id)."""
        out = np.full(len(self.slots), fill, np.int32)
        for i, slot in enumerate(self.slots):
            if slot.active and slot.generated:
                out[i] = slot.generated[-1]
        return out


class PagedScheduler(SlotScheduler):
    """:class:`SlotScheduler` plus a PREFILL stage with chunk fairness.

    Under chunked prefill a placed request is not immediately decodable:
    its prompt lands chunk by chunk across ticks.  This scheduler tracks
    which slots are mid-prefill, and deals chunk turns ROUND-ROBIN
    (rotating one step per tick) so a burst of long prompts splits the
    per-tick chunk budget instead of the first one monopolising it.
    Combined with the engine running decode every tick, both bounds
    hold: in-flight streams stall at most one chunk budget per token,
    and every queued prompt's prefill advances within a bounded number
    of ticks of placement — the property the fairness regression test
    pins down.
    """

    def __init__(self, max_slots: int):
        super().__init__(max_slots)
        self.prefilling: dict[int, int] = {}   # slot -> chunks remaining
        self._turn = 0

    def begin_prefill(self, idx: int, n_chunks: int) -> None:
        if n_chunks < 1:
            raise ValueError(f"slot {idx}: prefill needs >= 1 chunk")
        self.prefilling[idx] = n_chunks

    def note_chunk(self, idx: int) -> bool:
        """One chunk landed; True when the slot's prefill completed and
        it joins the decodable set."""
        self.prefilling[idx] -= 1
        if self.prefilling[idx] <= 0:
            del self.prefilling[idx]
            return True
        return False

    def decoding_slots(self) -> list:
        return [i for i in self.active_slots if i not in self.prefilling]

    def chunk_order(self) -> list:
        """Slots still prefilling, rotated one position per call so no
        slot owns the front of the budget two ticks running."""
        ids = sorted(self.prefilling)
        if not ids:
            return []
        self._turn = (self._turn + 1) % len(ids)
        return ids[self._turn:] + ids[:self._turn]
