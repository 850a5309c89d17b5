"""Chunked prefill planning: long prompts in fixed-size slices.

v1's bucketed prefill runs a whole prompt in one forward — a 4k-token
arrival stalls every in-flight decode stream for the full prompt's
compute, which is exactly the head-of-line blocking the ROADMAP calls
out.  Chunked prefill splits the prompt into fixed-``chunk``-size
slices and lets the scheduler interleave them with decode ticks, so the
inter-token latency of live streams is bounded by ONE chunk's compute,
and TTFT of a queued request by its queue position — not by whichever
giant prompt arrived first.

Everything here is HOST planning (pure numpy) — the device work is the
engine's single compiled chunk program (one static chunk width ⇒ one
program for the lifetime, same compile-once discipline as decode).  Two
tricks keep one static shape serving every prompt:

* **Tail shift** — the last slice is slid LEFT to end exactly at the
  prompt's final token (``feed_start = L - chunk``), re-feeding a few
  already-computed positions instead of running off the end of the
  buffer.  Re-fed positions produce bit-identical KV (same tokens, same
  committed context), and their writes are routed to the TRASH block
  anyway, so the overlap has no effect — it only exists to keep the
  chunk width static.
* **Pad routing** — a prompt shorter than one chunk pads with ``pad_id``
  on the right; pad positions sit beyond every real query's causal
  prefix mask and their KV writes are also trash-routed.

Write targets are computed here per position: already-committed and
out-of-range positions go to physical block :data:`~.paged.TRASH`
(writes discarded), live positions go to ``table[p // block_size]`` at
offset ``p % block_size``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distributed_deep_learning_tpu_torch.serve.paged import TRASH


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One prefill slice: feed ``chunk`` tokens starting at position
    ``feed_start``; ``commit_to`` is the stream length after this slice
    lands; ``logit_index`` is where position ``L-1``'s logits sit inside
    the slice on the final chunk (sample the first output token there),
    ``-1`` on non-final chunks."""

    feed_start: int
    commit_to: int
    logit_index: int

    @property
    def is_last(self) -> bool:
        return self.logit_index >= 0


def plan_chunks(shared_len: int, length: int, chunk: int) -> list:
    """Slices covering positions ``[shared_len, length)`` of a prompt.

    ``shared_len`` positions at the front already hold KV (prefix-cache
    hit) and are skipped entirely — this is where prefix reuse turns
    into saved FLOPs.  The caller guarantees ``shared_len < length``
    (the matcher caps sharing at ``length - 1``: the last prompt token's
    hidden state is always recomputed to sample the first output)."""
    if not 0 <= shared_len < length:
        raise ValueError(f"shared_len {shared_len} outside [0, {length})")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    plans = []
    s = shared_len
    while True:
        if s + chunk >= length:                 # final (maybe only) slice
            feed = max(0, length - chunk)       # tail shift / left pad-room
            plans.append(ChunkPlan(feed, length, (length - 1) - feed))
            return plans
        plans.append(ChunkPlan(s, s + chunk, -1))
        s += chunk


def chunk_tokens(stream: np.ndarray, plan: ChunkPlan, chunk: int,
                 pad_id: int) -> np.ndarray:
    """The ``(chunk,)`` token slice this plan feeds, right-padded with
    ``pad_id`` when the prompt is shorter than one chunk."""
    toks = np.asarray(stream)[plan.feed_start:plan.feed_start + chunk]
    if len(toks) < chunk:
        toks = np.concatenate(
            [toks, np.full(chunk - len(toks), pad_id, toks.dtype)])
    return toks.astype(np.int64)


def write_targets(feed_start: int, n: int, committed: int, length: int,
                  table_row: np.ndarray, block_size: int):
    """Per-position scatter targets for ``n`` positions starting at
    ``feed_start``: ``(blocks, offsets, live)`` with non-live positions
    (already committed, or past the stream end) routed to TRASH."""
    pos = np.arange(feed_start, feed_start + n)
    live = (pos >= committed) & (pos < length)
    logical = np.minimum(pos // block_size, len(table_row) - 1)
    blocks = np.where(live, np.asarray(table_row)[logical], TRASH)
    offsets = np.where(live, pos % block_size, 0)
    return blocks.astype(np.int32), offsets.astype(np.int32), live


def live_blocks(blocks: np.ndarray, live: np.ndarray) -> list:
    """Distinct physical blocks receiving live writes, in first-write
    order — the set the engine must pass through the block manager's
    copy-on-write check before scattering."""
    out, seen = [], set()
    for b in blocks[live]:
        b = int(b)
        if b != TRASH and b not in seen:
            seen.add(b)
            out.append(b)
    return out
