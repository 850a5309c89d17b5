"""Paged KV cache: fixed-size blocks, refcounts, hash-keyed prefix reuse.

The port of ``distributed_deep_learning_tpu/serve/paged.py``.

* **Device side** (torch): every layer's cache is a dict of pools,
  ``cached_key``/``cached_value`` ``(num_blocks, block_size, Hkv, hd)``
  and ``cached_valid`` ``(num_blocks, block_size)`` (padding positions
  inside a prompt are stored invalid and never attended).  A slot's
  logical cache is the concatenation of the physical blocks its BLOCK
  TABLE names.  :func:`gather_slot` materialises one slot (the prefill
  path; the decode attends off the pools through the paged decode
  kernel), :func:`scatter_span` writes fresh positions into their blocks
  and :func:`copy_block` is the copy half of copy-on-write.  The pools
  are updated in place.  With ``kv_dtype`` the K/V pools hold their
  at-rest form: a bf16 cast, or an int8 :class:`.quant.QuantTensor` with
  ``(num_blocks, block_size, Hkv, 1)`` f32 scales, which the pool ops
  index as they index a tensor.
* **Host side** (numpy, copied as it is, with the tracer's event hook):
  :class:`BlockManager` owns the
  free list, per-block refcounts, per-slot tables and a
  :class:`PrefixIndex` keyed by a rolling chain hash of token-prefix
  blocks, so a hash hit means the whole prefix matches (token equality
  is re-verified).  Matching blocks are shared by reference and a shared
  block is copied the moment a slot writes into it.  For the fleet:
  :meth:`BlockManager.flush_index` (a hot weight swap), ``adopt_prefix``
  and ``unadopt`` (the destination half of a KV migration and its
  rollback), ``prefix_summary`` and :func:`predict_shared_len` (routing
  on predicted prefix hits).

Physical block 0 is a TRASH block: reads of it are masked garbage (free
slots, table tails) and writes that must be discarded are routed to it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.serve.quant import (QuantTensor,
                                                             check_dtype)

#: physical id of the write-discard / read-garbage block (never allocated)
TRASH = 0

#: per-layer pool name of the validity mask (beside ``cached_key`` and
#: ``cached_value``), the flax cache's leaf name
VALID_LEAF = "cached_valid"


def chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Rolling prefix hash: digest of the previous chain digest plus this
    block's token ids.  ``h_i`` therefore commits to the ENTIRE token
    prefix through block *i* — equal hashes (plus the token-equality
    re-check) mean equal prefixes, hence bit-equal KV."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


# --- device-side pool ops --------------------------------------------------


def build_pools(num_layers: int, num_blocks: int, block_size: int,
                kv_heads: int, head_dim: int, *, dtype=torch.float32,
                device="cuda", kv_dtype: Optional[str] = None) -> list:
    """Zeroed pools, one dict per layer: ``cached_key``/``cached_value``
    ``(num_blocks, block_size, kv_heads, head_dim)`` in ``dtype`` (bf16
    under ``kv_dtype="bf16"``, an int8 :class:`.quant.QuantTensor` with
    ``(..., 1)`` f32 scales under ``"int8"``) and ``cached_valid``
    ``(num_blocks, block_size)`` bool, on ``device`` (``cuda`` unless the
    caller asks for the CPU; raises without a card)."""
    check_dtype("kv_dtype", kv_dtype)
    device = resolve_device(device)
    shape = (num_blocks, block_size, kv_heads, head_dim)

    def kv():
        if kv_dtype == "int8":
            return QuantTensor(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=device))
        dt = torch.bfloat16 if kv_dtype == "bf16" else dtype
        return torch.zeros(shape, dtype=dt, device=device)

    return [{"cached_key": kv(), "cached_value": kv(),
             VALID_LEAF: torch.zeros(shape[:2], dtype=torch.bool,
                                     device=device)}
            for _ in range(num_layers)]


def _nbytes(t) -> int:
    return t.nbytes if isinstance(t, QuantTensor) else \
        t.numel() * t.element_size()


def pool_bytes(pools) -> int:
    """Bytes held by every pool of every layer (payloads and scales)."""
    return sum(_nbytes(t) for layer in pools for t in layer.values())


def gather_slot(layer: dict, table) -> dict:
    """One slot's logical cache from one layer's pools, in the dense
    cache layout: ``(1, Bps * bs, ...)`` per pool (a copy); a ``(S, Bps)``
    table gathers ``S`` slots, ``(S, Bps * bs, ...)``.  Trash entries of
    ``table`` gather garbage that the causal prefix mask keeps
    unreachable."""
    lead = tuple(table.shape[:-1]) or (1,)
    out = {}
    for name, pool in layer.items():
        got = pool[table]                          # (..., Bps, bs, ...)
        rest = tuple(got.shape[table.dim() + 1:])
        out[name] = got.reshape(lead + (table.shape[-1] * got.shape[
            table.dim()],) + rest)
    return out


def scatter_span(layer: dict, k, v, valid, blocks, offsets) -> None:
    """Write per-position ``k``/``v`` ``(n, Hkv, hd)`` and ``valid``
    ``(n,)`` into one layer's pools at ``(blocks[i], offsets[i])``, in
    place.  Floating rows are cast to a floating pool's dtype; an int8
    pool takes only :class:`.quant.QuantTensor` rows (a float write into
    it raises).  The host guarantees that no two REAL targets collide in
    one call; only :data:`TRASH` may be written more than once."""
    for name, rows in (("cached_key", k), ("cached_value", v)):
        pool = layer[name]
        if not isinstance(pool, QuantTensor):
            rows = rows.to(pool.dtype)
        pool[blocks, offsets] = rows
    layer[VALID_LEAF][blocks, offsets] = valid


def extract_span(layer: dict, pos: int, n: int) -> dict:
    """Positions ``[pos, pos + n)`` of one layer's dense cache (the
    ``(1, L, ...)`` layout :func:`gather_slot` returns), as ``(n, ...)``
    rows: what a program hands to :func:`scatter_span`."""
    return {name: t[0, pos:pos + n] for name, t in layer.items()}


def copy_block(pools, src: int, dst: int) -> None:
    """Physical block copy ``dst <- src`` in every pool of every layer
    (payload and scales alike)."""
    for layer in pools:
        for pool in layer.values():
            pool[dst] = pool[src]


# --- host-side block manager (copied from the JAX package) -----------------


@dataclasses.dataclass
class SharedPrefix:
    """Outcome of a prefix-index match for one prompt."""

    full_blocks: list       # physical ids of fully-matched blocks
    partial_block: Optional[int]   # physical id matched up to partial_len
    partial_len: int               # tokens matched inside partial_block
    chain: bytes                   # chain hash after the full blocks


@dataclasses.dataclass
class _IndexEntry:
    block: int
    tokens: tuple
    last_used: int


class PrefixIndex:
    """Chain-hash → block map with LRU bookkeeping.

    ``children`` maps a prefix chain hash to the hashes that extend it by
    one block — the partial-tail lookup (copy-on-write's entry point)
    walks it to find a cached block whose FIRST ``m`` tokens match the
    prompt's next tokens."""

    def __init__(self):
        self.entries: dict[bytes, _IndexEntry] = {}
        self.children: dict[bytes, list[bytes]] = {}
        self.by_block: dict[int, bytes] = {}
        self._clock = 0

    def __len__(self):
        return len(self.entries)

    def touch(self, h: bytes) -> None:
        self._clock += 1
        self.entries[h].last_used = self._clock

    def get(self, h: bytes):
        return self.entries.get(h)

    def add(self, parent: bytes, h: bytes, block: int,
            tokens: tuple) -> bool:
        """Register ``block`` as the completion of prefix ``parent`` with
        ``tokens``.  First registration wins (a concurrent slot that
        filled an identical block keeps its private copy)."""
        if h in self.entries or block in self.by_block:
            return False
        self._clock += 1
        self.entries[h] = _IndexEntry(block, tokens, self._clock)
        self.children.setdefault(parent, []).append(h)
        self.by_block[block] = h
        return True

    def remove(self, h: bytes) -> int:
        e = self.entries.pop(h)
        del self.by_block[e.block]
        for sibs in self.children.values():
            if h in sibs:
                sibs.remove(h)
                break
        self.children.pop(h, None)
        return e.block

    def lru(self):
        """Hashes in least-recently-used-first order."""
        return sorted(self.entries, key=lambda h: self.entries[h].last_used)


class BlockPoolExhausted(RuntimeError):
    """A single request needs more blocks than the pool will ever hold."""


class BlockManager:
    """Host truth for the paged pool: free list, refcounts, tables, index.

    Pure Python — no JAX.  The engine asks it three questions (can this
    request be admitted?  which physical blocks back slot *s*?  is this
    block writable, or must it be COW-copied first?) and tells it two
    facts (these positions are now committed; this slot retired)."""

    def __init__(self, num_blocks: int, block_size: int, max_slots: int,
                 blocks_per_slot: int):
        if num_blocks < blocks_per_slot:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold even one slot "
                f"({blocks_per_slot} blocks)")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.blocks_per_slot = int(blocks_per_slot)
        # physical ids 1..num_blocks; 0 is TRASH
        self.free: list[int] = list(range(num_blocks, 0, -1))
        self.refs = np.zeros(num_blocks + 1, np.int32)
        self.tables = np.full((max_slots, blocks_per_slot), TRASH, np.int32)
        self.index = PrefixIndex()
        self._reserve: dict[int, int] = {}     # slot -> COW reserve block
        # slot -> (blocks hashed so far, chain hash after them)
        self._chain: dict[int, tuple[int, bytes]] = {}
        self.copies = 0
        self.evictions = 0
        self.peak_in_use = 0
        # optional observability hook: ``on_event(kind, **fields)`` fires
        # on evictions and COW detaches (the engine wires it to the
        # tracer/flight recorder; None costs nothing)
        self.on_event = None

    # --- accounting -------------------------------------------------------
    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self.free)

    def _evictable(self) -> int:
        return int(sum(1 for h, e in self.index.entries.items()
                       if self.refs[e.block] == 1))

    def _alloc(self) -> int:
        b = self.free.pop()
        self.refs[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return b

    def _deref(self, b: int) -> None:
        if b == TRASH:
            return
        self.refs[b] -= 1
        if self.refs[b] < 0:
            raise AssertionError(f"block {b} refcount underflow")
        if self.refs[b] == 0:
            self.free.append(b)

    def evict(self, need: int) -> int:
        """Drop LRU index-only blocks until ``need`` are free (or no more
        are evictable).  Returns how many blocks were freed."""
        freed = 0
        for h in self.index.lru():
            if len(self.free) >= need:
                break
            b = self.index.entries[h].block
            if self.refs[b] != 1:       # some slot still references it
                continue
            self.index.remove(h)
            self._deref(b)
            self.evictions += 1
            freed += 1
        if freed and self.on_event is not None:
            self.on_event("evict", freed=freed, need=need)
        return freed

    def flush_index(self) -> int:
        """Drop EVERY prefix-index entry and the reference each holds.

        Blocks still owned by live slots stay alive (the slots' own
        refs remain); blocks the index alone retained return to the
        free list.  Hot weight swap calls this: indexed KV was computed
        under the OLD weights, so matching it as a prefix under the new
        weights would silently mix generations."""
        dropped = 0
        for h in list(self.index.entries):
            b = self.index.remove(h)
            self._deref(b)
            dropped += 1
        if dropped and self.on_event is not None:
            self.on_event("index_flush", dropped=dropped)
        return dropped

    # --- prefix matching --------------------------------------------------
    def match_prefix(self, prompt: np.ndarray) -> SharedPrefix:
        """Longest reusable prefix of ``prompt`` present in the index:
        a chain of fully-matched blocks plus at most one partially-
        matched tail block.  Capped at ``len(prompt) - 1`` — the final
        prompt token is always recomputed, because sampling the first
        output token needs its hidden state, which no KV cache stores."""
        bs = self.block_size
        toks = np.asarray(prompt)
        L = len(toks)
        h = b""
        full: list[int] = []
        i = 0
        while (i + 1) * bs <= L - 1:    # cap: never cover the last token
            blk = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            h2 = chain_hash(h, blk)
            e = self.index.get(h2)
            if e is None or e.tokens != blk:
                break
            full.append(e.block)
            self.index.touch(h2)
            h = h2
            i += 1
        partial, m = None, 0
        rest = toks[i * bs:]
        cap = L - 1 - i * bs            # last token stays uncached
        if cap > 0:
            best = 0
            for ch in self.index.children.get(h, []):
                e = self.index.entries[ch]
                ct = np.asarray(e.tokens)
                n = int(min(len(ct), len(rest), cap))
                eq = ct[:n] == rest[:n]
                k = int(eq.argmin()) if not eq.all() else n
                if k > best:
                    best, partial = k, e.block
                    self.index.touch(ch)
            m = best
            if m == 0:
                partial = None
        sp = SharedPrefix(full, partial, m, h)
        return sp

    def shared_len(self, sp: SharedPrefix) -> int:
        return len(sp.full_blocks) * self.block_size + sp.partial_len

    # --- admission / release ----------------------------------------------
    def owned_needed(self, sp: SharedPrefix, total_len: int) -> int:
        """Fresh blocks a request needs: capacity for its whole stream
        minus the fully-shared blocks (a partially-shared block cancels
        against its COW reserve — referenced now, copied at first
        write)."""
        logical = -(-total_len // self.block_size)   # ceil
        logical = min(logical, self.blocks_per_slot)
        need = logical - len(sp.full_blocks)
        if need < 0:
            raise AssertionError("shared prefix longer than the request")
        return need

    def can_admit(self, sp: SharedPrefix, total_len: int) -> bool:
        need = self.owned_needed(sp, total_len)
        if need > self.num_blocks:
            raise BlockPoolExhausted(
                f"request needs {need} blocks; the pool holds "
                f"{self.num_blocks}")
        return len(self.free) + self._evictable() >= need

    def admit(self, slot: int, sp: SharedPrefix, total_len: int) -> int:
        """Build slot ``slot``'s block table: shared blocks by reference,
        fresh blocks for the rest, one fresh block held aside as the COW
        reserve when a partial block is referenced.  Returns the shared
        prefix length in tokens."""
        need = self.owned_needed(sp, total_len)
        if len(self.free) < need:
            self.evict(need)
        if len(self.free) < need:
            raise AssertionError("admit() called without can_admit()")
        row = self.tables[slot]
        row[:] = TRASH
        for j, b in enumerate(sp.full_blocks):
            row[j] = b
            self.refs[b] += 1
        logical = min(-(-total_len // self.block_size),
                      self.blocks_per_slot)
        j = len(sp.full_blocks)
        if sp.partial_block is not None:
            row[j] = sp.partial_block
            self.refs[sp.partial_block] += 1
            self._reserve[slot] = self._alloc()
            j += 1
            need -= 1
        while j < logical:
            row[j] = self._alloc()
            j += 1
        self._chain[slot] = (len(sp.full_blocks), sp.chain)
        return self.shared_len(sp)

    def release(self, slot: int) -> None:
        row = self.tables[slot]
        for b in row:
            self._deref(int(b))
        row[:] = TRASH
        r = self._reserve.pop(slot, None)
        if r is not None:
            self._deref(r)
        self._chain.pop(slot, None)

    # --- copy-on-write ----------------------------------------------------
    def writable(self, slot: int, logical: int) -> Optional[tuple[int, int]]:
        """Make logical block ``logical`` of ``slot`` safe to write.

        Exclusive blocks pass through (None).  A shared block (refcount
        > 1 — other slots and/or the prefix index still read it) is
        detached: a fresh physical block takes its table entry and the
        caller must device-copy ``src -> dst`` before writing.  This is
        the write fault of classic copy-on-write, reached whenever a
        prompt's shared prefix ends mid-block."""
        b = int(self.tables[slot, logical])
        if b == TRASH:
            raise AssertionError(
                f"slot {slot} writing unallocated logical block {logical}")
        if self.refs[b] == 1:
            # the slot's own reference is the only one: exclusive, and
            # (since the index always holds a reference to indexed
            # blocks) guaranteed unindexed
            return None
        dst = self._reserve.pop(slot, None)
        if dst is None:
            if not self.free:
                self.evict(1)
            dst = self._alloc()
        self.tables[slot, logical] = dst
        self._deref(b)
        self.copies += 1
        if self.on_event is not None:
            self.on_event("cow", slot=slot, logical=logical,
                          src=b, dst=dst)
        return b, dst

    # --- registration -----------------------------------------------------
    def register_committed(self, slot: int, tokens, committed: int) -> int:
        """Index every full block of ``slot`` whose tokens are final
        (all positions < ``committed``; committed positions are never
        rewritten, so the block's content is frozen).  ``tokens`` is the
        slot's whole stream (prompt + generated) as known to the host.
        The chain hash is a pure function of the token stream, so a
        COW-copied private block registers under its true prefix hash
        like any other.  Returns how many new blocks were indexed."""
        bs = self.block_size
        done, h = self._chain[slot]
        toks = np.asarray(tokens)
        added = 0
        while (done + 1) * bs <= committed:
            blk = tuple(int(t) for t in toks[done * bs:(done + 1) * bs])
            parent = h
            h = chain_hash(h, blk)
            b = int(self.tables[slot, done])
            if b != TRASH and self.index.add(parent, h, b, blk):
                self.refs[b] += 1          # the index holds a reference
                added += 1
            done += 1
        self._chain[slot] = (done, h)
        return added

    def adopt_prefix(self, tokens, n_blocks: int):
        """Register the first ``n_blocks`` full blocks of ``tokens`` as
        if a local slot had prefilled them, allocating fresh physical
        blocks for the chain links not already indexed — the
        destination half of cross-engine prefix cloning
        (:func:`..serve.migrate.clone_prefix`).

        Returns ``(start, new_block_ids)``: ``start`` chain links were
        already indexed here (nothing to copy), and ``new_block_ids``
        are freshly-allocated blocks for links ``start..`` — held ONLY
        by the index (refcount 1), so they age out under LRU eviction
        like any locally-prefilled prefix.  The caller MUST fill every
        returned block with the exact at-rest KV for its positions
        before anything admits against the chain.  Returns None when
        the pool cannot free enough blocks (sharing is best-effort and
        never steals from live slots)."""
        bs = self.block_size
        toks = np.asarray(tokens)
        chain = []
        h = b""
        for i in range(int(n_blocks)):
            blk = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            if len(blk) < bs:
                break
            parent = h
            h = chain_hash(h, blk)
            chain.append((parent, h, blk))
        start = 0
        for parent, h2, blk in chain:
            e = self.index.get(h2)
            if e is None:
                break
            if e.tokens != blk:     # hash collision: never adopt over it
                return None
            self.index.touch(h2)    # protect the stem from our own evict
            start += 1
        todo = chain[start:]
        if not todo:
            return start, []
        if len(self.free) < len(todo):
            self.evict(len(todo))
        if len(self.free) < len(todo):
            return None
        ids = []
        for parent, h2, blk in todo:
            b = self._alloc()       # refcount 1: the index's reference
            if not self.index.add(parent, h2, b, blk):
                self._deref(b)
                return None
            ids.append(b)
        if self.on_event is not None:
            self.on_event("adopt", blocks=len(ids))
        return start, ids

    def unadopt(self, block_ids) -> int:
        """Roll back a failed adoption: drop the index entries holding
        the given freshly-adopted blocks and release the blocks back to
        the free list (a migration that tripped its digest).  Returns
        how many blocks were released."""
        dropped = 0
        for b in block_ids:
            h = self.index.by_block.get(int(b))
            if h is None:
                continue
            self.index.remove(h)
            self._deref(int(b))
            dropped += 1
        if dropped and self.on_event is not None:
            self.on_event("unadopt", blocks=dropped)
        return dropped

    def prefix_summary(self) -> frozenset:
        """Cheap export of this manager's prefix-index coverage: the set
        of chain hashes currently indexed.  Each hash commits to an
        entire token prefix (see :func:`chain_hash`), so a router can
        predict how many prompt tokens would hit this replica's cache
        without seeing any cached tokens (:func:`predict_shared_len`)."""
        return frozenset(self.index.entries)

    def stats(self) -> dict:
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": self.in_use,
            "blocks_peak_in_use": self.peak_in_use,
            "indexed_blocks": len(self.index),
            "cow_copies": self.copies,
            "evictions": self.evictions,
        }


def predict_shared_len(summary, prompt, block_size: int) -> int:
    """Predicted prefix-cache hit for ``prompt`` against a replica's
    :meth:`BlockManager.prefix_summary`: tokens covered by the longest
    chain of fully-matched blocks (the full-block walk of
    :meth:`BlockManager.match_prefix`, without the token re-check or the
    partial tail: the summary carries hashes only)."""
    bs = block_size
    toks = np.asarray(prompt)
    L = len(toks)
    h = b""
    i = 0
    while (i + 1) * bs <= L - 1:    # same cap as match_prefix
        h2 = chain_hash(h, tuple(int(t) for t in toks[i * bs:(i + 1) * bs]))
        if h2 not in summary:
            break
        h = h2
        i += 1
    return i * bs
