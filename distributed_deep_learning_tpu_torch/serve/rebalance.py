"""Live slot evacuation: move a mid-request decode slot between replicas
(the port of the JAX package's ``serve/rebalance.py``).

The fleet router is *crash-tolerant* — a dead replica's requests
replay from the fleet :class:`..serve.supervisor.RequestLedger` onto
survivors, recomputing the committed prefix from scratch.  This module
makes it *proactive*: a hot or degrading replica hands its decoding
slots to a healthy one BEFORE it crashes, and the handoff moves the
committed KV blocks instead of recomputing them.

The mechanism composes three landed primitives:

* the **ledger** knows every open request's committed-token tail, so
  ``prompt + committed`` is the exact token stream whose KV the source
  replica holds;
* the source's **prefix index** (fed per tick by
  :meth:`..serve.paged.BlockManager.register_committed`) maps that
  stream to the physical blocks, and the destination's
  :meth:`..serve.paged.BlockManager.adopt_prefix` registers the same
  chain locally with fresh blocks;
* the **migrator** (:class:`..serve.migrate.BlockMigrator`) moves the
  payload digest-verified and at-rest bit-exact (fp32, bf16 and
  int8+scales pools all round-trip exactly).

Failure is first-class: a corrupted payload (the ``evac_drop`` chaos
kind) trips the end-to-end digest BEFORE anything scatters, and
:func:`evacuate_slot` rolls the destination back with
:meth:`..serve.paged.BlockManager.unadopt` — the source keeps its
blocks, the request stays open in the ledger, and the normal replay
path recovers bit-identically.  Zero loss either way, by construction.

:class:`EvacuationSignal` is the control-plane half: the router's tick
observer raises it on a healthy→degraded transition (or a hot-spot
detection — :class:`HotspotDetector`), the replica's supervisor treats
it as FATAL (escalates without containing, exactly like
:class:`..serve.fleet.ReplicaCrash`), and the router drains the
replica's open slots onto its peers.
"""

from __future__ import annotations

import numpy as np

from distributed_deep_learning_tpu_torch.serve.migrate import (
    BlockMigrator, MigrationError)


class EvacuationSignal(RuntimeError):
    """Raised from the router's per-tick observer to pull a replica out
    of its serving loop for a proactive drain.  Fleet supervisors run
    with this in their ``fatal`` tuple, so it escalates to the router —
    which, unlike a crash, migrates the replica's committed KV to its
    peers instead of discarding it.

    ``rid``/``reason`` identify the replica and the trigger
    (``"degraded"`` or ``"hotspot"``)."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"evacuating replica {rid}: {reason}")
        self.rid = int(rid)
        self.reason = str(reason)


def evacuate_slot(src_engine, dst_engine, stream,
                  migrator: BlockMigrator, *, device=None, chaos=None,
                  sync: bool = False) -> dict:
    """Move the committed full-block KV prefix of ``stream`` (prompt +
    committed tokens, from the ledger) from ``src_engine``'s pools into
    ``dst_engine``'s, digest-verified, rolling back on failure (the
    destination's pools are written in place).

    Returns a record dict: ``ok`` (the destination now holds every
    block it adopted), ``blocks``/``tokens`` moved, ``rolled_back``
    (a :class:`..serve.migrate.MigrationError` tripped and the adopted
    blocks were released), and ``error``.  ``ok`` with ``blocks == 0``
    means there was nothing to move (no committed full blocks on the
    source, or the destination already held the chain) — the request
    simply replays with a cold cache; correctness never depends on the
    move landing."""
    stream = np.asarray(stream)
    bs = int(src_engine.block_size)
    sp = src_engine.manager.match_prefix(stream)
    if not sp.full_blocks:
        return {"ok": True, "blocks": 0, "tokens": 0,
                "rolled_back": False, "error": None}
    adopted = dst_engine.manager.adopt_prefix(stream, len(sp.full_blocks))
    if adopted is None:
        return {"ok": False, "blocks": 0, "tokens": 0,
                "rolled_back": False,
                "error": "destination cannot adopt the chain "
                         "(pool full or hash collision)"}
    start, dst_ids = adopted
    if not dst_ids:
        # destination already holds the whole chain — nothing to carry
        return {"ok": True, "blocks": 0, "tokens": start * bs,
                "rolled_back": False, "error": None}
    src_ids = list(sp.full_blocks[start:start + len(dst_ids)])
    try:
        for i in range(0, len(dst_ids), migrator.width):
            dst_engine.pools = migrator.migrate(
                src_engine.pools, dst_engine.pools,
                src_ids[i:i + migrator.width],
                dst_ids[i:i + migrator.width],
                device=device, verify=True, chaos=chaos, sync=sync,
                trace_id="evacuate")
    except MigrationError as exc:
        # nothing from the failed chunk was scattered; chunks that DID
        # land sit in blocks we are about to free — unreachable once
        # the index entries go, so the destination is clean either way
        dst_engine.manager.unadopt(dst_ids)
        return {"ok": False, "blocks": 0, "tokens": 0,
                "rolled_back": True, "error": str(exc)}
    return {"ok": True, "blocks": len(dst_ids),
            "tokens": (start + len(dst_ids)) * bs,
            "rolled_back": False, "error": None}


class HotspotDetector:
    """Per-replica ITL-skew detector over the router's live tick feed.

    Each replica's decode-tick wall times land in a bounded trailing
    sample (:meth:`observe`); a replica is HOT when its p99 exceeds
    ``ratio`` × the fleet-wide median of per-replica p50s for
    ``patience`` consecutive observations — the queue-depth/ITL-p99
    skew signal the ROADMAP names, computed without wall-clock
    dependence so drills stay deterministic.  A single replica has no
    fleet to skew against and is never hot."""

    def __init__(self, *, ratio: float = 3.0, patience: int = 3,
                 min_ticks: int = 4, window: int = 64):
        if ratio <= 1.0:
            raise ValueError(f"hotspot ratio must be > 1, got {ratio}")
        if patience < 1:
            raise ValueError(f"hotspot patience must be >= 1, got "
                             f"{patience}")
        self.ratio = float(ratio)
        self.patience = int(patience)
        self.min_ticks = int(min_ticks)
        self.window = int(window)
        self._samples: dict[int, list] = {}
        self._streak: dict[int, int] = {}
        self.detections: list[tuple[int, float]] = []

    def observe(self, rid: int, elapsed_s: float) -> bool:
        """Feed one decode tick; True when ``rid`` crosses into hot."""
        s = self._samples.setdefault(int(rid), [])
        s.append(float(elapsed_s))
        del s[:-self.window]
        if len(s) < self.min_ticks:
            return False
        others = [np.percentile(v, 50)
                  for r, v in self._samples.items()
                  if r != rid and len(v) >= self.min_ticks]
        if not others:
            return False
        floor = float(np.median(others))
        p99 = float(np.percentile(s, 99))
        if p99 > self.ratio * max(floor, 1e-9):
            self._streak[rid] = self._streak.get(rid, 0) + 1
        else:
            self._streak[rid] = 0
        if self._streak[rid] >= self.patience:
            self._streak[rid] = 0
            self.detections.append((int(rid), p99))
            return True
        return False
