"""Moves of committed paged-KV blocks between pools: the port of
``distributed_deep_learning_tpu/serve/migrate.py``.

Preemption spill and resume, slot evacuation and cross-replica prefix
sharing all reduce to one primitive: move N committed pool blocks from
one engine's pools into another's, bit-exactly.  :class:`BlockMigrator`
is that primitive:

* **gather**: ``leaf[ids]`` of every pool leaf of every layer for at most
  ``width`` block ids, then PACKED into one flat buffer per wire dtype,
  so the payload is two or three tensors however deep the model is.  (The
  JAX migrator pads every move to ``width`` ids with the trash block so
  that one compiled program serves every move; eager PyTorch compiles
  nothing, so a move here carries only its own blocks);
* **hop**: the packed payload copied to the destination's device in
  bounded chunks (:func:`offload`, the port's copy of the chunked copy
  of the JAX package's ``reshard/redistribute.py``);
* **scatter**: each leaf's span sliced back out of the flat buffers (the
  offsets follow from the pool layout) and written at ``dst_ids``.

``wire="at_rest"`` (the default) moves the pools' own representation, so
f32, bf16 and int8+scales pools round-trip bit-exactly.  ``wire="int8"``
carries floating KV as int8 with one f32 scale a block row (the gradient
collectives' symmetric int8), fewer bytes and lossy.

Integrity is end to end: ``verify=True`` takes a blake2b digest of the
payload before the hop and re-checks it after; a mismatch (a lost or
corrupted transfer, the ``migrate_drop`` and ``evac_drop`` chaos kinds)
raises :class:`MigrationError` BEFORE anything is scattered, so the
destination pools are never poisoned and the ledger replay recovers.
Packing, chunking and the digest check all happen before any scatter.

Wire bytes land in ``comm_bytes{op="kv_migrate"}`` and
``serve_migration_bytes`` of a :class:`..obs.metrics.MetricsRegistry`,
wall time in the ``serve_migration_s`` histogram; a ``tracer``
(:class:`..obs.trace.Tracer`) gets a ``kv_migrate`` span a move.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.serve import paged, quant

#: wire formats: ``at_rest`` moves the pools' own representation
#: (bit-exact round trips), ``int8`` re-quantizes floating KV payload
WIRES = ("at_rest", "int8")

#: largest piece of one hop's copy (the JAX package's
#: ``reshard.redistribute.CHUNK_THRESHOLD_BYTES``)
CHUNK_BYTES = 64 << 20


class MigrationError(RuntimeError):
    """A KV block transfer failed its end-to-end integrity check — the
    payload was lost or corrupted in flight.  Nothing was scattered; the
    caller replays the affected requests from its ledger (the supervisor
    contains this exactly like a KV-corruption fault)."""


@dataclasses.dataclass
class MigrationStats:
    """Cumulative accounting for one :class:`BlockMigrator`."""

    moves: int = 0
    blocks: int = 0
    wire_bytes: int = 0       # bytes actually carried
    seconds: float = 0.0      # wall time inside migrate() calls
    digest_seconds: float = 0.0   # of it, in the two digests
    copy_seconds: float = 0.0     # of it, in the gather, hop and scatter
    hops: int = 0             # moves that crossed to another device
    verified: int = 0
    failed: int = 0

    def gb_per_s(self) -> float:
        return self.wire_bytes / max(self.seconds, 1e-9) / (1 << 30)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gb_per_s"] = round(self.gb_per_s(), 4)
        return d


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor on its own device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def tree_digest(tree) -> bytes:
    """Host blake2b-128 over every tensor's bytes, in order (a list, or
    a dict's values): the end-to-end integrity check of a migration
    payload and of a device-path preemption spill."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(tree):
        h.update(_raw(leaf).cpu().numpy().tobytes())
    return h.digest()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory when it comes off a card."""
    if t.device.type != "cuda":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array (bf16, which numpy lacks, as its raw int16
    bits): the npz spill audit's leaf form."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _chunked_copy(t: torch.Tensor, device, chunk_bytes: int) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    src, dst = _raw(t), _raw(out)
    for i in range(0, src.numel(), max(1, chunk_bytes)):
        dst[i:i + chunk_bytes].copy_(src[i:i + chunk_bytes])
    return out


def offload(tree, device, chunk_bytes: int = CHUNK_BYTES):
    """Copy every tensor of a payload (a list or a dict) onto ``device``
    in pieces of at most ``chunk_bytes``; a new payload of the same
    kind.  Used for a migration's hop and for the engine's device-path
    preemption spill (KV parked in a tensor on the card)."""
    if isinstance(tree, dict):
        return {k: _chunked_copy(v, device, chunk_bytes)
                for k, v in tree.items()}
    return [_chunked_copy(v, device, chunk_bytes) for v in tree]


def _pool_leaves(pools):
    """Every pool tensor of every layer in a fixed walk: key, value (an
    int8 pool's payload then its scales), validity.  Yields ``(tensor,
    is_scale)``."""
    for layer in pools:
        for name in ("cached_key", "cached_value", paged.VALID_LEAF):
            t = layer[name]
            if quant.is_quant(t):
                yield t.q, False
                yield t.s, True
            else:
                yield t, False


def _int8_rows(x: torch.Tensor):
    """Symmetric int8 with one f32 scale a row of ``x`` ``(n, m)``: the
    gradient collectives' wire format, a row at a time.  The amax, the
    scale and ``x / scale`` are taken in ``x``'s own dtype, as JAX's
    ``collectives.quantize`` takes them; only the scale is carried in
    f32."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale[:, 0].float()


def _int8_rows_back(q: torch.Tensor, scale: torch.Tensor, dtype):
    """:func:`_int8_rows`' inverse, JAX's ``collectives.dequantize``:
    the codes in ``dtype`` times the f32 scale, back in ``dtype``."""
    return (q.to(dtype) * scale[:, None]).to(dtype)


class BlockMigrator:
    """Mover of paged-KV blocks between pool lists.

    ``width`` bounds a move's blocks; use the source engine's
    ``blocks_per_slot``: one slot's worth of blocks is the natural
    migration unit.  ``migrate`` writes the destination pools in place
    and returns them (the JAX migrator's functional contract)."""

    def __init__(self, width: int, *, wire: str = "at_rest", registry=None,
                 tracer=None, chunk_bytes: int = CHUNK_BYTES):
        if width < 1:
            raise ValueError(f"migrator width must be >= 1, got {width}")
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
        self.width = int(width)
        self.wire = wire
        self.chunk_bytes = int(chunk_bytes)
        self.stats = MigrationStats()
        self.tracer = tracer
        if registry is not None:
            self._c_bytes = registry.counter("serve_migration_bytes",
                                             wire=wire)
            self._c_comm = registry.counter(
                "comm_bytes", op="kv_migrate",
                method="int8" if wire == "int8" else "none")
            self._h_s = registry.histogram("serve_migration_s")
        else:
            self._c_bytes = self._c_comm = self._h_s = None

    def _quantizes(self, leaf, is_scale: bool) -> bool:
        return (self.wire == "int8" and leaf.is_floating_point()
                and not is_scale)

    @torch.no_grad()
    def _gather(self, pools, ids: torch.Tensor) -> dict:
        """Pack ``ids``' blocks of every pool leaf: one flat buffer per
        wire dtype, plus a row scale a block and leaf when the wire
        quantizes."""
        bufs: dict = {}
        scales = []
        for leaf, is_scale in _pool_leaves(pools):
            x = leaf[ids]                              # (width, bs, ...)
            if self._quantizes(leaf, is_scale):
                q, s = _int8_rows(x.reshape(x.shape[0], -1))
                bufs.setdefault("int8", []).append(q.reshape(-1))
                scales.append(s)
            else:
                bufs.setdefault(str(x.dtype).rsplit(".", 1)[-1],
                                []).append(x.reshape(-1))
        payload = {f"b_{k}": torch.cat(v) for k, v in bufs.items()}
        if scales:
            payload["scales"] = torch.cat(scales)
        return payload

    @torch.no_grad()
    def _scatter(self, pools, payload: dict, ids: torch.Tensor) -> None:
        """Unpack the payload (the same walk as :meth:`_gather`) and
        write each leaf's blocks at ``ids``."""
        offs = {k: 0 for k in payload}
        srow = 0
        for leaf, is_scale in _pool_leaves(pools):
            shape = (int(ids.shape[0]),) + tuple(leaf.shape[1:])
            n = int(np.prod(shape))
            if self._quantizes(leaf, is_scale):
                flat = payload["b_int8"][offs["b_int8"]:offs["b_int8"] + n]
                offs["b_int8"] += n
                s = payload["scales"][srow:srow + shape[0]]
                srow += shape[0]
                x = _int8_rows_back(flat.reshape(shape[0], -1), s,
                                    leaf.dtype)
            else:
                key = "b_" + str(leaf.dtype).rsplit(".", 1)[-1]
                x = payload[key][offs[key]:offs[key] + n]
                offs[key] += n
            leaf[ids] = x.reshape(shape).to(leaf.device)

    @staticmethod
    def _ids(ids, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=device)

    def migrate(self, src_pools, dst_pools, src_ids, dst_ids, *,
                device=None, verify: bool = False, chaos=None,
                sync: bool = False, trace_id: str = "kv"):
        """Move ``src_pools``' blocks ``src_ids`` into ``dst_pools`` at
        ``dst_ids``; returns ``dst_pools``, written in place.

        ``device``: hop the packed payload there first (the destination
        pools' device); ``None`` scatters it from where it was gathered
        (two replicas on one card).
        ``verify``: digest the payload before and after the hop and raise
        :class:`MigrationError` on mismatch, scattering nothing.
        ``chaos``: fault-injection seam, a callable payload -> payload
        applied between the digest and the hop.  ``sync``: wait for the
        scatter to land (timing)."""
        src_ids = [int(b) for b in src_ids]
        dst_ids = [int(b) for b in dst_ids]
        if len(src_ids) != len(dst_ids):
            raise ValueError(f"src/dst id count mismatch: "
                             f"{len(src_ids)} vs {len(dst_ids)}")
        if len(src_ids) > self.width:
            raise ValueError(f"move of {len(src_ids)} blocks exceeds "
                             f"migrator width {self.width}")
        if not src_ids:
            return dst_pools
        src_dev = next(_pool_leaves(src_pools))[0].device
        dst_dev = next(_pool_leaves(dst_pools))[0].device
        t0 = time.perf_counter()
        payload = self._gather(src_pools, self._ids(src_ids, src_dev))
        t_dig = 0.0
        digest = None
        if verify:
            t1 = time.perf_counter()
            digest = tree_digest(payload)
            t_dig += time.perf_counter() - t1
        if chaos is not None:
            payload = chaos(payload)
        hop = device is not None
        if hop:
            payload = offload(payload, device, self.chunk_bytes)
        if digest is not None:
            self.stats.verified += 1
            t1 = time.perf_counter()
            same = tree_digest(payload) == digest
            t_dig += time.perf_counter() - t1
            if not same:
                self.stats.failed += 1
                raise MigrationError(
                    f"kv migrate: payload digest mismatch after "
                    f"{'device hop' if hop else 'copy'} of "
                    f"{len(src_ids)} block(s) — transfer lost or "
                    f"corrupted; nothing scattered, replay from ledger")
        self._scatter(dst_pools, payload, self._ids(dst_ids, dst_dev))
        if sync and dst_dev.type == "cuda":
            torch.cuda.synchronize(dst_dev)
        dt = time.perf_counter() - t0
        wire_b = tree_bytes(payload)
        self.stats.moves += 1
        self.stats.blocks += len(src_ids)
        self.stats.wire_bytes += wire_b
        self.stats.seconds += dt
        self.stats.digest_seconds += t_dig
        self.stats.copy_seconds += dt - t_dig
        self.stats.hops += int(hop)
        if self._c_bytes is not None:
            self._c_bytes.inc(wire_b)
            self._c_comm.inc(wire_b)
            self._h_s.observe(dt)
        if self.tracer is not None:
            self.tracer.add("kv_migrate", t0, t0 + dt, trace_id,
                            track="migrate", blocks=len(src_ids),
                            bytes=wire_b, hop=hop, wire=self.wire)
        return dst_pools


def clone_prefix(src_engine, dst_engine, prompt, migrator: BlockMigrator,
                 *, device=None, sync: bool = False) -> int:
    """Copy the longest committed full-block prefix of ``prompt`` from
    one engine's pools into another's — prefix blocks prefilled once
    serve the fleet.

    Matches on the source's real index (``match_prefix``), registers the
    chain on the destination (``BlockManager.adopt_prefix``), and
    migrates only the blocks the destination doesn't already hold.
    Returns the number of prompt tokens made shareable (0 when the
    source has nothing, the destination already has it all, or the
    destination can't free enough blocks — sharing is best-effort and
    never required for correctness)."""
    prompt = np.asarray(prompt)
    sp = src_engine.manager.match_prefix(prompt)
    if not sp.full_blocks:
        return 0
    adopted = dst_engine.manager.adopt_prefix(prompt, len(sp.full_blocks))
    if adopted is None:
        return 0
    start, dst_ids = adopted
    if not dst_ids:
        return 0
    src_ids = list(sp.full_blocks[start:start + len(dst_ids)])
    moved = 0
    for i in range(0, len(dst_ids), migrator.width):
        dst_engine.pools = migrator.migrate(
            src_engine.pools, dst_engine.pools,
            src_ids[i:i + migrator.width],
            dst_ids[i:i + migrator.width],
            device=device, sync=sync)
        moved += len(dst_ids[i:i + migrator.width])
    return moved * dst_engine.block_size
