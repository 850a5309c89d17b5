"""Portable leaf redistribution: a whole saved leaf -> this rank's part.
The port of ``distributed_deep_learning_tpu/reshard/redistribute.py``.

The port's checkpoint holds every leaf whole (:mod:`..utils.checkpoint`),
so resharding is a question of how each rank takes its part of a leaf,
laid out as its target parameter is (:mod:`..parallel.shards`: FSDP2's
``Shard(0)`` chunks, a tensor-parallel slice, or the whole leaf).  Two
paths, one contract (the same bytes either way):

* **gather** — the whole leaf is copied to the device, then split there
  (``shards.local_part``).  Always works; the card holds the whole leaf
  for a moment.
* **chunked** — the rank's slice is taken on the host (from the
  memory-mapped file, so only its pages are read) and copied to the
  device in pieces of at most :data:`CHUNK_THRESHOLD_BYTES` along dim 0,
  straight into the destination: the card never holds a second whole
  copy (the per-shard placement discipline of arxiv 2112.01075).

``auto`` picks chunked for leaves worth chunking (>= 1 MiB, non-scalar)
and gather for everything else.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# Below this, per-piece bookkeeping costs more than it saves.
CHUNK_THRESHOLD_BYTES = 1 << 20


@dataclasses.dataclass
class RedistributeStats:
    """What one redistribution pass moved, and how."""

    leaves: int = 0
    bytes_moved: int = 0
    seconds: float = 0.0
    gathered: int = 0
    chunked: int = 0

    def seconds_per_gb(self) -> float:
        return self.seconds * (1 << 30) / max(self.bytes_moved, 1)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["seconds_per_gb"] = round(self.seconds_per_gb(), 4)
        return d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def copy_chunked(dst: torch.Tensor, src: torch.Tensor,
                 chunk_bytes: int = CHUNK_THRESHOLD_BYTES) -> torch.Tensor:
    """``dst.copy_(src)`` in pieces of at most ``chunk_bytes`` along dim 0
    (one piece for a small or 0-d leaf); returns ``dst``."""
    nbytes = _nbytes(src)
    if nbytes <= chunk_bytes or src.dim() == 0 or src.shape[0] <= 1:
        return dst.copy_(src)
    rows = max(1, int(src.shape[0] * chunk_bytes // nbytes))
    for i in range(0, src.shape[0], rows):
        n = min(rows, src.shape[0] - i)
        dst.narrow(0, i, n).copy_(src.narrow(0, i, n))
    return dst


def chunked_device_put(leaf: torch.Tensor, device,
                       chunk_bytes: int = CHUNK_THRESHOLD_BYTES
                       ) -> torch.Tensor:
    """Move one dense tensor to ``device`` in bounded-size pieces: the
    destination is allocated once on the device and filled piece by piece
    (:func:`copy_chunked`), so no transfer exceeds the budget and no
    second whole copy is made."""
    device = torch.device(device)
    if leaf.device == device:
        return leaf
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    return copy_chunked(out, leaf, chunk_bytes)


def host_local_part(p, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole leaf ``full`` laid out as ``p``,
    taken where ``full`` lies (a view where one exists): FSDP2's
    ``Shard(dim)`` chunks as ``DTensor`` cuts them (``torch.chunk``,
    empty past the last chunk), a tensor-parallel slice, or ``full``."""
    from distributed_deep_learning_tpu_torch.parallel.shards import \
        is_dtensor

    if is_dtensor(p):
        coord = p.device_mesh.get_coordinate()
        t = full
        for i, pl in enumerate(p.placements):
            if pl.is_shard():
                chunks = torch.chunk(t, p.device_mesh.size(i), dim=pl.dim)
                t = chunks[coord[i]] if coord[i] < len(chunks) \
                    else t.narrow(pl.dim, 0, 0)
        return t
    shard = getattr(p, "tp_shard", None)
    if shard is None:
        return full
    n = full.shape[shard.dim] // shard.parts
    return full.narrow(shard.dim, shard.index * n, n)


def redistribute_leaf(p, full: torch.Tensor, device, *,
                      method: str = "auto") -> tuple[torch.Tensor, str]:
    """This rank's part of ``full`` (laid out as ``p``) on ``device``;
    returns ``(tensor, path_used)`` with ``path_used`` ``"gather"`` or
    ``"chunked"``."""
    from distributed_deep_learning_tpu_torch.parallel.shards import \
        local_part

    if method == "auto":
        method = "chunked" if full.dim() and \
            _nbytes(full) >= CHUNK_THRESHOLD_BYTES else "gather"
    if method == "chunked":
        part = host_local_part(p, full)
        return chunked_device_put(part.contiguous(), device), "chunked"
    return local_part(p, full.to(device)), "gather"


def redistribute(pairs, device, *, method: str = "auto"):
    """Map every ``(target parameter, whole leaf)`` of ``pairs`` to this
    rank's part on ``device``.  Returns ``(parts, RedistributeStats)``;
    ``bytes_moved`` counts the bytes copied to the device."""
    stats = RedistributeStats()
    start = time.perf_counter()
    out = []
    for p, full in pairs:
        part, used = redistribute_leaf(p, full, device, method=method)
        stats.leaves += 1
        stats.bytes_moved += _nbytes(full if used == "gather" else part)
        if used == "chunked":
            stats.chunked += 1
        else:
            stats.gathered += 1
        out.append(part)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    stats.seconds = time.perf_counter() - start
    return out, stats


def tree_shardings(state) -> dict:
    """Each parameter of ``state``'s model by its state-dict name: the
    target a saved leaf of that name is laid out as (buffers are whole)."""
    from distributed_deep_learning_tpu_torch.parallel.shards import resharded

    return dict(resharded(state.model).named_parameters())
