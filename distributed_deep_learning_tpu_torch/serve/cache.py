"""Slot table: one static KV cache for the slot engine, any request mix.
The port of ``distributed_deep_learning_tpu/serve/cache.py``.

The model's dense decode cache
(:meth:`..models.transformer.CausalLM.init_cache`) is ``(B, total_len,
Hkv, hd)`` per layer with ONE ``index`` shared by the rows: right for
batch-synchronous ``generate()``, not for continuous
batching, where every sequence sits at its own position.  The slot table
re-hosts that cache with a ``max_slots`` axis in place of the batch axis
(per layer ``cached_key``/``cached_value`` ``(max_slots, max_len, Hkv,
hd)`` in the model's compute dtype, ``cached_valid`` ``(max_slots,
max_len)`` bool) and one ``(max_slots,)`` position vector, ``index``,
kept on the host: the engine stages it into the decode tick's static
buffers.  Requests enter and leave slots by :func:`write_slot`, never by
a change of shape, which is what lets one captured decode tick serve the
engine's lifetime.

A free slot keeps advancing with every tick, as the flax engine's vmapped
decode advances it.  Its position is clamped to ``max_len - 1`` where the
tick reads it (:func:`tick_positions`), the clamp that ``dynamic_update_slice``
applies silently in the flax engine, so a free slot writes its discarded
K/V at its row's last position and never indexes past the table; the
next :func:`write_slot` into that row overwrites all of it.
"""

from __future__ import annotations

import numpy as np
import torch

#: per-layer leaves of the slot table, the flax cache's leaf names
KV_LEAVES = ("cached_key", "cached_value")
VALID_LEAF = "cached_valid"


def allocate_slots(model, max_slots: int, max_len: int, device) -> dict:
    """Zeroed slot table for ``max_slots`` sequences of up to ``max_len``
    positions of ``model`` (a :class:`..models.transformer.CausalLM`) on
    ``device``: ``{"layers": [{leaf: tensor}], "index": (max_slots,)
    int64 numpy}``."""
    attn = model.layers[0].self_attn
    shape = (max_slots, max_len, attn.kv_heads, attn.head_dim)

    def layer():
        out = {name: torch.zeros(shape, dtype=model.dtype, device=device)
               for name in KV_LEAVES}
        out[VALID_LEAF] = torch.zeros(shape[:2], dtype=torch.bool,
                                      device=device)
        return out

    return {"layers": [layer() for _ in model.layers],
            "index": np.zeros(max_slots, np.int64)}


def kv_cache_bytes(slots: dict) -> int:
    """Bytes the table holds on the device: exact by construction, the
    allocated tensors' own sizes (``layers x 2 x slots x len x Hkv x hd``
    in the compute dtype plus the validity masks)."""
    return sum(t.numel() * t.element_size()
               for layer in slots["layers"] for t in layer.values())


def write_slot(slots: dict, cache: dict, slot: int) -> None:
    """Write a one-row model-layout cache (``CausalLM.init_cache(1,
    max_len)`` after a prefill) into row ``slot`` of the table, in place,
    and pin the row's position to the cache's ``index``.  The whole row is
    written, so the previous occupant leaves nothing behind; the position
    is the prefill's true length (the flax engine pins it with
    ``fix_counters`` after its bucket-padded prefill)."""
    for dst, src in zip(slots["layers"], cache["layers"]):
        for name, table in dst.items():
            table[slot] = src[name][0]
    slots["index"][slot] = cache["index"]


def tick_positions(slots: dict) -> np.ndarray:
    """Each slot's position for the next decode tick, clamped into the
    table (see the module docstring)."""
    max_len = slots["layers"][0][VALID_LEAF].shape[1]
    return np.minimum(slots["index"], max_len - 1)
