"""The port's recorded measurements: the counterpart of
``distributed_deep_learning_tpu/utils/bench_records.py`` under the port's
own keys.

The JAX package keeps its TPU figures in ``bench_baseline.json`` under
``tpu:*`` keys; none of them applies to a card, and this module never
reads that file.  The port's records live in their own JSON file
(``build/torch_bench_records.json`` at the repo root, or the path in
``DDL_TORCH_BENCH_RECORDS``), under ``cuda:*`` keys, and each value is
one measured on a card: the flash-against-dense ratio that an ``--attention
auto`` gate would read, and the best flash tile sizes of a sweep.
"""

from __future__ import annotations

import json
import os

#: flash-vs-dense forward+backward step-time ratio at the bench micro
#: shape (B 4, T 2048, H 8, D 64, bf16); > 1 means flash is faster
FLASH_GATE_KEY = "cuda:flash_speedup_T2048_D64"

#: best measured (block_q, block_k) of a flash tile sweep on the card
FLASH_BLOCKS_KEY = "cuda:flash_best_blocks"


def records_path() -> str:
    """The records file (see the module docstring)."""
    env = os.environ.get("DDL_TORCH_BENCH_RECORDS")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "build", "torch_bench_records.json")


def read_records() -> dict:
    try:
        with open(records_path()) as f:
            records = json.load(f)
    except (OSError, ValueError):
        return {}
    return records if isinstance(records, dict) else {}


def read_flash_speedup() -> float | None:
    """Last recorded flash-vs-dense ratio; None when never measured."""
    v = read_records().get(FLASH_GATE_KEY)
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


def record_flash_speedup(value: float) -> None:
    """Persist the latest measured ratio (latest wins)."""
    _update({FLASH_GATE_KEY: round(float(value), 4)})


def read_flash_blocks() -> tuple[int, int] | None:
    """Best measured (block_q, block_k); None when never swept or when
    the stored value is malformed."""
    v = read_records().get(FLASH_BLOCKS_KEY)
    if not isinstance(v, (list, tuple)) or len(v) < 2:
        return None
    try:
        bq, bk = int(v[0]), int(v[1])
        return (bq, bk) if bq > 0 and bk > 0 else None
    except (TypeError, ValueError):
        return None


def record_flash_blocks(block_q: int, block_k: int) -> None:
    _update({FLASH_BLOCKS_KEY: [int(block_q), int(block_k)]})


def _update(kv: dict) -> None:
    records = read_records()
    records.update(kv)
    path = records_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(records, f, indent=1)
    except OSError:
        pass
