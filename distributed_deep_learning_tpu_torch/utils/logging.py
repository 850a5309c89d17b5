"""Timestamped phase logging, format-compatible with the reference: a copy
of ``distributed_deep_learning_tpu/utils/logging.py``.

The reference's only observability is quote-delimited, UTC-timestamped phase
lines printed on rank 0 (``CNN/main.py:80,96,111,127``; ``verbose=rank==0``
at ``:181``), e.g.::

    "train epoch 3 begins at 1714056912.123456"
    "train epoch 3 ends at 1714056999.456 with accuracy 87.250 and loss 0.013digits"

We reproduce that exact stream (so downstream log scrapers keep working) and
add structured counters (steps/sec, examples/sec) the reference lacked.
"""

from __future__ import annotations

import json
import sys
import time
from typing import TextIO


class PhaseLogger:
    """Rank-0-gated phase logger emitting the reference's log grammar.

    ``jsonl_path`` additionally appends one machine-readable JSON object
    per event (``{"event", "t", ...fields}``) — the structured sibling of
    the reference's scrape-with-regex stream, written as the run progresses
    so a crashed run still leaves its history on disk.  JSONL recording is
    independent of ``verbose``: only the console stream is rank-0-gated,
    every process keeps its structured history.
    """

    def __init__(self, verbose: bool = True, stream: TextIO | None = None,
                 clock=time.time, jsonl_path: str | None = None):
        self.verbose = verbose
        self.stream = stream if stream is not None else sys.stdout
        self.clock = clock
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    def _emit(self, line: str) -> None:
        if self.verbose:
            # Reference prints quote-delimited lines for downstream scraping.
            print(f'"{line}"', file=self.stream, flush=True)

    def _record(self, event: str, **fields) -> None:
        if self._jsonl is not None:
            fields = {k: v for k, v in fields.items() if v is not None}
            self._jsonl.write(json.dumps(
                {"event": event, "t": self.clock(), **fields}) + "\n")
            self._jsonl.flush()

    # -- the reference grammar (CNN/main.py:80,96,111,127) -----------------
    def phase_begin(self, phase: str, epoch: int | None = None) -> float:
        t = self.clock()
        if epoch is None:
            self._emit(f"{phase} begins at {t:f}")
        else:
            self._emit(f"{phase} epoch {epoch} begins at {t:f}")
        self._record("phase_begin", phase=phase, epoch=epoch)
        return t

    def phase_end(self, phase: str, epoch: int | None = None, *,
                  accuracy: float | None = None, loss: float | None = None) -> float:
        t = self.clock()
        suffix = ""
        if accuracy is not None and loss is not None:
            suffix = f" with accuracy {accuracy:0.3f} and loss {loss:0.9f}"
        if epoch is None:
            self._emit(f"{phase} ends at {t:f}{suffix}")
        else:
            self._emit(f"{phase} epoch {epoch} ends at {t:f}{suffix}")
        self._record("phase_end", phase=phase, epoch=epoch,
                     accuracy=accuracy, loss=loss)
        return t

    # -- framework extensions ----------------------------------------------
    def metrics(self, **kv) -> None:
        parts = " ".join(f"{k}={v}" for k, v in kv.items())
        self._emit(f"metrics {parts}")
        self._record("metrics", **kv)

    def info(self, msg: str) -> None:
        self._emit(msg)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
