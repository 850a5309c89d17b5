"""Telemetry export: JSONL event stream + Prometheus text exposition,
copied from the JAX package's ``obs/export.py``.

The JSONL stream extends ``PhaseLogger``'s sidecar grammar — every line
is ``{"event": <name>, "t": <monotonic seconds>, **fields}`` — so a
run's obs stream and its phase log speak the same dialect and a single
reader (:func:`read_events`) serves both.  Obs-specific events:

* ``obs_goodput``  — a goodput breakdown (``scope``: phase label or
  ``"run"``), fields from ``Timeline.goodput()``.
* ``obs_mfu``      — an ``mfu.mfu_record`` dict.
* ``obs_snapshot`` — a full ``MetricsRegistry.snapshot()``.
* ``obs_serve``    — serve engine stats (latency percentiles included).

:func:`prometheus_text` renders a registry snapshot in the Prometheus
text exposition format (cumulative ``le`` buckets, ``_sum``/``_count``)
so a scrape endpoint or a file-based textfile collector can serve it
without any new dependency.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Iterator


class EventWriter:
    """Line-buffered JSONL appender in the PhaseLogger sidecar grammar.

    Safe to construct with ``path=None`` (all writes become no-ops), so
    call sites never need their own ``if telemetry`` guards.

    ``max_bytes`` caps the live file: when an emit pushes it past the
    cap the file ROTATES — ``path`` is renamed to ``path.1`` (older
    generations shifting to ``path.2`` … ``path.{keep}``, the oldest
    dropped) and a fresh ``path`` is opened, so a multi-hour run holds
    at most ``(keep + 1) * max_bytes`` of sidecar.  Rotation happens on
    line boundaries — every generation is a well-formed JSONL file in
    the unchanged grammar.  ``fsync_on_rollover`` additionally fsyncs
    the closing generation before the rename, so a power cut can only
    lose lines from the CURRENT generation.
    """

    def __init__(self, path: str | None, clock=time.perf_counter,
                 max_bytes: int | None = None, keep: int = 3,
                 fsync_on_rollover: bool = False) -> None:
        self.path = path
        self.clock = clock
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.keep = max(1, int(keep))
        self.fsync_on_rollover = fsync_on_rollover
        self.rollovers = 0
        self._fh = open(path, "a", buffering=1) if path else None
        self._bytes = os.path.getsize(path) if path else 0

    def emit(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        rec = {"event": event, "t": self.clock(), **fields}
        # allow_nan=False because json would otherwise emit the literal
        # ``NaN`` — valid to json.loads but poison to strict readers
        # (jq, browsers); _json_default cannot intercept floats (they
        # are natively serializable), so non-finite floats route through
        # the ValueError path and get scrubbed to None.
        try:
            line = json.dumps(rec, default=_json_default, allow_nan=False)
        except ValueError:
            line = json.dumps(_scrub(rec), default=_json_default,
                              allow_nan=False)
        self._fh.write(line + "\n")
        if self.max_bytes is not None:
            self._bytes += len(line) + 1
            if self._bytes >= self.max_bytes:
                self._rollover()

    def _rollover(self) -> None:
        self._fh.flush()
        if self.fsync_on_rollover:
            os.fsync(self._fh.fileno())
        self._fh.close()
        for gen in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{gen}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{gen + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", buffering=1)
        self._bytes = 0
        self.rollovers += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _scrub(o: Any):
    """Recursively replace non-finite floats with None (cold path: only
    runs when a record actually contains one)."""
    if isinstance(o, float):
        return o if math.isfinite(o) else None
    if isinstance(o, dict):
        return {k: _scrub(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_scrub(v) for v in o]
    return o


def _json_default(o: Any):
    """Last-resort encoder: inf/nan → None (JSON has no inf), arrays and
    numpy scalars → python."""
    if isinstance(o, float):
        return None if not math.isfinite(o) else o
    tolist = getattr(o, "tolist", None)
    if tolist is not None:
        return tolist()
    item = getattr(o, "item", None)
    if item is not None:
        return item()
    return str(o)


def read_events(path: str, event: str | None = None) -> Iterator[dict]:
    """Yield event dicts from a JSONL sidecar (PhaseLogger or obs),
    optionally filtered by event name.  Tolerates a torn final line
    (a killed run mid-write) by skipping undecodable lines."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if event is None or rec.get("event") == event:
                yield rec


def read_rotated(path: str, event: str | None = None) -> Iterator[dict]:
    """Like :func:`read_events` but chaining rotated generations oldest
    first (``path.N`` … ``path.1``, then the live ``path``), so a
    size-capped run's whole retained history reads as one stream."""
    gen = 1
    older: list[str] = []
    while os.path.exists(f"{path}.{gen}"):
        older.append(f"{path}.{gen}")
        gen += 1
    for p in reversed(older):
        yield from read_events(p, event)
    if os.path.exists(path):
        yield from read_events(path, event)


def _prom_name(key: str) -> tuple[str, str]:
    """Split a registry key ``name{a=b}`` into (metric name, label part
    incl. braces or empty), quoting label values per the exposition
    format."""
    if "{" not in key:
        return key, ""
    name, _, rest = key.partition("{")
    inner = rest.rstrip("}")
    quoted = ",".join(
        f'{k}="{v}"' for k, _, v in
        (pair.partition("=") for pair in inner.split(","))
    )
    return name, "{" + quoted + "}"


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()`` in Prometheus text
    format.  Histogram buckets are emitted cumulatively with ``le``
    upper bounds plus the ``+Inf`` bucket, ``_sum`` and ``_count``."""
    lines: list[str] = []
    for key, v in sorted(snapshot.get("counters", {}).items()):
        name, labels = _prom_name(key)
        # classic text format: the TYPE line names the sample family
        # (name_total), not the bare metric — a mismatch reads as
        # untyped to strict parsers
        lines.append(f"# TYPE {name}_total counter")
        lines.append(f"{name}_total{labels} {_fmt(v)}")
    for key, v in sorted(snapshot.get("gauges", {}).items()):
        name, labels = _prom_name(key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {_fmt(v)}")
    for key, h in sorted(snapshot.get("histograms", {}).items()):
        name, labels = _prom_name(key)
        base = labels[1:-1] if labels else ""
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            lab = f'{base},le="{_fmt(float(bound))}"' if base \
                else f'le="{_fmt(float(bound))}"'
            lines.append(f"{name}_bucket{{{lab}}} {cum}")
        lab = f'{base},le="+Inf"' if base else 'le="+Inf"'
        lines.append(f"{name}_bucket{{{lab}}} {h['count']}")
        lines.append(f"{name}_sum{labels} {_fmt(h['sum'])}")
        lines.append(f"{name}_count{labels} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
