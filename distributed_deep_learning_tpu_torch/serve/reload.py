"""Hot weight reload: publish → watch → verify → canary → promote (the
port of the JAX package's ``serve/reload.py``).

Closes the train→serve loop: a trainer publishes weights; a running
engine picks them up BETWEEN ticks with nothing captured again (the new
weights are copied into the live tensors the captured tick reads) and no
restart.

The path is defensive at every hop, mirroring the checkpoint machinery:

* **Publish** is atomic-then-commit: the ``.npz`` payload lands under a
  temp name and is renamed into place; the integrity manifest (JAX's
  schema: ``format``, ``step``, ``n_leaves`` and per-leaf CRC32 +
  shape/dtype/finiteness via :func:`..utils.checkpoint.leaf_records`) is
  written LAST as the commit marker.  The leaves are a
  :class:`..models.transformer.CausalLM` ``state_dict``'s, in order.  A torn publish
  leaves a payload without a manifest, which the watcher never sees.
* **Watch** polls the directory through the same
  :class:`..utils.failures.FlakyIOPolicy` seam the heartbeat monitor
  uses — transient I/O errors are tolerated up to a consecutive budget,
  then the watcher declares ITSELF unhealthy instead of silently going
  blind (no second flaky-IO policy).
* **Verify** recomputes every leaf record on load and compares against
  the manifest; any mismatch (bit flip, truncation, NaN) raises
  :class:`..utils.checkpoint.CheckpointCorruption` and the publication
  is QUARANTINED (renamed, never deleted — it is evidence).
* **Canary** routes a slot slice to the candidate weights
  (:meth:`..serve.engine.PagedEngine.begin_canary` — a second weight
  copy with its own captured tick, run beside the live one) and feeds
  old-vs-new argmax agreement and chosen-logprob drift into
  :mod:`..obs.window` histograms.  Good candidates PROMOTE (full swap,
  prefix index flushed); bad ones ROLL BACK: the candidate is
  quarantined and :class:`CanaryRollback` carries the ledger
  snapshot taken at canary start so the supervisor rewinds and replays
  every candidate-weight token under the stable weights.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.obs.window import WindowedHistogram
from distributed_deep_learning_tpu_torch.utils.checkpoint import (
    CheckpointCorruption, leaf_records)
from distributed_deep_learning_tpu_torch.utils.failures import FlakyIOPolicy

WEIGHTS_FORMAT = 1


def _weights_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"weights-{step:08d}.npz")


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"weights-{step:08d}.manifest.json")


def _host_leaves(params: dict) -> dict:
    """``params`` (a ``state_dict``) as host tensors, in order."""
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)))
            for k, v in params.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bf16: such a leaf travels as its raw int16 bits
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def publish_weights(directory: str, step: int, params) -> str:
    """Atomically publish one weight set for live engines to pick up.

    Payload first (temp name + rename), manifest LAST — the manifest is
    the commit marker, so a reader never sees a half-written payload.
    Leaves are stored positionally (``state_dict`` order); the manifest's
    keyed records pin the names they came from."""
    os.makedirs(directory, exist_ok=True)
    params = _host_leaves(params)
    leaves = list(params.values())
    payload = {f"leaf_{i:05d}": _to_numpy(x) for i, x in enumerate(leaves)}
    wpath = _weights_path(directory, step)
    tmp = f"{wpath}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, wpath)  # atomic on POSIX
    mpath = _manifest_path(directory, step)
    tmp = f"{mpath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"format": WEIGHTS_FORMAT, "step": step,
                   "n_leaves": len(leaves),
                   "leaves": leaf_records(params)}, f)
    os.replace(tmp, mpath)
    return wpath


def latest_published(directory: str) -> Optional[int]:
    """Highest step with BOTH payload and manifest present (a payload
    alone is an uncommitted publish in flight)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("weights-") and name.endswith(".manifest.json"):
            try:
                step = int(name[len("weights-"):-len(".manifest.json")])
            except ValueError:
                continue
            if os.path.exists(_weights_path(directory, step)):
                steps.append(step)
    return max(steps) if steps else None


def load_verified(directory: str, step: int, like):
    """Load a published weight set and verify it leaf by leaf.

    ``like`` supplies the target names, shapes and dtypes (the engine's
    ``params``, a ``state_dict``); returns a ``state_dict`` of host
    tensors.  Every leaf is checked against the manifest — CRC32 over
    raw bytes, shape, dtype, all-finite — and the whole set against the
    target geometry.  Any mismatch raises
    :class:`CheckpointCorruption`; the caller quarantines."""
    mpath = _manifest_path(directory, step)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruption(step, f"unreadable manifest: {e}")
    flat = list(like.values())
    if manifest.get("n_leaves") != len(flat):
        raise CheckpointCorruption(
            step, f"manifest records {manifest.get('n_leaves')} leaves, "
            f"engine params have {len(flat)}")
    try:
        with np.load(_weights_path(directory, step)) as z:
            arrays = [z[f"leaf_{i:05d}"] for i in range(len(flat))]
    except Exception as e:  # torn zip, bad CRC, missing member
        raise CheckpointCorruption(step, f"unreadable payload: "
                                   f"{type(e).__name__}: {e}")
    new = {}
    for name, a, arr in zip(like, flat, arrays):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if a.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        new[name] = t
    want = manifest.get("leaves", {})
    got = leaf_records(new)
    if sorted(want) != sorted(got):
        raise CheckpointCorruption(step, "manifest/payload leaf keys "
                                   "disagree")
    for key in sorted(got):
        for field in ("crc32", "shape", "dtype", "finite"):
            if got[key].get(field) != want[key].get(field):
                raise CheckpointCorruption(
                    step, f"leaf {key} {field} mismatch: payload has "
                    f"{got[key].get(field)!r}, manifest recorded "
                    f"{want[key].get(field)!r}")
        if not got[key].get("finite", True):
            raise CheckpointCorruption(step, f"leaf {key} contains "
                                       "non-finite values")
    for a, b in zip(flat, new.values()):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise CheckpointCorruption(
                step, f"leaf geometry {tuple(b.shape)}/{b.dtype} does not "
                f"match the engine's {tuple(a.shape)}/{a.dtype}")
    return new


def quarantine_weights(directory: str, step: int,
                       reason: str = "") -> Optional[str]:
    """Move a bad publication under ``<dir>/quarantine/`` — rename,
    never delete (as ``Checkpointer.quarantine`` does): the corrupt
    artifact is evidence, and the rename atomically takes it off the
    watch path so the engine never retries it."""
    qdir = os.path.join(directory, "quarantine")
    moved = None
    for src in (_weights_path(directory, step),
                _manifest_path(directory, step)):
        if not os.path.exists(src):
            continue
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, os.path.basename(src))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qdir, f"{os.path.basename(src)}.{n}")
        os.replace(src, dst)
        moved = dst
    if moved is not None and reason:
        with open(os.path.join(qdir,
                               f"weights-{step:08d}.reason.json"),
                  "w") as f:
            json.dump({"step": step, "reason": reason,
                       "quarantined_at": time.time()}, f)
    return moved


class WeightWatcher:
    """Directory poller with the shared flaky-IO tolerance seam.

    ``poll()`` returns a NEW committed step at most once (consumed
    steps are remembered); transient ``OSError`` s are tolerated up to
    the consecutive budget, after which ``healthy`` flips false and a
    latched failure explains why — same healthy/reset semantics as
    :class:`..utils.failures.FailureMonitor`."""

    def __init__(self, directory: str, io_error_tolerance: int = 3):
        self.directory = os.fspath(directory)
        self._io = FlakyIOPolicy(io_error_tolerance,
                                 what="weight-dir scan")
        self.failure: Optional[Exception] = None
        self.seen: set[int] = set()

    @property
    def healthy(self) -> bool:
        return self.failure is None

    def reset(self) -> None:
        self.failure = None
        self._io.reset()

    def poll(self) -> Optional[int]:
        if self.failure is not None:
            return None
        try:
            step = latest_published(self.directory)
            self._io.note_success()
        except OSError as e:
            self.failure = self._io.note_error(e)
            return None
        if step is None or step in self.seen:
            return None
        return step

    def mark(self, step: int) -> None:
        self.seen.add(step)


class CanaryRollback(RuntimeError):
    """A canary failed its verdict.  Carries the ledger snapshot taken
    at canary start; the supervisor truncates committed streams to it
    and replays, erasing every candidate-weight token."""

    def __init__(self, message: str, snapshot: dict):
        super().__init__(message)
        self.ledger_snapshot = snapshot


class ReloadManager:
    """Between-tick orchestration: watch → verify → canary → verdict.

    Wired into :class:`..serve.supervisor.ServeSupervisor` (which calls
    ``on_tick(report, ledger)`` after each tick commits).  ``recorder``
    (the flight recorder) is ROADMAP.md queue 1 item 14 and refused.  With
    ``canary_slots=0`` verified weights swap in directly; otherwise a
    canary runs for at least ``canary_ticks`` decode ticks and
    ``min_compare`` comparison samples, then promotes or rolls back on
    the windowed acceptance/drift signals."""

    def __init__(self, directory: str, *, canary_slots: int = 2,
                 canary_ticks: int = 8, min_compare: int = 4,
                 min_acceptance: float = 0.7,
                 max_drift_p99: float = 2.0,
                 io_error_tolerance: int = 3,
                 window_s: float = 60.0, recorder=None,
                 clock=time.monotonic):
        if canary_slots < 0:
            raise ValueError(f"canary_slots must be >= 0, got "
                             f"{canary_slots}")
        if canary_ticks < 1 or min_compare < 1:
            raise ValueError("canary_ticks and min_compare must be >= 1")
        if not 0.0 <= min_acceptance <= 1.0:
            raise ValueError(f"min_acceptance must be in [0, 1], got "
                             f"{min_acceptance}")
        if recorder is not None:
            raise NotImplementedError(
                "the flight recorder is not ported to the PyTorch engine "
                "yet (ROADMAP.md queue 1 item 14)")
        self.directory = os.fspath(directory)
        self.canary_slots = int(canary_slots)
        self.canary_ticks = int(canary_ticks)
        self.min_compare = int(min_compare)
        self.min_acceptance = float(min_acceptance)
        self.max_drift_p99 = float(max_drift_p99)
        self._clock = clock
        self.watcher = WeightWatcher(self.directory, io_error_tolerance)
        # windowed comparison signals (obs/window): agreement is a 0/1
        # indicator stream, drift is |Δ logprob| of the chosen token
        self.h_accept = WindowedHistogram(window_s, lo=1e-3, hi=2.0,
                                          clock=clock)
        self.h_drift = WindowedHistogram(window_s, lo=1e-6, hi=1e3,
                                         clock=clock)
        self._candidate = None          # (step, params) under canary
        self._snapshot: Optional[dict] = None
        self._ticks_active = 0
        self._agree = 0
        self._compared = 0
        self._nonfinite = 0
        self._drift_sum = 0.0
        self.swaps = 0
        self.rollbacks = 0
        self.rejected = 0
        self.events: list[dict] = []

    # --- canary feed (engine observe hook) --------------------------------
    def _observe(self, *, agree: bool, drift: float, finite: bool,
                 now: float) -> None:
        self._compared += 1
        self._agree += int(agree)
        self._nonfinite += int(not finite)
        d = float(drift) if np.isfinite(drift) else self.h_drift._hi
        self._drift_sum += d
        t = self._clock()
        self.h_accept.observe(1.0 if agree else 1e-3, t)
        self.h_drift.observe(max(d, 1e-6), t)

    def _reset_canary_counters(self) -> None:
        self._ticks_active = 0
        self._agree = self._compared = self._nonfinite = 0
        self._drift_sum = 0.0

    def _note(self, action: str, step: int, **fields) -> None:
        self.events.append({"action": action, "step": step, **fields})

    # --- supervisor hook --------------------------------------------------
    def on_tick(self, report, ledger) -> None:
        eng = report.engine
        if self._candidate is None:
            self._maybe_start(eng, ledger, report)
            return
        step, params = self._candidate
        if getattr(eng, "_canary", None) is None:
            # the engine warm-restarted mid-canary (containment wiped
            # its canary state): re-arm against the fresh engine with a
            # fresh rollback anchor
            self._reset_canary_counters()
            self._snapshot = ledger.snapshot()
            eng.begin_canary(params, self._pick_slots(eng),
                             observe=self._observe)
            self._note("canary_rearm", step)
            return
        if report.kind != "decode":
            return
        self._ticks_active += 1
        if (self._ticks_active < self.canary_ticks
                or self._compared < self.min_compare):
            return
        self._verdict(eng, step)

    def _pick_slots(self, eng) -> tuple:
        n = min(self.canary_slots, eng.max_slots - 1)
        return tuple(range(n))

    def _maybe_start(self, eng, ledger, report) -> None:
        step = self.watcher.poll()
        if step is None:
            return
        self.watcher.mark(step)
        try:
            params = load_verified(self.directory, step, like=eng.params)
        except CheckpointCorruption as e:
            quarantine_weights(self.directory, step, str(e))
            self.rejected += 1
            self._note("reject", step, detail=str(e))
            return
        if self.canary_slots == 0 or not hasattr(eng, "begin_canary"):
            eng.swap_params(params)
            self.swaps += 1
            self._note("promote", step, canary=False)
            return
        self._reset_canary_counters()
        self._snapshot = ledger.snapshot()
        eng.begin_canary(params, self._pick_slots(eng),
                         observe=self._observe)
        self._candidate = (step, params)
        self._note("canary_begin", step,
                   slots=list(self._pick_slots(eng)),
                   anchor_tokens=sum(self._snapshot.values()))

    def _verdict(self, eng, step: int) -> None:
        acceptance = self._agree / self._compared
        drift_p99 = self.h_drift.percentile(99, self._clock())
        mean_drift = self._drift_sum / self._compared
        healthy = (self._nonfinite == 0
                   and acceptance >= self.min_acceptance
                   and drift_p99 <= self.max_drift_p99)
        summary = eng.end_canary(promote=healthy)
        verdict = dict(acceptance=acceptance, drift_p99=drift_p99,
                       mean_drift=mean_drift,
                       nonfinite=self._nonfinite,
                       compared=self._compared,
                       ticks=self._ticks_active,
                       engine_summary=summary)
        snapshot, self._snapshot = self._snapshot, None
        self._candidate = None
        if healthy:
            self.swaps += 1
            self._note("promote", step, canary=True, **verdict)
            return
        self.rollbacks += 1
        quarantine_weights(
            self.directory, step,
            f"canary rollback: acceptance {acceptance:.3f} (min "
            f"{self.min_acceptance}), drift p99 {drift_p99:.3g} (max "
            f"{self.max_drift_p99}), nonfinite {self._nonfinite}")
        self._note("rollback", step, dump=None, **verdict)
        raise CanaryRollback(
            f"canary step {step} rolled back (acceptance "
            f"{acceptance:.3f}, drift p99 {drift_p99:.3g}, nonfinite "
            f"{self._nonfinite}); replaying from the pre-canary anchor",
            snapshot or {})

    def stats(self) -> dict:
        now = self._clock()
        return {
            "watch_dir": self.directory,
            "watcher_healthy": self.watcher.healthy,
            "watcher_failure": (str(self.watcher.failure)
                                if self.watcher.failure else None),
            "steps_seen": sorted(self.watcher.seen),
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "rejected": self.rejected,
            "canary_active": self._candidate is not None,
            "events": self.events,
            "signals": {
                "accept_window_count": self.h_accept.count(now),
                "accept_window_rate_per_s": self.h_accept.rate(now),
                "drift_p50": self.h_drift.percentile(50, now),
                "drift_p99": self.h_drift.percentile(99, now),
            },
        }
