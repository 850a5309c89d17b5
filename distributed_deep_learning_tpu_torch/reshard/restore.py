"""The resharding restore: verified checkpoint -> any target layout.
The port of ``distributed_deep_learning_tpu/reshard/restore.py``.

Decision tree per candidate step (newest first, same fallback-and-
quarantine chain as ``Checkpointer.restore_verified``):

* no topology manifest -> **legacy**: warn, restore as same-topology,
  never quarantine (pre-reshard run directories stay resumable);
* saved topology == target topology -> plain verified restore;
* different topology -> **chunked** restore (each rank maps the one
  checkpoint file and copies only its own part of each leaf to its
  device, in pieces: :mod:`.redistribute`) with a **gather** fallback
  (each whole leaf copied to the device, then split there) when the
  mapped read fails.  The port's checkpoint holds every leaf whole, so
  both give the bytes a same-topology restore gives.

A *geometry* mismatch (the checkpoint's leaf shapes don't match the
target state — wrong model, not wrong mesh) raises
:class:`ReshardGeometryError` immediately instead of quarantining: the
checkpoint is fine, the request is wrong.
"""

from __future__ import annotations

import sys
import time

from distributed_deep_learning_tpu_torch.reshard import manifest as _manifest
from distributed_deep_learning_tpu_torch.reshard.redistribute import (
    RedistributeStats, tree_shardings)
from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    CheckpointCorruption


class ReshardGeometryError(RuntimeError):
    """The checkpoint's leaf geometry doesn't match the restore target —
    a model mismatch, not a topology mismatch; nothing is quarantined."""


def _check_geometry(ckpt, step: int, target) -> None:
    """Compare the integrity manifest's per-leaf shapes of the model's
    tensors (``/params/...``) against the target's whole shapes; a legacy
    manifest checks nothing."""
    from distributed_deep_learning_tpu_torch.parallel.shards import \
        whole_shape

    record = ckpt.read_manifest(step) or {}
    saved = {k: v for k, v in (record.get("leaves") or {}).items()
             if k.startswith("/params/")}
    if not saved:
        return
    params = tree_shardings(target)
    actual = {f"/params/{k}": whole_shape(params[k]) if k in params
              else tuple(v.shape)
              for k, v in target.model.state_dict().items()}
    bad = []
    for key, rec in saved.items():
        if rec.get("crc32") is None or "shape" not in rec:
            continue
        shape = actual.get(key)
        if shape is None:
            bad.append(f"{key} missing from target")
            continue
        if tuple(rec["shape"]) != tuple(shape):
            bad.append(f"{key}: saved {tuple(rec['shape'])} vs "
                       f"target {tuple(shape)}")
    if bad:
        raise ReshardGeometryError(
            f"checkpoint step {step} cannot reshard onto this state — "
            f"leaf geometry differs ({'; '.join(bad[:4])}"
            f"{'; ...' if len(bad) > 4 else ''})")


def restore_resharded(ckpt, target, *, mesh, step=None,
                      method: str = "auto", logger=None):
    """Restore the newest usable checkpoint at/below ``step`` into
    ``target`` (in place), laid out over a mesh of sizes ``mesh``.

    Returns ``(state, step, info)`` — or ``(None, None, info)`` when no
    checkpoint survives (caller starts fresh).  ``info['mode']`` is one of
    ``legacy | same | chunked | gather``; cross-topology restores also
    carry source/target descriptions, timing and what was moved
    (``redistribute``: leaves, bytes this rank copied to its device).
    ``method`` forces a path (``chunked``/``gather``); ``auto`` tries
    chunked and falls back.  Every rank calls it.
    """

    def log(msg: str) -> None:
        if logger is not None:
            logger.info(msg)
        else:
            print(msg, file=sys.stderr, flush=True)

    ckpt.wait_until_finished()
    current = _manifest.of_placement(target, mesh)
    info: dict = {"mode": None}

    candidates = sorted(ckpt.all_steps(), reverse=True)
    if step is not None:
        candidates = [s for s in candidates if s <= step]
    for s in candidates:
        topo = ckpt.read_topology(s)
        if topo is not None:
            # fail fast on a model mismatch — NOT a quarantine offence
            _check_geometry(ckpt, s, target)
        try:
            if topo is None:
                log(f"reshard: checkpoint step {s} has no topology "
                    "manifest (pre-reshard save); restoring as "
                    "same-topology (legacy)")
                return ckpt.restore(target, step=s), s, {"mode": "legacy"}
            if _manifest.same_topology(topo, current):
                return ckpt.restore(target, step=s), s, {"mode": "same"}

            info = {"mode": None, "source": topo.describe(),
                    "target": current.describe()}
            start = time.perf_counter()
            restored = None
            stats = RedistributeStats()
            if method in ("auto", "chunked"):
                try:
                    restored = ckpt.restore(target, step=s,
                                            method="chunked", stats=stats)
                    info["mode"] = "chunked"
                except CheckpointCorruption:
                    raise  # real corruption: quarantine-and-fall-back
                except Exception as exc:
                    if method == "chunked":
                        raise
                    log("reshard: sliced on-disk restore unavailable "
                        f"({type(exc).__name__}: {exc}); "
                        "host-gather fallback")
                    stats = RedistributeStats()
            if restored is None:
                restored = ckpt.restore(target, step=s, method="gather",
                                        stats=stats)
                info["mode"] = "gather"
            stats.seconds = time.perf_counter() - start
            info["redistribute"] = stats.to_dict()
            info["seconds"] = round(stats.seconds, 4)
            log(f"reshard: restored step {s} across topologies "
                f"[{info['source']} -> {info['target']}] via "
                f"{info['mode']} in {info['seconds']}s")
            return restored, s, info
        except ReshardGeometryError:
            raise
        except Exception as exc:
            print(f"reshard: step {s} unusable "
                  f"({type(exc).__name__}: {exc}); quarantining and "
                  "falling back", file=sys.stderr, flush=True)
            ckpt.quarantine(s, reason=f"{type(exc).__name__}: {exc}")
    return None, None, {"mode": None}


def make_restore_fn(ckpt, mesh, *, method: str = "auto", logger=None):
    """A drop-in replacement for ``Checkpointer.restore_verified`` bound
    to a target layout — the hook ``fit_with_recovery`` calls on every
    (re)start, so elastic restarts reshard transparently."""

    def restore_fn(target, step=None):
        state, used, info = restore_resharded(
            ckpt, target, mesh=mesh, step=step, method=method,
            logger=logger)
        restore_fn.last_info = info
        return state, used

    restore_fn.last_info = {}
    return restore_fn


__all__ = ["ReshardGeometryError", "restore_resharded", "make_restore_fn"]
