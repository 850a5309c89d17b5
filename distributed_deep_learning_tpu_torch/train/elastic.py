"""Elastic training: the port of
``distributed_deep_learning_tpu/train/elastic.py``.

When a step dies (a peer stops heartbeating, a runtime error, an injected
failure) :func:`fit_with_recovery` restores the last verified checkpoint
and continues; the seeded loaders replay the epoch's batch order from the
saved position, so a recovered run equals an uninterrupted one bit for
bit.  Restores go through ``restore_verified`` (a torn or bit-flipped
latest save is quarantined and the older one used), a restart loop (the
same resume point dying twice with the same error) fails fast with
:class:`RestartLoopError`, and the sentinel's ``rollback`` policy replays
with the anomalous global step in the skip set.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from distributed_deep_learning_tpu_torch.train.loop import EpochResult, fit
from distributed_deep_learning_tpu_torch.train.sentinel import AnomalyError
from distributed_deep_learning_tpu_torch.utils.checkpoint import Checkpointer
from distributed_deep_learning_tpu_torch.utils.failures import (
    FailureMonitor, WorkerFailure)
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger


class RestartLoopError(RuntimeError):
    """The same resume point died twice with the identical failure —
    replaying it further could only repeat it (deterministic bug, or a
    permanently dead peer), so elastic recovery gives up early instead of
    burning ``max_restarts`` on the loop."""


def resume_point(checkpointer: Checkpointer, step: int | None = None
                 ) -> tuple[int | None, int, int, dict | None]:
    """Decode a checkpoint (default: latest) into ``(ckpt_step,
    start_epoch, resume_batch, resume_totals)``: ``ckpt_step`` None means
    start fresh; ``resume_batch > 0`` means mid-epoch (skip that many
    batches of ``start_epoch`` and seed its totals).  A checkpoint without
    a sidecar counts its id as the completed epoch.  Pass ``step`` when
    the integrity fallback restored an older step than the latest."""
    last = checkpointer.latest_step() if step is None else step
    if last is None:
        return None, 1, 0, None
    extra = checkpointer.read_extra(last)
    if extra is None:
        return last, last + 1, 0, None
    if extra.get("epoch_complete"):
        return last, int(extra["epoch"]) + 1, 0, None
    return last, int(extra["epoch"]), int(extra["batch"]), \
        extra.get("totals")


def _merge_history(sink: list[EpochResult]) -> list[EpochResult]:
    """Cross-attempt history: keep the LAST record per (phase, epoch) — a
    phase re-run after a mid-validation failure supersedes its first
    (identical, deterministic) record."""
    seen: set = set()
    merged: list[EpochResult] = []
    for h in reversed(sink):
        key = (h.phase, h.epoch)
        if key in seen:
            continue
        seen.add(key)
        merged.append(h)
    return list(reversed(merged))


def fit_with_recovery(make_state: Callable[[], Any], train_step, eval_step,
                      loaders: Sequence, epochs: int,
                      checkpointer: Checkpointer, *,
                      logger: PhaseLogger | None = None,
                      monitor: FailureMonitor | None = None,
                      max_restarts: int = 2,
                      checkpoint_every: int | None = None,
                      sentinel=None, chaos=None, telemetry=None,
                      restore_fn=None) -> tuple[Any, list[EpochResult]]:
    """Run :func:`..loop.fit` with checkpointed restart on failure.

    ``make_state`` returns the initial state (the restore target; called
    once per attempt: the port's states are updated in place, so it puts
    the initial values back into the live one).  Failures caught:
    :class:`WorkerFailure` from the monitor, ``RuntimeError`` (what torch
    and the injection hooks raise) and transient shared-FS ``OSError``;
    after ``max_restarts`` recoveries the last error propagates.  ``checkpoint_every=N`` saves every N train steps
    and recovers from the last step boundary (loader position rides the
    checkpoint sidecar).

    * Restores go through :meth:`Checkpointer.restore_verified` — a torn
      or bit-flipped latest save is quarantined and recovery proceeds
      from the previous verified-good step, resume point included.
    * A **restart loop** — the same ``(ckpt_step, epoch, batch)`` resume
      point dying twice with the identical error — fails fast instead of
      burning every restart replaying a deterministic bug.
    * ``sentinel`` with ``policy="rollback"``: an
      :class:`..train.sentinel.AnomalyError` restores the last checkpoint
      and replays with the offending global step in the run's skip set
      (the poisoned data window is consumed, never trained).
    * The ``monitor`` is :meth:`~..utils.failures.FailureMonitor.reset`
      between attempts, so a recorded failure from the dead attempt does
      not permanently poison the retries (the replacement worker is
      expected to heartbeat again).
    * ``telemetry`` (:class:`..obs.RunTelemetry`) puts every restore in
      the ``recovery`` span, counts restarts by cause
      (``elastic_restarts{cause=...}``) and rides into :func:`..loop.fit`.
    * ``restore_fn`` swaps the restore implementation — same contract as
      :meth:`Checkpointer.restore_verified`; ``--reshard`` passes
      :func:`..reshard.restore.make_restore_fn` here so a restart on a
      different layout restores the checkpoint onto it.
    """
    logger = logger or PhaseLogger(verbose=False)
    train_loader, val_loader, test_loader = loaders
    restarts = 0
    skip_steps: set[int] = set()  # rollback policy's poisoned data windows
    prev_failure = None           # (resume point, error) of the last attempt
    sink: list[EpochResult] = []  # survives attempts
    while True:
        state = make_state()
        # restore_verified flushes in-flight async saves BEFORE reading the
        # resume point: a step save scheduled just before the failure must
        # be visible to this retry, or it would resume from an older
        # boundary and try to re-save an id that then finalises under it
        restore = restore_fn or checkpointer.restore_verified
        if telemetry is None:
            restored, ckpt_step = restore(state)
        else:
            with telemetry.timeline.span("recovery"):
                restored, ckpt_step = restore(state)
        if ckpt_step is not None:
            state = restored
            _, start_epoch, resume_batch, resume_totals = \
                resume_point(checkpointer, step=ckpt_step)
            # loud on purpose: an elastic (re)launch over an existing dir
            # silently continuing the OLD run would be the dirty-dir
            # hazard _maybe_checkpointer refuses for non-elastic runs
            at = f"epoch {start_epoch} step {resume_batch}" \
                if resume_batch else f"epoch {start_epoch}"
            logger.info(f"elastic: restored checkpoint step {ckpt_step}; "
                        f"continuing from {at}")
        else:
            start_epoch, resume_batch, resume_totals = 1, 0, None
        try:
            if monitor is not None:
                monitor.raise_if_failed()
                monitor.check()
            # fit polls the monitor before EVERY step, so a peer dying
            # mid-epoch aborts this attempt promptly rather than hanging
            # the next collective
            state, _ = fit(state, train_step, eval_step, train_loader,
                           val_loader, test_loader, epochs=epochs,
                           logger=logger, checkpointer=checkpointer,
                           start_epoch=start_epoch, monitor=monitor,
                           checkpoint_every=checkpoint_every,
                           resume_batch=resume_batch,
                           resume_totals=resume_totals, history_sink=sink,
                           sentinel=sentinel, chaos=chaos,
                           skip_steps=skip_steps or None,
                           telemetry=telemetry)
            return state, _merge_history(sink)
        except AnomalyError as e:
            if e.policy != "rollback":
                raise  # halt: clean state as of the last good step
            restarts += 1
            if restarts > max_restarts:
                raise
            if telemetry is not None:
                telemetry.registry.counter(
                    "elastic_restarts", cause="sentinel_rollback").inc()
            skip_steps.add(e.global_step)
            checkpointer.wait_until_finished()
            logger.info(f"sentinel rollback ({e}); restart "
                        f"{restarts}/{max_restarts} with global step "
                        f"{e.global_step} in the skip window")
            if monitor is not None and hasattr(monitor, "reset"):
                monitor.reset()
        except (WorkerFailure, RuntimeError, OSError) as e:
            failure = ((ckpt_step, start_epoch, resume_batch),
                       type(e).__name__, str(e))
            if failure == prev_failure:
                # deterministic bug, not a transient fault: replaying it
                # max_restarts times would reach the identical state and
                # die identically — say so now, with the evidence
                raise RestartLoopError(
                    "restart loop — same failure at the same resume point "
                    f"(checkpoint {ckpt_step}, epoch {start_epoch}, batch "
                    f"{resume_batch}) twice in a row: {type(e).__name__}: "
                    f"{e}") from e
            prev_failure = failure
            restarts += 1
            if restarts > max_restarts:
                raise
            if telemetry is not None:
                telemetry.registry.counter(
                    "elastic_restarts", cause=type(e).__name__).inc()
            # flush BEFORE reading the point for the log too, or a save
            # still in flight makes the message claim an older boundary
            # than the retry will actually use
            checkpointer.wait_until_finished()
            _, ep, b, _ = resume_point(checkpointer)
            at = f"epoch {ep} step {b}" if b else f"epoch {ep}"
            logger.info(f"recovering from failure ({type(e).__name__}: {e}); "
                        f"restart {restarts}/{max_restarts} from {at}")
            if monitor is not None and hasattr(monitor, "reset"):
                monitor.reset()
