"""Epoch loop with the reference's phase/metric semantics: the port of
``distributed_deep_learning_tpu/train/loop.py`` with its checkpointing,
resume, failure monitor, anomaly sentinel, chaos hooks and telemetry.

Per epoch a train phase and a validation phase, then one final test
phase; accuracy = argmax matches × 100 / sites, and the logged loss keeps
the reference's Σ(batch-mean loss) / Σ(sites) formula (quirk Q9).  The
steps' metric tensors stay on the device during a phase and are fetched
once at its end, with each train step's loss and time: on the card the
step times come from CUDA events recorded between steps, so timing adds
no host sync either.

With a checkpointer the state is saved after every epoch, and with
``checkpoint_every=N`` also every N train steps, with the loader position
and the phase's running totals in the sidecar; ids are global step
numbers then, epoch numbers otherwise.  Resuming mid-epoch, the seeded
loader replays the epoch's batch order and skips the first
``resume_batch`` batches without gathering them, so the continuation is
the uninterrupted run's.  Saves are asynchronous (``wait=False``); the
loop waits for the last before the test phase, where JAX's waits.

A ``monitor`` (:class:`..utils.failures.FailureMonitor`) is polled before
every step, so a dead peer raises promptly.  Under the anomaly sentinel
(:mod:`.sentinel`) the loop reads each step's verdict one step late (the
next step is already queued) and raises :class:`.sentinel.AnomalyError`
under ``rollback``/``halt``; ``skip`` counts the contained steps and
logs them at the phase's end.  A ``chaos`` plan
(:class:`..utils.chaos.ChaosPlan`) rewrites or fails planned batches, and
``skip_steps`` (global step ids) are consumed without training (the
rollback replay's poisoned window).  The ``DDL_INJECT_FAILURE`` and
``DDL_INJECT_STEP_FAILURE`` hooks (:mod:`..utils.failures`) fire at the
start of an epoch and after a step.

``telemetry`` (:class:`..obs.RunTelemetry`) records JAX's spans: per
step ``data_wait`` around the loader, ``dispatch`` around the step call
(a step function's first call as ``compile``) and the memory tracker's
subsampled poll; ``device_sync`` around a phase's one fetch;
``checkpoint`` around every save; a goodput rollup and the MFU totals
per train phase; the sentinel's contained steps as a counter and a
flight-recorder trip.  With ``telemetry=None`` the loop is the one
without it: no clock is read and nothing is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from distributed_deep_learning_tpu_torch.train.state import TrainState
from distributed_deep_learning_tpu_torch.utils.failures import (
    maybe_inject_failure, maybe_inject_step_failure)
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger


@dataclasses.dataclass
class EpochResult:
    phase: str
    epoch: int | None
    accuracy: float
    loss: float
    seconds: float
    examples: int
    #: train phases: each step's batch loss and its time (device time
    #: between step boundaries on the card, host time on the CPU)
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_seconds: list[float] = dataclasses.field(default_factory=list)

    @property
    def examples_per_sec(self) -> float:
        return self.examples / self.seconds if self.seconds > 0 else 0.0


class _StepClock:
    """Marks step boundaries: CUDA events on the card (read after the
    phase's one sync), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _sum_totals(metrics, init_totals=None):
    """Fetch and sum the steps' metrics (one host sync), plus the totals
    restored for a resumed phase; returns ``(totals, host tensors)``."""
    totals = {"loss": 0.0, "correct": 0, "count": 0}
    host = {}
    if metrics:
        stacked = {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
        host = {k: v.cpu() for k, v in stacked.items()}
        # in f64: a resumed phase adds its restored partial sum in f64,
        # so the whole and the resumed phase sum alike
        totals = {k: (v.double() if v.is_floating_point() else v).sum()
                  .item() for k, v in host.items()}
    # the union of keys: a sidecar saved before a metric existed (the
    # sentinel's ``anomaly``) must not erase it from the totals
    for k, v in (init_totals or {}).items():
        totals[k] = totals.get(k, 0) + v
    return totals, host


def _run_phase(step_fn, state, loader, *, train: bool, skip: int = 0,
               init_totals=None, on_step=None, monitor=None,
               batch_hook=None, skip_pred=None, check_anomaly=None,
               telemetry=None):
    """Drive one phase; returns ``(state, totals, step_losses,
    step_seconds)`` with one host sync at the end.  The first ``skip``
    batches are skipped (mid-epoch resume; ``init_totals`` holds what
    they added).  ``on_step(batch_number, state, totals_fn)`` runs after
    each train step; ``totals_fn()`` syncs only when called.
    ``monitor.raise_if_failed()`` runs before every batch;
    ``batch_hook(b, x, y) -> (x, y)`` may replace or fail a train batch,
    ``skip_pred(b)`` consumes one untrained, and ``check_anomaly(b,
    metrics)`` reads step ``b``'s metrics after step ``b + 1`` is
    queued (and the last step's at the end).  ``telemetry`` records the
    module docstring's spans."""
    batches, step = loader.iter_batches(skip), step_fn
    if telemetry is not None:
        batches = _waited(batches, telemetry.timeline)
        step = _observed(step_fn, telemetry, train)
    metrics, clock, pending = [], None, None
    for i, (x, y) in enumerate(batches, start=skip + 1):
        if monitor is not None:
            monitor.raise_if_failed()
        if train:
            if skip_pred is not None and skip_pred(i):
                continue
            if batch_hook is not None:
                x, y = batch_hook(i, x, y)
            if clock is None:
                clock = _StepClock(x.device)
            state, m = step(state, x, y)
            clock.mark()
        else:
            m = step(state, x, y)
        metrics.append(m)
        if check_anomaly is not None:
            if pending is not None:
                check_anomaly(*pending)
            pending = (i, m)
        if on_step is not None:
            on_step(i, state,
                    lambda: _sum_totals(metrics, init_totals)[0])
    if pending is not None:
        check_anomaly(*pending)
    with (telemetry.timeline.span("device_sync") if telemetry is not None
          else contextlib.nullcontext()):
        totals, host = _sum_totals(metrics, init_totals)
        seconds = clock.seconds() if clock else []
    losses = host["loss"].tolist() if train and host else []
    return state, totals, losses, seconds


def _waited(batches, tl):
    """``batches`` with the host's wait for each in a ``data_wait``
    span."""
    it = iter(batches)
    while True:
        t = tl.clock()
        try:
            batch = next(it)
        except StopIteration:
            return
        tl.add("data_wait", tl.clock() - t)
        yield batch


def _observed(step_fn, telemetry, train: bool):
    """``step_fn`` with its call in a ``dispatch`` span (its first call
    a ``compile`` span, and the first train call under the FLOP counter
    when the telemetry counts FLOPs), a train step counted and the
    memory tracker polled on its cadence."""
    tl = telemetry.timeline

    def step(*args):
        kind = telemetry.dispatch_kind(step_fn)
        t = tl.clock()
        if train and telemetry.counts_flops(kind):
            out = telemetry.measure_flops(step_fn, *args)
        else:
            out = step_fn(*args)
        tl.add(kind, tl.clock() - t)
        if train:
            tl.step()
            telemetry.memory.on_step()
        return out

    return step


def _result(phase: str, epoch: int | None, totals, t0: float, t1: float,
            losses=(), seconds=()) -> EpochResult:
    counter = int(totals["count"]) or 1
    return EpochResult(
        phase=phase, epoch=epoch,
        # reference formulas (CNN/main.py:94-95): acc×100/samples,
        # Σ(batch-mean loss)/samples (Q9)
        accuracy=float(totals["correct"]) * 100.0 / counter,
        loss=float(totals["loss"]) / counter,
        seconds=t1 - t0, examples=int(totals["count"]),
        step_losses=list(losses), step_seconds=list(seconds))


def fit(state: TrainState, train_step, eval_step, train_loader, val_loader,
        test_loader, epochs: int, logger: PhaseLogger | None = None, *,
        checkpointer=None, start_epoch: int = 1, monitor=None,
        checkpoint_every: int | None = None, resume_batch: int = 0,
        resume_totals: dict | None = None,
        history_sink: list | None = None, sentinel=None, chaos=None,
        skip_steps=None, telemetry=None
        ) -> tuple[TrainState, list[EpochResult]]:
    """Drive the epoch loop (see :func:`_fit`), adding JAX's OOM
    postmortem: when the card runs out of memory and the telemetry has a
    flight recorder, the memory tracker's watermarks and the largest
    state tensors are recorded and the recorder trips before the error
    propagates."""
    try:
        return _fit(state, train_step, eval_step, train_loader, val_loader,
                    test_loader, epochs, logger,
                    checkpointer=checkpointer, start_epoch=start_epoch,
                    monitor=monitor, checkpoint_every=checkpoint_every,
                    resume_batch=resume_batch, resume_totals=resume_totals,
                    history_sink=history_sink, sentinel=sentinel,
                    chaos=chaos, skip_steps=skip_steps, telemetry=telemetry)
    except Exception as err:
        if telemetry is not None and telemetry.recorder is not None:
            from distributed_deep_learning_tpu_torch.obs import \
                memory as obs_memory

            if obs_memory.is_oom_error(err):
                top = []
                try:
                    top = obs_memory.top_leaves(state, n=10)
                except Exception:
                    pass   # the postmortem must never mask the OOM
                obs_memory.record_oom_postmortem(
                    telemetry.recorder, error=err, top_buffers=top,
                    watermarks=telemetry.memory.timeline, context="train")
        raise


def _fit(state: TrainState, train_step, eval_step, train_loader, val_loader,
         test_loader, epochs: int, logger: PhaseLogger | None = None, *,
         checkpointer=None, start_epoch: int = 1, monitor=None,
         checkpoint_every: int | None = None, resume_batch: int = 0,
         resume_totals: dict | None = None,
         history_sink: list | None = None, sentinel=None, chaos=None,
         skip_steps=None, telemetry=None
         ) -> tuple[TrainState, list[EpochResult]]:
    """Drive the epoch loop from ``start_epoch``; returns the final state
    and every phase's :class:`EpochResult` in order (train, validation
    per epoch, then test).  The log lines follow the reference's grammar.
    ``checkpointer`` (:class:`..utils.checkpoint.Checkpointer`) saves as
    the module docstring says; ``resume_batch``/``resume_totals`` (from
    :func:`..elastic.resume_point`) resume inside ``start_epoch``.
    ``history_sink`` (a list) receives every result as it is made, so a
    caller that catches a failure keeps the finished phases
    (:func:`..elastic.fit_with_recovery`).  ``sentinel``
    (:class:`.sentinel.SentinelConfig`, the one ``train_step`` was built
    with) selects the policy; ``monitor``, ``chaos``, ``skip_steps`` and
    ``telemetry`` are the module docstring's."""
    logger = logger or PhaseLogger(verbose=False)
    history: list[EpochResult] = [] if history_sink is None \
        else history_sink
    spe = len(train_loader)                  # steps per epoch
    if start_epoch > epochs + 1:
        logger.info(
            f"checkpoint resume point (epoch {start_epoch - 1}) is past "
            f"epochs={epochs}; nothing left to train — running the final "
            "test only (rerun with more -e epochs to continue)")
        start_epoch = epochs + 1
    if checkpointer is not None and start_epoch <= epochs:
        last = checkpointer.latest_step()
        final_id = epochs * spe if checkpoint_every else epochs
        if last is not None and last >= final_id:
            raise ValueError(
                f"existing checkpoint id {last} >= this run's final id "
                f"{final_id}: saves could never advance past it (the "
                "directory was written with a different --checkpoint-every "
                "or batch size) — use a fresh --checkpoint-dir or the "
                "original flags")
    enforce = sentinel is not None and sentinel.policy in ("rollback",
                                                           "halt")
    for epoch in range(start_epoch, epochs + 1):   # the reference counts
        maybe_inject_failure(epoch)                # from 1
        train_loader.set_epoch(epoch)
        skip = resume_batch if epoch == start_epoch else 0
        init_totals = resume_totals if epoch == start_epoch else None

        def on_step(b, st, totals_fn, _epoch=epoch):
            gstep = (_epoch - 1) * spe + b
            maybe_inject_step_failure(gstep)
            if checkpointer is not None and checkpoint_every \
                    and b % checkpoint_every == 0 and b < spe:
                ck0 = telemetry.timeline.clock() if telemetry else None
                checkpointer.save(
                    gstep, st, wait=False,
                    extra={"epoch": _epoch, "batch": b,
                           "epoch_complete": False,
                           "totals": {k: float(v)
                                      for k, v in totals_fn().items()}})
                if telemetry is not None:
                    telemetry.timeline.add(
                        "checkpoint", telemetry.timeline.clock() - ck0)

        batch_hook = skip_pred = check_anomaly = None
        if chaos is not None:
            def batch_hook(b, x, y, _epoch=epoch):
                return chaos.batch_hook((_epoch - 1) * spe + b, x, y)
        if skip_steps:
            def skip_pred(b, _epoch=epoch):
                return (_epoch - 1) * spe + b in skip_steps
        if enforce:
            def check_anomaly(b, m, _epoch=epoch):
                if float(m["anomaly"]):
                    from distributed_deep_learning_tpu_torch.train.sentinel \
                        import AnomalyError

                    raise AnomalyError((_epoch - 1) * spe + b,
                                       sentinel.policy,
                                       int(float(m["anomaly_code"])))

        t0 = logger.phase_begin("train", epoch)
        phase_mark = telemetry.timeline.snapshot() if telemetry else None
        state, totals, losses, secs = _run_phase(
            train_step, state, train_loader, train=True, skip=skip,
            init_totals=init_totals, on_step=on_step, monitor=monitor,
            batch_hook=batch_hook, skip_pred=skip_pred,
            check_anomaly=check_anomaly, telemetry=telemetry)
        t1 = logger.clock()
        if sentinel is not None and totals.get("anomaly"):
            logger.info(f"sentinel: contained {int(totals['anomaly'])} "
                        f"anomalous step(s) in epoch {epoch} "
                        f"(policy={sentinel.policy})")
        res = _result("train", epoch, totals, t0, t1, losses, secs)
        if telemetry is not None:
            _observe_train_phase(telemetry, epoch, totals, res, sentinel,
                                 phase_mark)
        logger.phase_end("train", epoch, accuracy=res.accuracy, loss=res.loss)
        logger.metrics(phase="train", epoch=epoch,
                       examples_per_sec=round(res.examples_per_sec, 1),
                       examples=res.examples)
        history.append(res)

        t0 = logger.clock()
        _, totals, _, _ = _run_phase(eval_step, state, val_loader,
                                     train=False, monitor=monitor,
                                     telemetry=telemetry)
        t1 = logger.clock()
        res = _result("validation", epoch, totals, t0, t1)
        # the reference prints only the validation end line
        logger.phase_end("validation", epoch, accuracy=res.accuracy,
                         loss=res.loss)
        history.append(res)
        if checkpointer is not None:
            ck0 = telemetry.timeline.clock() if telemetry else None
            checkpointer.save(epoch * spe if checkpoint_every else epoch,
                              state, wait=False,
                              extra={"epoch": epoch, "batch": spe,
                                     "epoch_complete": True})
            if telemetry is not None:
                telemetry.timeline.add(
                    "checkpoint", telemetry.timeline.clock() - ck0)

    if checkpointer is not None:
        if telemetry is None:
            checkpointer.wait_until_finished()
        else:
            with telemetry.timeline.span("checkpoint"):
                checkpointer.wait_until_finished()
    t0 = logger.clock()
    _, totals, _, _ = _run_phase(eval_step, state, test_loader, train=False,
                                 telemetry=telemetry)
    t1 = logger.clock()
    res = _result("test", None, totals, t0, t1)
    logger.phase_end("test", accuracy=res.accuracy, loss=res.loss)
    history.append(res)
    return state, history


def _observe_train_phase(telemetry, epoch, totals, res, sentinel,
                         phase_mark) -> None:
    """A train phase's telemetry: the sentinel's contained steps (a
    counter, a record and a trip of the flight recorder), the phase's
    goodput rollup and its MFU totals."""
    if totals.get("anomaly"):
        telemetry.registry.counter("sentinel_anomalies").inc(
            float(totals["anomaly"]))
        rec = telemetry.recorder
        if rec is not None:
            rec.record("sentinel_anomaly", epoch=epoch,
                       count=int(totals["anomaly"]),
                       policy=sentinel.policy if sentinel is not None
                       else None)
            rec.trip("sentinel_anomaly")
    gp = telemetry.phase_rollup(f"train_epoch_{epoch}", since=phase_mark)
    telemetry.note_train(gp["steps"], gp["wall_seconds"], res.examples)
