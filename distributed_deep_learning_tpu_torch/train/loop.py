"""Epoch loop with the reference's phase/metric semantics: the port of
``distributed_deep_learning_tpu/train/loop.py`` with its checkpointing and
resume (without chaos, sentinel or telemetry, which later slices port).

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
the uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from distributed_deep_learning_tpu_torch.train.state import TrainState
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
    for k, v in (init_totals or {}).items():
        totals[k] = totals.get(k, 0) + v
    return totals, host


def _run_phase(step_fn, state, loader, *, train: bool, skip: int = 0,
               init_totals=None, on_step=None):
    """Drive one phase; returns ``(state, totals, step_losses,
    step_seconds)`` with one host sync at the end.  The first ``skip``
    batches are skipped (mid-epoch resume; ``init_totals`` holds what
    they added).  ``on_step(batch_number, state, totals_fn)`` runs after
    each train step; ``totals_fn()`` syncs only when called."""
    metrics, clock = [], None
    for i, (x, y) in enumerate(loader.iter_batches(skip), start=skip + 1):
        if train:
            if clock is None:
                clock = _StepClock(x.device)
            state, m = step_fn(state, x, y)
            clock.mark()
        else:
            m = step_fn(state, x, y)
        metrics.append(m)
        if on_step is not None:
            on_step(i, state,
                    lambda: _sum_totals(metrics, init_totals)[0])
    totals, host = _sum_totals(metrics, init_totals)
    losses = host["loss"].tolist() if train and host else []
    return state, totals, losses, clock.seconds() if clock else []


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
        checkpointer=None, start_epoch: int = 1,
        checkpoint_every: int | None = None, resume_batch: int = 0,
        resume_totals: dict | None = None
        ) -> tuple[TrainState, list[EpochResult]]:
    """Drive the epoch loop from ``start_epoch``; returns the final state
    and every phase's :class:`EpochResult` in order (train, validation
    per epoch, then test).  The log lines follow the reference's grammar.
    ``checkpointer`` (:class:`..utils.checkpoint.Checkpointer`) saves as
    the module docstring says; ``resume_batch``/``resume_totals`` (from
    :func:`..elastic.resume_point`) resume inside ``start_epoch``."""
    logger = logger or PhaseLogger(verbose=False)
    history: list[EpochResult] = []
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
    for epoch in range(start_epoch, epochs + 1):   # the reference counts
        train_loader.set_epoch(epoch)              # from 1
        skip = resume_batch if epoch == start_epoch else 0
        init_totals = resume_totals if epoch == start_epoch else None

        def on_step(b, st, totals_fn, _epoch=epoch):
            if checkpointer is not None and checkpoint_every \
                    and b % checkpoint_every == 0 and b < spe:
                checkpointer.save(
                    (_epoch - 1) * spe + b, st,
                    extra={"epoch": _epoch, "batch": b,
                           "epoch_complete": False,
                           "totals": {k: float(v)
                                      for k, v in totals_fn().items()}})

        t0 = logger.phase_begin("train", epoch)
        state, totals, losses, secs = _run_phase(
            train_step, state, train_loader, train=True, skip=skip,
            init_totals=init_totals, on_step=on_step)
        t1 = logger.clock()
        res = _result("train", epoch, totals, t0, t1, losses, secs)
        logger.phase_end("train", epoch, accuracy=res.accuracy, loss=res.loss)
        logger.metrics(phase="train", epoch=epoch,
                       examples_per_sec=round(res.examples_per_sec, 1),
                       examples=res.examples)
        history.append(res)

        t0 = logger.clock()
        _, totals, _, _ = _run_phase(eval_step, state, val_loader,
                                     train=False)
        t1 = logger.clock()
        res = _result("validation", epoch, totals, t0, t1)
        # the reference prints only the validation end line
        logger.phase_end("validation", epoch, accuracy=res.accuracy,
                         loss=res.loss)
        history.append(res)
        if checkpointer is not None:
            checkpointer.save(epoch * spe if checkpoint_every else epoch,
                              state, extra={"epoch": epoch, "batch": spe,
                                            "epoch_complete": True})

    t0 = logger.clock()
    _, totals, _, _ = _run_phase(eval_step, state, test_loader, train=False)
    t1 = logger.clock()
    res = _result("test", None, totals, t0, t1)
    logger.phase_end("test", accuracy=res.accuracy, loss=res.loss)
    history.append(res)
    return state, history
