"""Epoch loop with the reference's phase/metric semantics: the port of
``distributed_deep_learning_tpu/train/loop.py`` (without checkpointing,
resume, chaos, sentinel or telemetry, which later slices port).

Per epoch a train phase and a validation phase, then one final test
phase; accuracy = argmax matches × 100 / sites, and the logged loss keeps
the reference's Σ(batch-mean loss) / Σ(sites) formula (quirk Q9).  The
steps' metric tensors stay on the device during a phase and are fetched
once at its end, with each train step's loss and time: on the card the
step times come from CUDA events recorded between steps, so timing adds
no host sync either.
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


def _run_phase(step_fn, state, loader, *, train: bool):
    """Drive one phase; returns ``(state, totals, step_losses,
    step_seconds)`` with one host sync at the end."""
    metrics, clock = [], None
    for x, y in loader:
        if train:
            if clock is None:
                clock = _StepClock(x.device)
            state, m = step_fn(state, x, y)
            clock.mark()
        else:
            m = step_fn(state, x, y)
        metrics.append(m)
    if not metrics:
        return state, {"loss": 0.0, "correct": 0, "count": 0}, [], []
    stacked = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    host = {k: v.cpu() for k, v in stacked.items()}
    totals = {k: v.sum().item() for k, v in host.items()}
    losses = host["loss"].tolist() if train else []
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
        test_loader, epochs: int, logger: PhaseLogger | None = None
        ) -> tuple[TrainState, list[EpochResult]]:
    """Drive the epoch loop; returns the final state and every phase's
    :class:`EpochResult` in order (train, validation per epoch, then
    test).  The log lines follow the reference's grammar."""
    logger = logger or PhaseLogger(verbose=False)
    history: list[EpochResult] = []
    for epoch in range(1, epochs + 1):   # the reference counts from 1
        train_loader.set_epoch(epoch)
        t0 = logger.phase_begin("train", epoch)
        state, totals, losses, secs = _run_phase(train_step, state,
                                                 train_loader, train=True)
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

    t0 = logger.clock()
    _, totals, _, _ = _run_phase(eval_step, state, test_loader, train=False)
    t1 = logger.clock()
    res = _result("test", None, totals, t0, t1)
    logger.phase_end("test", accuracy=res.accuracy, loss=res.loss)
    history.append(res)
    return state, history
