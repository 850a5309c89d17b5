"""The anomaly sentinel: the port of
``distributed_deep_learning_tpu/train/sentinel.py``.

A batch with a NaN or one pathological gradient spike would update the
parameters, the checkpointer would keep the poisoned state, and elastic
recovery would restore it.  So the train step checks each update before
it is applied: after the backward it takes the global gradient norm (of
the whole parameters, through :func:`..train.state.global_norm`, so it is
right under ``--zero 1|fsdp`` and tensor parallelism), checks the loss
and the norm for finiteness, and compares both with running means kept
in a four-scalar :class:`SentinelState` (carried in the
:class:`..train.state.TrainState` and in its checkpoints).  An anomalous
step leaves the parameters, the optimizer state, the update count, the
dropout generator and the buffers bit-identical to never having
trained the batch, and its task metrics count nothing.

Containment: the JAX step computes the update and selects ``where(anomaly,
old, new)`` per leaf, with no host sync.  torch optimizers update in
place, and the update count and the learning rate it selects live on the
host, so here the verdict is one host sync of two scalars (the norm and
the loss) before ``optimizer.step``: an anomalous step never calls it, and
the generator and buffers are put back from the copies taken when the
step began.  The running means are kept in f32 on the host, with JAX's
arithmetic, so the verdicts equal JAX's on the same norms and losses.

Policies decide what the loop does with a verdict (:mod:`.loop` reads it
one step late): ``skip`` counts it, ``rollback`` and ``halt`` raise
:class:`AnomalyError` (``rollback`` is caught by
:func:`..elastic.fit_with_recovery`, which replays with the step in its
skip set).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.train.state import global_norm

#: anomaly verdict codes carried in the per-step ``anomaly_code`` metric
OK, NONFINITE, GRAD_SPIKE, LOSS_SPIKE = 0, 1, 2, 3

_CODE_NAMES = {NONFINITE: "non-finite loss/grad",
               GRAD_SPIKE: "gradient-norm spike",
               LOSS_SPIKE: "loss spike"}

POLICIES = ("skip", "rollback", "halt")


class AnomalyError(RuntimeError):
    """Raised by the loop under ``rollback``/``halt``: the update was
    already contained, and ``global_step`` names the batch to skip on a
    replay."""

    def __init__(self, global_step: int, policy: str, code: int,
                 detail: str = ""):
        self.global_step = int(global_step)
        self.policy = policy
        self.code = int(code)
        what = _CODE_NAMES.get(self.code, "anomaly")
        super().__init__(
            f"anomaly sentinel: {what} at global train step {global_step} "
            f"(policy={policy}{'; ' + detail if detail else ''})")


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """``window``: the running means' horizon in steps; ``spike_factor``
    and ``loss_spike_factor``: the multiples of those means that count as
    a spike; the first ``warmup_steps`` clean steps only feed the means.
    Finiteness is always checked."""

    policy: str = "skip"
    window: int = 32
    spike_factor: float = 10.0
    loss_spike_factor: float = 10.0
    warmup_steps: int = 8

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"sentinel policy {self.policy!r}: choose from "
                             f"{POLICIES}")
        if self.window < 1 or self.warmup_steps < 1:
            raise ValueError("sentinel window and warmup_steps must be >= 1")
        if self.spike_factor <= 1.0 or self.loss_spike_factor <= 1.0:
            raise ValueError("sentinel spike factors must be > 1")


@dataclasses.dataclass
class SentinelState:
    """The four scalars: the running means of the global gradient norm
    and of the loss (f32), the clean steps seen and the anomalies
    contained."""

    grad_ema: np.float32 = np.float32(0.0)
    loss_ema: np.float32 = np.float32(0.0)
    count: int = 0
    anomalies: int = 0

    def to_dict(self) -> dict:
        return {"grad_ema": float(self.grad_ema),
                "loss_ema": float(self.loss_ema),
                "count": int(self.count), "anomalies": int(self.anomalies)}

    @classmethod
    def from_dict(cls, d: dict) -> "SentinelState":
        return cls(np.float32(d["grad_ema"]), np.float32(d["loss_ema"]),
                   int(d["count"]), int(d["anomalies"]))

    @classmethod
    def from_flax(cls, sen) -> "SentinelState":
        """The JAX package's ``SentinelState`` (four scalar arrays, read
        through ``numpy``), carried across."""
        return cls.from_dict({k: np.asarray(getattr(sen, k)) for k in
                              ("grad_ema", "loss_ema", "count",
                               "anomalies")})


def attach_sentinel(state):
    """``state`` with a fresh :class:`SentinelState`."""
    state.sentinel = SentinelState()
    return state


def verdict(sen: SentinelState, gnorm: float, loss: float,
            cfg: SentinelConfig) -> tuple[int, SentinelState]:
    """``(code, new state)`` of one step, JAX's ``guarded_update``
    arithmetic in f32: a non-finite norm or loss first, then a gradient
    spike, then a loss spike; the means move over clean steps only, the
    first clean step seeding them."""
    gnorm, loss = np.float32(gnorm), np.float32(loss)
    finite = bool(np.isfinite(gnorm) and np.isfinite(loss))
    warm = sen.count >= cfg.warmup_steps
    g_spike = warm and bool(gnorm > np.float32(cfg.spike_factor)
                            * sen.grad_ema)
    l_spike = warm and bool(loss > np.float32(cfg.loss_spike_factor)
                            * sen.loss_ema)
    code = NONFINITE if not finite else GRAD_SPIKE if g_spike else \
        LOSS_SPIKE if l_spike else OK
    if code != OK:
        return code, dataclasses.replace(sen, anomalies=sen.anomalies + 1)
    # JAX's weak-typed Python floats: each rounds to f32 once
    keep, alpha = np.float32(1.0 - 1.0 / cfg.window), \
        np.float32(1.0 / cfg.window)

    def ema(prev, x):
        if sen.count == 0:
            return x
        return np.float32(keep * prev + alpha * x)

    return OK, SentinelState(ema(sen.grad_ema, gnorm),
                             ema(sen.loss_ema, loss), sen.count + 1,
                             sen.anomalies)


class StepSnapshot:
    """What an in-place step changes outside the parameters and the
    optimizer, taken when the step begins: the dropout generator's state
    and the model's buffers (BatchNorm's running statistics and count)."""

    def __init__(self, state):
        self.generator = None if state.generator is None \
            else state.generator.get_state()
        self.buffers = [(b, b.detach().clone())
                        for b in state.model.buffers()]

    @torch.no_grad()
    def restore(self, state) -> None:
        if self.generator is not None:
            state.generator.set_state(self.generator)
        for b, saved in self.buffers:
            b.copy_(saved)


def guarded_update(state, metrics: dict, cfg: SentinelConfig,
                   snapshot: StepSnapshot) -> tuple[object, dict]:
    """The sentinel's half of a train step, after the backward: the
    verdict (one host sync of the global gradient norm and the loss),
    then the update (``state.apply_gradients()``) or the containment.
    Returns ``(state, metrics)``; the metrics gain ``anomaly`` (0/1),
    ``anomaly_code`` and ``grad_norm`` (host tensors), and an anomalous
    step's task metrics are zeroed."""
    if state.sentinel is None:
        raise ValueError("sentinel config given but state has no sentinel "
                         "state — build the state via attach_sentinel()")
    params = state.grad_params()
    loss = metrics["loss"]
    gnorm = global_norm([p.grad for p in params], params) if params \
        else torch.zeros((), device=loss.device)
    g, l_ = torch.stack([gnorm.float(), loss.detach().float()]).tolist()
    code, state.sentinel = verdict(state.sentinel, g, l_, cfg)
    anomaly = code != OK
    if anomaly:
        snapshot.restore(state)
        state.optimizer.zero_grad(set_to_none=True)
    else:
        state.apply_gradients()
    out = {k: torch.zeros_like(v) if anomaly else v
           for k, v in metrics.items()}
    # host scalars: the verdict is on the host already, and the loop's
    # lag-1 check reads it without a second sync
    out["anomaly"] = torch.tensor(float(anomaly))
    out["anomaly_code"] = torch.tensor(float(code))
    out["grad_norm"] = torch.tensor(g if np.isfinite(g) else 0.0)
    return state, out
