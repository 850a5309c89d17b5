"""Instrumentation-overhead harness: the port of
``distributed_deep_learning_tpu/obs/bench.py``.

Drives the real :func:`..train.loop._run_phase` over a list-backed
loader with a step sized at about a millisecond of work (a tanh chain of
``depth`` ``dim × dim`` products, its gradient and an SGD update), off
and on interleaved, and takes the medians, so a background blip cannot
land on one side only.  Each phase ends in the loop's one host fetch of
the metrics, so a phase's time holds its device time.  Besides JAX's
keys, each record carries the quartiles of the per-step cost over the
repeats, each repeat's pair (off then on) differenced on its own: the
spread that says whether the median is resolved.
"""

from __future__ import annotations

import statistics
import time

import torch


class _ListLoader:
    """The loop's loader contract over a list of device batches."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def iter_batches(self, skip: int = 0):
        return iter(self.batches[skip:])


def _build_step(dim: int, depth: int, batch: int, seed: int, device):
    """A ``(state, x, y) -> (state, metrics)`` step with the train loop's
    metric contract."""
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(dim, dim, generator=g) / dim ** 0.5).to(device)
    x = torch.randn(batch, dim, generator=g).to(device)
    y = torch.randn(batch, dim, generator=g).to(device)

    def step(state, xb, yb):
        wm = state["w"].detach().requires_grad_(True)
        h = xb
        for _ in range(depth):
            h = torch.tanh(h @ wm)
        loss = torch.mean((h - yb) ** 2)
        (grad,) = torch.autograd.grad(loss, wm)
        correct = ((xb[:, 0] > 0) == (yb[:, 0] > 0)).sum()
        return {"w": (state["w"] - 1e-3 * grad).detach()}, \
            {"loss": loss.detach(), "correct": correct,
             "count": torch.tensor(xb.shape[0], device=xb.device)}

    return step, {"w": w}, (x, y)


def _phase_sps(step, state, loader, steps: int, telemetry) -> float:
    from distributed_deep_learning_tpu_torch.train.loop import _run_phase

    t0 = time.perf_counter()
    _run_phase(step, state, loader, train=True, telemetry=telemetry)
    return steps / (time.perf_counter() - t0)


def _quartiles_us(base, instr) -> list[float]:
    """Quartiles of the per-step cost ``1/instr - 1/base`` in
    microseconds over paired steps/s readings."""
    d = [(1.0 / b - 1.0 / a) * 1e6 for a, b in zip(base, instr)]
    q = statistics.quantiles(d, n=4) if len(d) > 1 else d * 3
    return [round(v, 2) for v in q]


def _device(device):
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def overhead_bench(*, steps: int = 48, repeats: int = 5, dim: int = 256,
                   depth: int = 4, batch: int = 64, seed: int = 0,
                   device=None) -> dict:
    """The telemetry hot path's cost on the real train loop:
    ``steps_per_sec_off`` / ``steps_per_sec_on`` (medians over
    interleaved repeats), ``obs_overhead_fraction`` (1 - on/off) and the
    per-step cost in microseconds (JAX's record, plus ``device``)."""
    from distributed_deep_learning_tpu_torch.obs import RunTelemetry

    dev = _device(device)
    step, state, (x, y) = _build_step(dim, depth, batch, seed, dev)
    loader = _ListLoader([(x, y)] * steps)
    _phase_sps(step, state, _ListLoader([(x, y)] * 2), 2, None)   # warm

    off, on = [], []
    for _ in range(repeats):
        off.append(_phase_sps(step, state, loader, steps, None))
        on.append(_phase_sps(step, state, loader, steps,
                             RunTelemetry(path=None, device=dev)))
    quartiles = _quartiles_us(off, on)
    off.sort()
    on.sort()
    sps_off, sps_on = off[len(off) // 2], on[len(on) // 2]
    frac = 1.0 - sps_on / sps_off
    return {
        "metric": "obs instrumentation overhead (steps/sec on vs off)",
        "steps": steps, "repeats": repeats,
        "step_geometry": {"dim": dim, "depth": depth, "batch": batch},
        "device": str(dev),
        "steps_per_sec_off": round(sps_off, 2),
        "steps_per_sec_on": round(sps_on, 2),
        "obs_overhead_fraction": round(frac, 5),
        "per_step_overhead_us": round(
            (1.0 / sps_on - 1.0 / sps_off) * 1e6, 2),
        "per_step_overhead_us_quartiles": quartiles,
    }


def trace_overhead_bench(*, steps: int = 48, repeats: int = 5,
                         dim: int = 256, depth: int = 4, batch: int = 64,
                         seed: int = 0, device=None) -> dict:
    """Telemetry WITH span tracing against telemetry without, on the
    real train loop (JAX's record, plus ``device``)."""
    from distributed_deep_learning_tpu_torch.obs import RunTelemetry, Tracer

    dev = _device(device)
    step, state, (x, y) = _build_step(dim, depth, batch, seed, dev)
    loader = _ListLoader([(x, y)] * steps)
    _phase_sps(step, state, _ListLoader([(x, y)] * 2), 2, None)   # warm

    plain, traced = [], []
    for _ in range(repeats):
        plain.append(_phase_sps(step, state, loader, steps,
                                RunTelemetry(path=None, device=dev)))
        traced.append(_phase_sps(step, state, loader, steps,
                                 RunTelemetry(path=None, tracer=Tracer(),
                                              device=dev)))
    quartiles = _quartiles_us(plain, traced)
    plain.sort()
    traced.sort()
    sps_plain = plain[len(plain) // 2]
    sps_traced = traced[len(traced) // 2]
    frac = 1.0 - sps_traced / sps_plain
    return {
        "metric": "span-tracing overhead (steps/sec traced vs untraced "
                  "telemetry)",
        "steps": steps, "repeats": repeats,
        "step_geometry": {"dim": dim, "depth": depth, "batch": batch},
        "device": str(dev),
        "steps_per_sec_plain": round(sps_plain, 2),
        "steps_per_sec_traced": round(sps_traced, 2),
        "obs_trace_overhead_fraction": round(frac, 5),
        "per_step_overhead_us": round(
            (1.0 / sps_traced - 1.0 / sps_plain) * 1e6, 2),
        "per_step_overhead_us_quartiles": quartiles,
    }
