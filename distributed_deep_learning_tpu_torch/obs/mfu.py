"""Model-FLOP utilization accounting: the port of
``distributed_deep_learning_tpu/obs/mfu.py``.

MFU = achieved model FLOP/s ÷ (n_devices × the card's peak dense bf16
FLOP/s).  JAX reads the numerator from XLA's cost model of the compiled
step; eager PyTorch compiles nothing, so :func:`measure_step_flops` runs
the run's first train step under ``torch.utils.flop_counter.FlopCounterMode``,
which counts the FLOPs of the matrix products, convolutions and
attention calls it dispatches.  The flash kernels are launched outside
ATen, so while the counter runs they go through custom ops with
registered formulas (:func:`..ops.attention.counting_flops`) that count
what the dense path's products count: the step's FLOPs are then the same
whatever implements attention.  Elementwise work (the optimizer, the
softmax, the norms) is not counted, where XLA counts it.

The peak table is keyed by substrings of ``torch.cuda.get_device_name()``
(first match wins, so the PCIe and NVL parts are tried before the SXM
part's plain ``H100``).  On the CPU there is no meaningful peak, so MFU
is None unless ``DDL_OBS_PEAK_FLOPS`` is set, which tests and CPU smoke
runs use to exercise the full path.
"""

from __future__ import annotations

import os
from typing import Any, Callable

#: Peak dense bf16 tensor-core FLOP/s by device-name substring.  NVIDIA's
#: H100 datasheet gives the sparse figures (SXM 1,979, PCIe 1,513, NVL
#: 1,671 TFLOP/s with 2:4 sparsity); dense is half of each.
PEAK_BF16_FLOPS = (
    ("h100 pcie", 756.5e12),
    ("h100 nvl", 835.5e12),
    ("h100", 989.4e12),          # H100 SXM5 ("NVIDIA H100 80GB HBM3")
)


def chip_peak_flops(device_kind: str) -> float | None:
    """Peak dense-bf16 FLOP/s for a device name, None when unknown (CPU,
    cards not in the table).  ``DDL_OBS_PEAK_FLOPS`` overrides."""
    return chip_peak_flops_sourced(device_kind)[0]


def chip_peak_flops_sourced(device_kind: str
                            ) -> tuple[float | None, str | None]:
    """(peak, source): ``"env_override"`` (``DDL_OBS_PEAK_FLOPS``) or
    ``"table"``, the label that keeps a CPU MFU record (a synthetic
    peak) from being read as one measured on a card."""
    env = os.environ.get("DDL_OBS_PEAK_FLOPS")
    if env:
        return float(env), "env_override"
    kind = device_kind.lower()
    for sub, peak in PEAK_BF16_FLOPS:
        if sub in kind:
            return peak, "table"
    return None, None


def device_kind(device=None) -> str:
    """The name the peak table is keyed by: the card's name, or
    ``"cpu"``."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def count_flops(fn: Callable, *args, **kwargs) -> tuple[float, Any]:
    """``(FLOPs, result)`` of one call of ``fn`` under the FLOP counter,
    with the flash kernels counted by their registered formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_deep_learning_tpu_torch.ops.attention import \
        counting_flops

    with counting_flops(), FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def measure_step_flops(step_fn: Callable, *args,
                       n_devices: int | None = None,
                       **kwargs) -> tuple[float | None, Any]:
    """``(FLOPs, result)`` of one call of the train step ``step_fn(*args)``:
    the total model FLOPs over ``n_devices`` ranks (default 1: this
    process's share times the ranks the step's batch spans), None when
    the counter saw nothing.

    The call is the run's own step (the train loop counts a step
    function's first call): the counter only observes the operations it
    dispatches, and the counted flash ops launch the same kernels, so the
    step computes what it computes uncounted."""
    flops, out = count_flops(step_fn, *args, **kwargs)
    return (flops * (n_devices or 1) if flops > 0 else None), out


def mfu_record(step_flops: float | None, steps: float, seconds: float,
               n_devices: int, device_kind: str,
               peak_flops: float | None = None) -> dict[str, Any]:
    """The MFU report dict from measured pieces (JAX's record, key for
    key).  ``step_flops`` is the GLOBAL FLOPs of one step.  Any piece may
    be missing; the record degrades field by field.  Every record carries
    ``peak_flops_source`` (``table`` / ``env_override`` / ``caller`` /
    None)."""
    source: str | None = "caller" if peak_flops is not None else None
    if peak_flops is None:
        peak_flops, source = chip_peak_flops_sourced(device_kind)
    steps_per_sec = steps / seconds if seconds > 0 else None
    achieved = (step_flops * steps_per_sec
                if step_flops and steps_per_sec else None)
    mfu = None
    if achieved and peak_flops and n_devices > 0:
        mfu = achieved / (n_devices * peak_flops)
    return {
        "step_flops": step_flops,
        "steps": steps,
        "seconds": seconds,
        "steps_per_sec": steps_per_sec,
        "achieved_flops_per_sec": achieved,
        "n_devices": n_devices,
        "device_kind": device_kind,
        "peak_flops_per_chip": peak_flops,
        "peak_flops_source": source,
        "mfu": mfu,
    }
