"""MPMD staged execution: the port of
``distributed_deep_learning_tpu/parallel/mpmd.py``, the reference's
``model`` and ``pipeline`` forwards.

Each stage's module lives on its own device and activations move at
stage boundaries with ``.to(device)``, as the reference's
``nn.Sequential`` stages did (``MLP/model.py:77-80``).  Stage ``i`` goes
to ``devices[i % n]``: on one card every stage shares it.  CUDA launches
are asynchronous, so with stages on different cards chunk *k* on stage
*s* runs while the host enqueues chunk *k+1* on stage *s-1*; on one card
the chunks run in turn.

``microbatch_size`` follows the reference's ``-p``: the SIZE of each
microbatch, not their count, with a ragged last chunk kept.
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_deep_learning_tpu_torch.parallel.staging import StagedModel


def microbatches(x, microbatch_size: int | None) -> list:
    """``x`` cut into chunks of ``microbatch_size`` rows (the last one
    ragged); the whole of ``x`` without a size or when it is not smaller
    than the batch."""
    mb = microbatch_size
    if not mb or mb >= len(x):
        return [x]
    return [x[i:i + mb] for i in range(0, len(x), mb)]


class MPMDPipeline:
    """Stage-placed forward execution of a :class:`StagedModel`; autograd
    records it unless the caller turns it off (the staged trainer's train
    step keeps it, its eval step does not)."""

    def __init__(self, staged: StagedModel, devices: Sequence,
                 microbatch_size: int | None = None):
        if len(devices) != len(staged.stages):
            raise ValueError(f"{len(staged.stages)} stages need "
                             f"{len(staged.stages)} devices, got "
                             f"{len(devices)}")
        self.staged = staged
        self.devices = [torch.device(d) for d in devices]
        self.microbatch_size = microbatch_size

    def place(self) -> StagedModel:
        """Move stage ``i`` to ``devices[i]``."""
        for stage, device in zip(self.staged.stages, self.devices):
            stage.to(device)
        return self.staged

    def forward(self, x, train: bool = False):
        """``model`` mode: one chunk walks the stages (reference
        ``modelParallelismForward``)."""
        return self.staged.walk(x, train, self.devices)

    def pipelined_forward(self, x, train: bool = False):
        """``pipeline`` mode: ``-p``-sized chunks each walk the stages and
        are concatenated (reference
        ``pipelinedModelParallelismForward``); one chunk without a size."""
        outs = [self.staged.walk(c, train, self.devices)
                for c in microbatches(x, self.microbatch_size)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def __call__(self, x, pipelined: bool | None = None, train: bool = False):
        if pipelined or (pipelined is None and self.microbatch_size):
            return self.pipelined_forward(x, train)
        return self.forward(x, train)
