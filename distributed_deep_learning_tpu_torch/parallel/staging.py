"""Model staging: the port of
``distributed_deep_learning_tpu/parallel/staging.py``.

A model exposes a layer sequence (a list of modules that each take one
tensor), a partitioner assigns layers to stages, and :class:`StagedModel`
holds the per-stage :class:`Stage` modules.  ``prepare``, when given, is
the sequential model's input conversion (its compute dtype, NHWC to the
channels-last NCHW view), applied by stage 0 before its first layer, where
the flax layers take their input as it comes.

A stage names its layers ``layers.0..k-1`` locally, as flax's ``Stage``
names them ``layers_0..layers_{k-1}``: :meth:`StagedModel.split_state_dict`
re-keys a sequential state dict (``layers.0..L-1``) per stage, and
:func:`load_flax_stages` carries the JAX package's per-stage variables
over through each layer's ``flax_state(params, batch_stats)``.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import reset_all
from distributed_deep_learning_tpu_torch.parallel.partition import \
    stage_slices


class Stage(nn.Module):
    """A contiguous run of layers executed in order (one pipeline stage);
    ``train`` sets the layers' mode (BatchNorm statistics)."""

    def __init__(self, layers: Sequence[nn.Module],
                 prepare: Optional[Callable] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.prepare = prepare

    def forward(self, x, train: bool = False):
        if self.training != train:
            self.train(train)
        if self.prepare is not None:
            x = self.prepare(x)
        for layer in self.layers:
            x = layer(x)
        return x


class StagedModel(nn.Module):
    """A model split into per-stage modules: ``stages[i]`` holds the
    layers of stage ``i``, so each stage's parameters can live on its own
    device."""

    def __init__(self, stages: Sequence[Stage]):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    @staticmethod
    def from_layers(layers: Sequence[nn.Module], assignment: np.ndarray,
                    n_stages: int,
                    prepare: Optional[Callable] = None) -> "StagedModel":
        slices = stage_slices(np.asarray(assignment), n_stages)
        return StagedModel([Stage(layers[a:b], prepare if i == 0 else None)
                            for i, (a, b) in enumerate(slices)])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each layer's initialiser in layer order: the sequential model's
        draws, so a staged and a sequential model made from one seed hold
        the same weights."""
        for stage in self.stages:
            for layer in stage.layers:
                if hasattr(layer, "reset_parameters"):
                    layer.reset_parameters(generator)
                else:
                    reset_all(layer, generator)
        return self

    def walk(self, x, train: bool = False, devices: Optional[Sequence] = None):
        """Stage after stage, the activation moved at each boundary to
        ``devices[i]`` (else to where stage ``i``'s parameters lie);
        ``train`` sets the layers' mode.  The one staged walk: the
        forwards below, :class:`..mpmd.MPMDPipeline` and the staged
        trainer all run it."""
        for i, stage in enumerate(self.stages):
            device = _device(stage, x) if devices is None else devices[i]
            x = stage(x.to(device), train=train)
        return x

    def apply(self, x):
        """Plain sequential forward in eval mode (the reference's
        ``sequential`` mode over the stages)."""
        return self.walk(x)

    def apply_train(self, x):
        """Train-mode forward: the output and each stage's buffers
        (BatchNorm statistics, advanced in place)."""
        x = self.walk(x, train=True)
        return x, [dict(stage.named_buffers()) for stage in self.stages]

    def split_state_dict(self, flat: dict) -> list[dict]:
        """Re-key a sequential state dict (``layers.<global index>.*``)
        into this staging's per-stage state dicts (``layers.<local
        index>.*``)."""
        out, start = [], 0
        for stage in self.stages:
            size, sd = len(stage.layers), {}
            for key, value in flat.items():
                m = re.match(r"layers\.(\d+)\.(.*)", key)
                if m and start <= int(m.group(1)) < start + size:
                    sd[f"layers.{int(m.group(1)) - start}.{m.group(2)}"] = \
                        value
            out.append(sd)
            start += size
        return out

    def from_sequential(self, flat: dict) -> dict:
        """This model's state dict from a sequential one
        (:meth:`split_state_dict`, prefixed ``stages.<i>.``)."""
        return {f"stages.{i}.{k}": v
                for i, sd in enumerate(self.split_state_dict(flat))
                for k, v in sd.items()}


def layer_state_dict(model: nn.Module) -> dict:
    """A sequential model's state dict keyed ``layers.<i>.*`` in the order
    of its workload's staged layer list, as ``split_state_dict`` takes
    it: the model's own ``layer_state_dict`` where its names differ
    (ResNet, MnistCNN), else its state dict."""
    keyed = getattr(model, "layer_state_dict", None)
    return keyed() if keyed is not None else model.state_dict()


def _device(module: nn.Module, x) -> torch.device:
    p = next(module.parameters(), None)
    return x.device if p is None else p.device


def load_flax_stages(variables: Sequence[dict], staged: StagedModel) -> dict:
    """:class:`StagedModel`'s state dict from the JAX package's per-stage
    variables (``StagedModel.init``: ``{"params": {"layers_j": ...},
    "batch_stats": ...}`` a stage, numpy arrays): each layer ``j`` of
    stage ``i`` maps its flax subtree with ``flax_state(params,
    batch_stats)``; layers without weights have none."""
    sd = {}
    for i, (stage, v) in enumerate(zip(staged.stages, variables)):
        params, stats = v.get("params", {}), v.get("batch_stats", {})
        for j, layer in enumerate(stage.layers):
            name = f"layers_{j}"
            if name not in params:
                continue
            for key, t in layer.flax_state(params[name],
                                           stats.get(name, {})).items():
                sd[f"stages.{i}.layers.{j}.{key}"] = t
    return sd
