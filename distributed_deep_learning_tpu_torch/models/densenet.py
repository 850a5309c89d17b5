"""DenseNet-BC, the ``cnn`` workload's model: the port of
``distributed_deep_learning_tpu/models/densenet.py`` (reference
``src/pytorch/CNN/model.py``).

Stem ``Conv7×7 s2 → BN/ReLU → MaxPool3×3 s2`` → ``dense_blocks`` ×
[DenseBlock (+Transition between blocks)] → ``AvgPool7 → Flatten →
Linear``; growth rate 32, ``2 × growth`` initial features, 6 BC layers a
block (``BN→ReLU→Conv1×1(bn_size·k)→BN→ReLU→Conv3×3(k)``), the head's
softmax only under ``double_softmax`` (quirk Q4).

The model takes NHWC input, as the datasets give it, and permutes it once
to an NCHW view, which is channels-last in memory: the layout cuDNN's
tensor-core convolutions prefer.  ``GlobalPool`` flattens in NHWC order,
so the flax ``Dense`` kernel applies unchanged (:func:`load_flax_variables`).

:class:`BatchNorm` has flax's semantics, which ``torch.nn.BatchNorm2d``
does not: the running variance is the biased batch variance
``E[x²] - E[x]²`` (clamped at 0), ε is 1e-3, the running update is
``0.01 · running + 0.99 · batch`` (flax's momentum 0.01, torch's 0.99),
and the statistics are taken in f32 whatever the compute dtype.  Under a
synced ``-m data`` step (:func:`global_batch_statistics`) the statistics
span the global batch, as JAX's do under ``jit`` over the sharded batch:
the ranks all-reduce per-channel ``[sum, sum of squares, count]`` through
the differentiable ``torch.distributed.nn.functional.all_reduce``, so the
backward is the global batch's too.  One code path serves the CPU and the
card.  A train-mode forward updates the running statistics once; the
``--remat`` recompute does not (:func:`..layers.recomputing`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import (
    Conv2d, Dense, as_tensor, conv2d_weight, dense_state, he_normal_,
    recomputable, recomputing, reset_all, run_layers)

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # flax's convention: running = m·running + (1-m)·batch


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(epsilon=1e-3, momentum=0.01)`` over dim 1 of an
    NCHW (or ``(N, C)``) tensor; see the module docstring.
    ``global_stats`` (set by :func:`global_batch_statistics`) takes the
    training statistics over every rank of the default process group."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.num_features, self.eps, self.momentum = num_features, eps, \
            momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.global_stats = False

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_statistics(self, xf):
        """Per-channel ``(mean, biased var)`` of the f32 input, over the
        global batch when ``global_stats`` and the group has ranks."""
        dims = [d for d in range(xf.dim()) if d != 1]
        count = torch.full((self.num_features,), xf.numel()
                           / self.num_features, dtype=xf.dtype,
                           device=xf.device)
        stats = torch.stack([xf.sum(dims), (xf * xf).sum(dims), count])
        if self.global_stats and dist.is_initialized() and \
                dist.get_world_size() > 1:
            from torch.distributed.nn.functional import all_reduce

            stats = all_reduce(stats)
        mean, mean2 = stats[0] / stats[2], stats[1] / stats[2]
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x):
        # under a dots remat policy the backward computes the centred
        # input and the output again from the kept input and statistics
        xf = recomputable(torch.Tensor.float, x)
        if self.training:
            mean, var = self.batch_statistics(xf)
            if not recomputing():
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        centred = recomputable(torch.sub, xf, mean.view(shape))
        return recomputable(_scale_shift, centred, mul.view(shape),
                            self.bias.view(shape), x.dtype)


def _scale_shift(centred, mul, bias, dtype):
    return (centred * mul + bias).to(dtype)


def global_batch_statistics(model: nn.Module, enabled: bool = True):
    """Make every :class:`BatchNorm` of ``model`` take its training
    statistics over the global batch (a synced ``-m data`` step)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.global_stats = enabled
    return model


def _conv(cin, cout, k, **kw):
    return Conv2d(cin, cout, k, bias=False, init=he_normal_, **kw)


class DenseLayer(nn.Module):
    """BC bottleneck: BN→ReLU→Conv1×1→BN→ReLU→Conv3×3, returns k new maps."""

    def __init__(self, in_features: int, growth_rate: int = 32,
                 bn_size: int = 4):
        super().__init__()
        self.norm0 = BatchNorm(in_features)
        self.conv0 = _conv(in_features, bn_size * growth_rate, 1)
        self.norm1 = BatchNorm(bn_size * growth_rate)
        self.conv1 = _conv(bn_size * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x):
        y = self.conv0(recomputable(F.relu, self.norm0(x)))
        return self.conv1(recomputable(F.relu, self.norm1(y)))


class DenseBlock(nn.Module):
    """``num_layers`` DenseLayers with cumulative channel concatenation."""

    def __init__(self, in_features: int, num_layers: int = 6,
                 growth_rate: int = 32, bn_size: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseLayer(in_features + i * growth_rate, growth_rate, bn_size)
            for i in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = recomputable(_concat, x, layer(x))
        return x

    @staticmethod
    def flax_state(params, stats) -> dict:
        sd, i = {}, 0
        while f"DenseLayer_{i}" in params:
            lp, ls = params[f"DenseLayer_{i}"], stats[f"DenseLayer_{i}"]
            for j in (0, 1):
                sd.update(_bn_state(lp[f"BatchNorm_{j}"], ls[f"BatchNorm_{j}"],
                                    f"layers.{i}.norm{j}"))
                sd[f"layers.{i}.conv{j}.weight"] = conv2d_weight(
                    lp[f"Conv_{j}"]["kernel"])
            i += 1
        return sd


def _concat(x, new):
    return torch.cat([x, new], dim=1)


class Transition(nn.Module):
    """BN→ReLU→Conv1×1(halve channels)→AvgPool2×2."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.norm = BatchNorm(in_features)
        self.conv = _conv(in_features, out_features, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(recomputable(F.relu, self.norm(x))),
                            2, 2)

    @staticmethod
    def flax_state(params, stats) -> dict:
        sd = _bn_state(params["BatchNorm_0"], stats["BatchNorm_0"], "norm")
        sd["conv.weight"] = conv2d_weight(params["Conv_0"]["kernel"])
        return sd


class Stem(nn.Module):
    """Conv7×7 s2 (BN/ReLU are the next layer, as in the reference)."""

    def __init__(self, num_features: int, in_channels: int = 3):
        super().__init__()
        self.conv = _conv(in_channels, num_features, 7, stride=2, padding=3)

    def forward(self, x):
        return self.conv(x)

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return {"conv.weight": conv2d_weight(params["Conv_0"]["kernel"])}


class StemNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.norm = BatchNorm(num_features)

    def forward(self, x):
        return F.relu(self.norm(x))

    @staticmethod
    def flax_state(params, stats) -> dict:
        return _bn_state(params["BatchNorm_0"], stats["BatchNorm_0"], "norm")


class StemPool(nn.Module):
    """flax ``max_pool((3, 3), (2, 2), padding=((1, 1), (1, 1)))``: the
    padding is -inf, as torch's implicit max-pool padding."""

    def forward(self, x):
        return F.max_pool2d(x, 3, 2, padding=1)


class GlobalPool(nn.Module):
    """AvgPool with the window clamped to ``min(7, H, W)`` (stride = the
    window), then Flatten in NHWC order."""

    def forward(self, x):
        k = min(7, x.shape[2], x.shape[3])
        x = F.avg_pool2d(x, k, k)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Classifier(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 6,
                 double_softmax: bool = False):
        super().__init__()
        self.dense = Dense(in_features, num_classes)
        self.double_softmax = double_softmax

    def forward(self, x):
        x = self.dense(x)
        if self.double_softmax:           # reference quirk Q4
            x = torch.softmax(x, dim=-1)
        return x.float()

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return dense_state(params["Dense_0"], "dense")


def pooled_size(image_size: tuple[int, int], dense_blocks: int
                ) -> tuple[int, int]:
    """The map ``GlobalPool`` emits for an ``image_size`` input: the stem's
    stride 2, the pool's stride 2, a halving per transition, then the
    clamped window (flax infers the head's width from it; torch needs it
    up front)."""
    hw = [(s - 1) // 2 + 1 for s in image_size]          # conv 7, s2, p3
    hw = [(s - 1) // 2 + 1 for s in hw]                  # pool 3, s2, p1
    for _ in range(dense_blocks - 1):
        hw = [s // 2 for s in hw]                        # transitions
    k = min(7, *hw)
    return (hw[0] - k) // k + 1, (hw[1] - k) // k + 1


def densenet_layer_sequence(dense_blocks: int = 2, dense_layers: int = 6,
                            growth_rate: int = 32, bn_size: int = 4,
                            num_classes: int = 6,
                            double_softmax: bool = False,
                            in_channels: int = 3,
                            image_size: tuple[int, int] = (64, 64)
                            ) -> list[nn.Module]:
    """The layer list; its count matches the reference's ``nlayers = 3 +
    (2·(dense_blocks-1)+1) + 2``."""
    if dense_blocks < 1:
        raise ValueError("model requires at least one dense block")
    num_features = growth_rate * 2
    layers: list[nn.Module] = [Stem(num_features, in_channels),
                               StemNorm(num_features), StemPool()]
    for _ in range(dense_blocks - 1):
        layers.append(DenseBlock(num_features, dense_layers, growth_rate,
                                 bn_size))
        num_features += dense_layers * growth_rate
        layers.append(Transition(num_features, num_features // 2))
        num_features //= 2
    layers.append(DenseBlock(num_features, dense_layers, growth_rate,
                             bn_size))
    num_features += dense_layers * growth_rate
    ph, pw = pooled_size(image_size, dense_blocks)
    layers.append(GlobalPool())
    layers.append(Classifier(ph * pw * num_features, num_classes,
                             double_softmax))
    return layers


class DenseNet(nn.Module):
    """DenseNet-BC over NHWC images of ``image_size`` (the head's width
    depends on it, as flax infers it); ``dtype`` is the compute dtype (the
    parameters and BatchNorm statistics stay f32)."""

    def __init__(self, dense_blocks: int = 2, dense_layers: int = 6,
                 growth_rate: int = 32, bn_size: int = 4,
                 num_classes: int = 6, double_softmax: bool = False,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 image_size: tuple[int, int] = (64, 64)):
        super().__init__()
        self.dense_blocks, self.dense_layers = dense_blocks, dense_layers
        self.dtype = dtype
        self.layers = nn.ModuleList(densenet_layer_sequence(
            dense_blocks, dense_layers, growth_rate, bn_size, num_classes,
            double_softmax, in_channels, tuple(image_size)))
        # conv weights channels-last, as the activations and so as cuDNN's
        # weight gradients are: DDP's buckets take the parameters' strides
        self.to(memory_format=torch.channels_last)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisers: ``he_normal`` convolutions,
        ``lecun_normal`` head, zero biases, BN scale 1, bias 0, mean 0,
        var 1."""
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return run_layers(self.layers, x, remat)


def _bn_state(params, stats, prefix: str) -> dict:
    return {f"{prefix}.weight": as_tensor(params["scale"]),
            f"{prefix}.bias": as_tensor(params["bias"]),
            f"{prefix}.running_mean": as_tensor(stats["mean"]),
            f"{prefix}.running_var": as_tensor(stats["var"])}


def load_flax_variables(variables) -> dict:
    """``state_dict`` for :class:`DenseNet` from the flax model's
    ``{"params", "batch_stats"}`` (numpy arrays): conv kernels
    ``(kh, kw, in, out)`` → ``(out, in, kh, kw)``, BN ``scale/bias`` →
    ``weight/bias`` and ``batch_stats`` ``mean/var`` → the running
    buffers, the ``Dense`` kernel transposed."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {"layers.0.conv.weight":
          conv2d_weight(params["Stem_0"]["Conv_0"]["kernel"])}
    sd.update(_bn_state(params["StemNorm_0"]["BatchNorm_0"],
                        stats["StemNorm_0"]["BatchNorm_0"], "layers.1.norm"))
    pos, b = 3, 0
    while f"DenseBlock_{b}" in params:
        block = DenseBlock.flax_state(params[f"DenseBlock_{b}"],
                                      stats[f"DenseBlock_{b}"])
        sd.update({f"layers.{pos}.{k}": v for k, v in block.items()})
        pos += 1
        if f"Transition_{b}" in params:
            trans = Transition.flax_state(params[f"Transition_{b}"],
                                          stats[f"Transition_{b}"])
            sd.update({f"layers.{pos}.{k}": v for k, v in trans.items()})
            pos += 1
        b += 1
    sd.update(dense_state(params["Classifier_0"]["Dense_0"],
                          f"layers.{pos + 1}.dense"))
    return sd
