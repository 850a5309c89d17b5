"""Vision models of the north-star zoo: the port of
``distributed_deep_learning_tpu/models/resnet.py`` — the ResNet family
(v1.5: the stride in the bottleneck's 3×3) of the ``resnet`` workload and
``MnistCNN`` of the ``mnist`` workload.

The models take NHWC images, as the datasets give them, and permute them
once to an NCHW view that is channels-last in memory (as
:mod:`.densenet` does): cuDNN's tensor-core convolutions prefer it.
Convolutions follow flax's ``Conv``: ``SAME`` padding unless given, which
at stride 2 pads ``(total // 2, total - total // 2)`` and so is
asymmetric, ``(0, 1)``, at an even size (:class:`FlaxConv2d`).  The
BatchNorms are :class:`.densenet.BatchNorm` with ResNet's momentum 0.9
and ε 1e-5 (statistics in f32, over the global batch under a synced ``-m
data``); the last BatchNorm of each residual branch starts with scale 0.
Convolutions draw He fan-out normals, the head flax's ``lecun_normal``.

``stem_s2d`` packs the input space-to-depth (2×2 patches into channels)
and runs the stem as a 4×4 stride-1 convolution whose kernel is
multiplied by a fixed mask: the taps outside the 7×7 window stay zero in
the forward and get zero gradient, so the stem spans exactly the 7×7
stride-2 stem's functions (:func:`space_to_depth_stem_kernel` maps one to
the other).  No Pallas kernel runs in the JAX model, so the convolutions
and matmuls stay cuDNN's and cuBLAS's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models import densenet
from distributed_deep_learning_tpu_torch.models.layers import (
    Conv2d, Dense, as_tensor, conv2d_weight, dense_state, recomputable,
    reset_all, run_layers)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax's convention: running = m·running + (1-m)·batch


def he_fan_out_normal_(w: torch.Tensor, fan_in: int = 0,
                       generator: Optional[torch.Generator] = None):
    """flax ``variance_scaling(2.0, "fan_out", "normal")`` on a torch
    conv weight ``(out, in, kh, kw)``: an untruncated normal of variance
    ``2 / (kh · kw · out)``."""
    del fan_in
    out, _, kh, kw = w.shape
    with torch.no_grad():
        return w.normal_(0.0, (2.0 / (kh * kw * out)) ** 0.5,
                         generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``SAME``: output ``ceil(size / stride)``, the padding split
    with the smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FlaxConv2d(Conv2d):
    """flax ``Conv`` without bias on an NCHW view: ``pad`` is ``"SAME"``
    or explicit ``((top, bottom), (left, right))``; ``mask`` (a fixed
    tensor of the weight's shape) multiplies the weight in the forward."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 pad="SAME", mask: Optional[torch.Tensor] = None):
        super().__init__(cin, cout, kernel, stride=stride, bias=False,
                         init=he_fan_out_normal_)
        self.pad = pad
        if mask is not None:
            self.register_buffer("mask", mask, persistent=False)
        else:
            self.mask = None

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if self.pad == "SAME":
            (t, b), (l, r) = (same_padding(x.shape[2], k, s),
                              same_padding(x.shape[3], k, s))
        else:
            (t, b), (l, r) = self.pad
        w = self.weight if self.mask is None else \
            recomputable(torch.mul, self.weight, self.mask)
        w = recomputable(torch.Tensor.to, w, x.dtype)
        if k == 1 and s > 1 and x.device.type == "cpu":
            # the same function: a 1x1 conv reads one pixel of each
            # window, and SAME pads a 1x1 kernel by 0.  On the CPU torch's
            # oneDNN backward of a strided 1x1 channels-last conv corrupts
            # the heap at small widths (8 -> 16 channels)
            return recomputable(F.conv2d, x[:, :, ::s, ::s], w, kind="conv")
        if t == b and l == r:
            return recomputable(F.conv2d, x, w, None, self.stride, (t, l),
                                kind="conv")
        return recomputable(F.conv2d, recomputable(F.pad, x, (l, r, t, b)),
                            w, None, self.stride, kind="conv")


class BatchNorm(densenet.BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``; ``zero_scale``
    starts the scale at 0 (the last norm of a residual branch)."""

    def __init__(self, num_features: int, zero_scale: bool = False):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.zero_scale = zero_scale

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        if self.zero_scale:
            with torch.no_grad():
                self.weight.zero_()


def _block_state(bp, bs) -> dict:
    """A flax residual block's ``Conv_j``/``BatchNorm_j`` (and ``proj``,
    ``proj_bn``) → ``conv<j>``/``bn<j>`` (``proj``, ``proj_bn``)."""
    sd, j = {}, 0
    while f"Conv_{j}" in bp:
        sd[f"conv{j}.weight"] = conv2d_weight(bp[f"Conv_{j}"]["kernel"])
        sd.update(_bn_state(bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"],
                            f"bn{j}"))
        j += 1
    if "proj" in bp:
        sd["proj.weight"] = conv2d_weight(bp["proj"]["kernel"])
        sd.update(_bn_state(bp["proj_bn"], bs["proj_bn"], "proj_bn"))
    return sd


def _projection(cin: int, cout: int, strides: int):
    """The shortcut's 1×1 conv and norm when the branch changes shape."""
    if cin == cout and strides == 1:
        return None, None
    return FlaxConv2d(cin, cout, 1, strides), BatchNorm(cout)


class BasicBlock(nn.Module):
    """3×3(stride) → 3×3 (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv0 = FlaxConv2d(cin, features, 3, strides)
        self.bn0 = BatchNorm(features)
        self.conv1 = FlaxConv2d(features, features, 3)
        self.bn1 = BatchNorm(features, zero_scale=True)
        self.proj, self.proj_bn = _projection(cin, features, strides)

    def forward(self, x):
        y = recomputable(F.relu, self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        if self.proj is not None:
            x = self.proj_bn(self.proj(x))
        return F.relu(x + y)

    flax_state = staticmethod(_block_state)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3(stride) → 1×1(4×), with a projection shortcut when the
    shape changes."""

    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv0 = FlaxConv2d(cin, features, 1)
        self.bn0 = BatchNorm(features)
        self.conv1 = FlaxConv2d(features, features, 3, strides)
        self.bn1 = BatchNorm(features)
        self.conv2 = FlaxConv2d(features, 4 * features, 1)
        self.bn2 = BatchNorm(4 * features, zero_scale=True)
        self.proj, self.proj_bn = _projection(cin, 4 * features, strides)

    def forward(self, x):
        y = recomputable(F.relu, self.bn0(self.conv0(x)))
        y = recomputable(F.relu, self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        if self.proj is not None:
            x = self.proj_bn(self.proj(x))
        return F.relu(x + y)

    flax_state = staticmethod(_block_state)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Pack ``block×block`` spatial patches into channels (NHWC):
    ``(N, H, W, C) → (N, H/b, W/b, b²·C)``, channels ordered ``(row
    parity, column parity, c)``."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               block * block * c)


def space_to_depth_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Map a ``(O, C, 7, 7)`` stride-2 stem weight to the equivalent
    ``(O, 4C, 4, 4)`` stride-1 weight over :func:`space_to_depth` input
    padded ``(2, 1)``: tap ``a`` of the 7×7 window is ``2u + p - 1`` with
    ``u`` the packed tap and ``p`` the parity; the slots with ``a`` outside
    ``[0, 7)`` stay zero."""
    o, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {(kh, kw)}")
    w4 = w7.new_zeros(o, 4 * c, 4, 4)
    for ua in range(4):
        for pa in range(2):
            a = 2 * ua + pa - 1
            if not 0 <= a < 7:
                continue
            for ub in range(4):
                for pb in range(2):
                    b = 2 * ub + pb - 1
                    if not 0 <= b < 7:
                        continue
                    ch = (pa * 2 + pb) * c
                    w4[:, ch:ch + c, ua, ub] = w7[:, :, a, b]
    return w4


class Stem(nn.Module):
    """Conv → BN → ReLU (→ 3×3 stride-2 max-pool unless small inputs):
    the 3×3 stride-1 conv for small inputs, else the 7×7 stride-2 conv
    padded 3, or under ``s2d`` the masked 4×4 conv over packed input."""

    def __init__(self, width: int, in_channels: int, small_inputs: bool,
                 s2d: bool):
        super().__init__()
        self.small_inputs, self.s2d = small_inputs, s2d
        if small_inputs:
            self.conv = FlaxConv2d(in_channels, width, 3)
        elif s2d:
            mask = space_to_depth_stem_kernel(
                torch.ones(width, in_channels, 7, 7))
            self.conv = FlaxConv2d(4 * in_channels, width, 4,
                                   pad=((2, 1), (2, 1)), mask=mask)
        else:
            self.conv = FlaxConv2d(in_channels, width, 7, 2,
                                   pad=((3, 3), (3, 3)))
        self.bn = BatchNorm(width)

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.small_inputs:
            return F.relu(x)
        return F.max_pool2d(recomputable(F.relu, x), 3, 2, padding=1)


class Head(nn.Module):
    """Global average pool → Dense, logits in f32."""

    def __init__(self, features: int, num_classes: int):
        super().__init__()
        self.dense = Dense(features, num_classes)

    def forward(self, x):
        return self.dense(x.mean(dim=(2, 3))).float()


class ResNet(nn.Module):
    """ImageNet-shaped ResNet over NHWC images; ``stage_sizes`` and
    ``block_cls`` select the depth, ``small_inputs`` the CIFAR stem,
    ``stem_s2d`` the space-to-depth stem; ``dtype`` is the compute dtype
    (the parameters and BatchNorm statistics stay f32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block_cls: type = BottleneckBlock, num_classes: int = 1000,
                 width: int = 64, small_inputs: bool = False,
                 stem_s2d: bool = False, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.stem_s2d = stem_s2d and not small_inputs
        self.stem = Stem(width, in_channels, small_inputs, self.stem_s2d)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, width * 2 ** i, strides))
                cin = width * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Head(cin, num_classes)
        self.to(memory_format=torch.channels_last)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisers: He fan-out normal convolutions, BN scale 1
        (0 at each branch's end), bias 0, mean 0, var 1, a
        ``lecun_normal`` head with zero bias."""
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        x = x.to(self.dtype)
        if self.stem_s2d:
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)
        return run_layers([self.stem, *self.blocks, self.head], x, remat)

    def layer_state_dict(self) -> dict:
        """This model's state dict keyed ``layers.<i>.*`` in the order of
        :func:`resnet_layer_sequence` (stem, blocks, head)."""
        return _keyed({f"layers.{i}": layer for i, layer in
                       enumerate([self.stem, *self.blocks, self.head])})


class ResNetStem(Stem):
    """The input stem as a stage layer (the staged layer list's first;
    the 3×3 or the 7×7 stem, no space-to-depth form, as in JAX's
    ``ResNetStem``)."""

    def __init__(self, width: int, in_channels: int, small_inputs: bool):
        super().__init__(width, in_channels, small_inputs, s2d=False)

    @staticmethod
    def flax_state(params, stats) -> dict:
        sd = {"conv.weight": conv2d_weight(params["Conv_0"]["kernel"])}
        sd.update(_bn_state(params["BatchNorm_0"], stats["BatchNorm_0"],
                            "bn"))
        return sd


class ResNetHead(Head):
    """Global average pool and the classifier as a stage layer."""

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return dense_state(params["Dense_0"], "dense")


def resnet_layer_sequence(stage_sizes: Sequence[int] = (3, 4, 6, 3),
                          block_cls: type = BottleneckBlock,
                          num_classes: int = 1000, width: int = 64,
                          small_inputs: bool = False,
                          in_channels: int = 3) -> list[nn.Module]:
    """:class:`ResNet` as a partitionable layer list (stem, residual
    blocks, head) over the channels-last NCHW view, for the staged
    modes."""
    layers: list[nn.Module] = [ResNetStem(width, in_channels, small_inputs)]
    cin = width
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            strides = 2 if i > 0 and j == 0 else 1
            layers.append(block_cls(cin, width * 2 ** i, strides))
            cin = width * 2 ** i * block_cls.expansion
    layers.append(ResNetHead(cin, num_classes))
    return [layer.to(memory_format=torch.channels_last) for layer in layers]


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block_cls=BottleneckBlock, **kw)


def _flatten_nhwc(x):
    """``(N, C, H, W)`` → ``(N, H·W·C)`` in NHWC order (flax's Flatten)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class MnistCNN(nn.Module):
    """The classic MNIST conv net over NHWC images: Conv3×3(32) → ReLU →
    MaxPool2 → Conv3×3(64) → ReLU → MaxPool2 → Flatten (NHWC order) →
    Dense(128) → ReLU → Dense(classes).  The convolutions are flax's
    default SAME padding (28 → 14 → 7, so 3136 features at 28×28)."""

    def __init__(self, num_classes: int = 10, image_shape=(28, 28, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, W, C = image_shape
        self.dtype = dtype
        self.conv0 = Conv2d(C, 32, 3, padding=1)
        self.conv1 = Conv2d(32, 64, 3, padding=1)
        self.dense0 = Dense((H // 2 // 2) * (W // 2 // 2) * 64, 128)
        self.dense1 = Dense(128, num_classes)
        self.to(memory_format=torch.channels_last)   # as in DenseNet

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisers: ``lecun_normal`` kernels, zero biases."""
        return reset_all(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        del generator                     # no dropout
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return run_layers((self._conv_pool0, self._conv_pool1,
                           self._hidden, self._head), x, remat)

    def _conv_pool0(self, x):
        return F.max_pool2d(recomputable(F.relu, self.conv0(x)), 2, 2)

    def _conv_pool1(self, x):
        return F.max_pool2d(recomputable(F.relu, self.conv1(x)), 2, 2)

    def _hidden(self, x):
        return F.relu(self.dense0(recomputable(_flatten_nhwc, x)))

    def _head(self, x):
        return self.dense1(x).float()

    def layer_state_dict(self) -> dict:
        """This model's state dict keyed ``layers.<i>.*`` in the order of
        the mnist workload's staged layer list (two conv-pools, the dense
        head)."""
        return _keyed({"layers.0.conv": self.conv0,
                       "layers.1.conv": self.conv1,
                       "layers.2.dense0": self.dense0,
                       "layers.2.dense1": self.dense1})


def _keyed(modules: dict) -> dict:
    return {f"{prefix}.{k}": v for prefix, module in modules.items()
            for k, v in module.state_dict().items()}


def _bn_state(params, stats, prefix: str) -> dict:
    return {f"{prefix}.weight": as_tensor(params["scale"]),
            f"{prefix}.bias": as_tensor(params["bias"]),
            f"{prefix}.running_mean": as_tensor(stats["mean"]),
            f"{prefix}.running_var": as_tensor(stats["var"])}


def _resnet_state(params, stats) -> dict:
    """:class:`ResNet`'s ``state_dict`` from flax's tree: ``stem_conv`` or
    ``stem_conv_s2d``, ``stem_bn``, the blocks numbered across stages
    (``BasicBlock_k``/``BottleneckBlock_k`` with ``Conv_j``,
    ``BatchNorm_j``, ``proj``, ``proj_bn``) and ``Dense_0``."""
    stem = params.get("stem_conv", params.get("stem_conv_s2d"))
    sd = {"stem.conv.weight": conv2d_weight(stem["kernel"])}
    sd.update(_bn_state(params["stem_bn"], stats["stem_bn"], "stem.bn"))
    names = sorted((k for k in params if "Block_" in k),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(names):
        sd.update({f"blocks.{i}.{k}": v for k, v in
                   _block_state(params[name], stats[name]).items()})
    sd.update(dense_state(params["Dense_0"], "head.dense"))
    return sd


def load_flax_variables(variables) -> dict:
    """``state_dict`` for :class:`ResNet` or :class:`MnistCNN` from the
    flax model's variables (numpy arrays): conv kernels ``(kh, kw, in,
    out)`` → ``(out, in, kh, kw)``, ``Dense`` kernels transposed, and for
    the ResNet BN ``scale/bias`` → ``weight/bias`` and ``batch_stats``
    ``mean/var`` → the running buffers."""
    p = variables["params"]
    if "stem_bn" in p:
        return _resnet_state(p, variables["batch_stats"])
    sd = {}
    for i in (0, 1):
        sd[f"conv{i}.weight"] = conv2d_weight(p[f"Conv_{i}"]["kernel"])
        sd[f"conv{i}.bias"] = as_tensor(p[f"Conv_{i}"]["bias"])
        sd.update(dense_state(p[f"Dense_{i}"], f"dense{i}"))
    return sd
