"""PyTorch layer library for the IMHN (Identity-Mapping Hourglass Network).

Counterpart of ``improved_body_parts_tpu/models/layers.py``.  The modules
run NCHW (channels-last in memory on the card, so cuDNN picks its NHWC
kernels); the model's public entry (``models.posenet.PoseNet``) takes and
returns NHWC like the Flax model.

Two numerics details carry the Flax semantics over:

- Flax ``padding="SAME"`` pads a strided conv asymmetrically: the stride-2
  7x7 stem pads (2, 3) on an even input and (3, 3) on an odd one.
  ``nn.Conv2d(padding=3)`` would be off by whole pixels, so a strided
  :class:`ConvBlock` pads explicitly (:func:`same_padding`) and convolves
  unpadded.  Stride-1 convs with odd kernels pad ``dilation*(k-1)/2`` on
  each side, which is what SAME gives there.
- BatchNorm (:class:`BatchNorm`) has eps 1e-5.  In eval mode it uses the
  running averages (Flax ``use_running_average``).  In train mode it
  normalises with the biased batch variance and updates the running stats
  as Flax ``nn.BatchNorm(momentum=0.9)`` does: ``var <- 0.9 var + 0.1
  batch_var`` with the BIASED variance in Flax's fast form
  ``mean(x^2) - mean(x)^2``, reduced in float32.  ``nn.BatchNorm2d``
  would update with the unbiased variance.

Weight init matches the JAX package (reference: models/posenet.py:119-139):
conv N(0, 0.001), dense N(0, 0.01), biases zero, BN (1, 0).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01
CONV_STD = 0.001
DENSE_STD = 0.01


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def max_pool_2x2(x):
    """2x2/2 max pool, VALID (Flax ``nn.max_pool`` default)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample (reference: layers_transposed.py:210)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax train-mode semantics (see the module
    docstring); the ``state_dict`` keys are ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)
        # False while a rematerialised forward recomputes this layer
        # (:class:`frozen_bn_stats`): the stats were updated once already
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            dims = (0, 2, 3)
            n = x.numel() // x.shape[1]
            dt = torch.promote_types(x.dtype, torch.float32)
            mean = torch.mean(x, dim=dims, dtype=dt)
            mean2 = torch.linalg.vector_norm(x, dim=dims,
                                             dtype=dt).square() / n
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return y


class frozen_bn_stats:
    """Context in which every :class:`BatchNorm` of ``module`` normalises
    as in train mode but leaves its running stats alone.  The recompute
    context of a rematerialised forward (``torch.utils.checkpoint``'s
    ``context_fn``): Flax's ``nn.remat`` updates the stats once, in the
    forward pass, and so must the port.  A flag on the modules, not a
    thread-local, since autograd may recompute on its own thread."""

    def __init__(self, module: nn.Module):
        self.bns = [m for m in module.modules() if isinstance(m, BatchNorm)]

    def __enter__(self):
        for bn in self.bns:
            bn.update_stats = False
        return self

    def __exit__(self, *exc):
        for bn in self.bns:
            bn.update_stats = True
        return False


def same_padding(size: int, kernel: int, stride: int, dilation: int
                 ) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis under Flax/XLA ``SAME``."""
    eff = dilation * (kernel - 1) + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """conv + optional BN + LeakyReLU (reference: layers_transposed.py:90-120).

    With BN the conv has no bias; without BN it does, as in the Flax model.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, use_bn: bool = True, relu: bool = True,
                 dilation: int = 1):
        super().__init__()
        if stride == 1 and kernel_size % 2 == 0:
            raise ValueError("even stride-1 kernels need asymmetric SAME "
                             "padding; no IMHN layer uses one")
        self.stride = stride
        self.kernel_size = kernel_size
        self.dilation = dilation
        pad = 0 if stride > 1 else dilation * (kernel_size - 1) // 2
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=pad, dilation=dilation,
                              bias=not use_bn)
        self.bn = BatchNorm(cout) if use_bn else None
        self.relu = relu

    def forward(self, x):
        if self.stride > 1:
            ph = same_padding(x.shape[2], self.kernel_size, self.stride,
                              self.dilation)
            pw = same_padding(x.shape[3], self.kernel_size, self.stride,
                              self.dilation)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return leaky_relu(x) if self.relu else x


class Residual(nn.Module):
    """Bottleneck residual block (reference: layers_transposed.py:12-48):
    1x1 (out/2) → 3x3 (out/2) → 1x1 (out), BN after each conv, LeakyReLU
    between, 1x1+BN skip projection when channel counts differ, LeakyReLU
    after the add."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = cout // 2
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)
        if cin != cout:
            self.skip_conv = nn.Conv2d(cin, cout, 1, bias=False)
            self.skip_bn = BatchNorm(cout)
        else:
            self.skip_conv = self.skip_bn = None

    def forward(self, x):
        y = leaky_relu(self.bn1(self.conv1(x)))
        y = leaky_relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.skip_conv is not None:
            x = self.skip_bn(self.skip_conv(x))
        return leaky_relu(y + x)


class SELayer(nn.Module):
    """Squeeze-and-Excitation channel gate
    (reference: layers_transposed.py:285-306)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        if channels <= reduction:
            raise ValueError(f"input channels {channels} must exceed SE "
                             f"reduction {reduction}")
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc2(leaky_relu(self.fc1(y))))
        return x * y[:, :, None, None]


class Backbone(nn.Module):
    """Stride-4 stem (reference: layers_transposed.py:158-194):
    7x7/2 conv → Residual(64→half) → maxpool/2 → Residual(half) → six
    dilated 3x3 convs (d = 3,3,4,4,5,5) → concat with the pre-dilation
    features → ``features`` channels."""

    def __init__(self, features: int = 256):
        super().__init__()
        half = features // 2
        self.stem = ConvBlock(3, 64, kernel_size=7, stride=2)
        self.res1 = Residual(64, half)
        self.res2 = Residual(half, half)
        self.dilated = nn.ModuleList(
            ConvBlock(half, half, kernel_size=3, dilation=d)
            for d in (3, 3, 4, 4, 5, 5))

    def forward(self, x):
        x = self.res2(max_pool_2x2(self.res1(self.stem(x))))
        y = x
        for conv in self.dilated:
            y = conv(y)
        return torch.cat([x, y], dim=1)


class Hourglass(nn.Module):
    """5-scale hourglass, written iteratively (reference recursion:
    layers_transposed.py:197-282).  Returns features at all depth+1
    scales, largest first: widths ``features + increase * i``."""

    def __init__(self, depth: int = 4, features: int = 256,
                 increase: int = 128):
        super().__init__()

        def ch(i):
            return features + increase * i

        self.depth = depth
        self.skips = nn.ModuleList(Residual(ch(i), ch(i))
                                   for i in range(depth))
        self.downs = nn.ModuleList(Residual(ch(i), ch(i + 1))
                                   for i in range(depth))
        self.inner = Residual(ch(depth), ch(depth))
        # up path in execution order: level depth-1 first
        levels = list(reversed(range(depth)))
        self.lows = nn.ModuleList(Residual(ch(i + 1), ch(i)) for i in levels)
        self.refines = nn.ModuleList(ConvBlock(ch(i), ch(i), kernel_size=3)
                                     for i in levels)

    def forward(self, x) -> List[torch.Tensor]:
        skips = []
        for skip, down in zip(self.skips, self.downs):
            skips.append(skip(x))
            x = down(max_pool_2x2(x))
        y = self.inner(x)
        scales = [y]
        for step, i in enumerate(reversed(range(self.depth))):
            refined = self.refines[step](
                upsample_nearest_2x(self.lows[step](y)))
            y = skips[i] + refined
            scales.append(y)
        return scales[::-1]


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init matching the JAX package's initializers: conv
    N(0, 0.001), dense N(0, 0.01), biases zero, BN scale 1 / bias 0,
    running stats (0, 1).  Draws on a CPU generator, so one seed gives the
    same weights whatever device the model later moves to."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = CONV_STD if isinstance(m, nn.Conv2d) else DENSE_STD
                m.weight.copy_(torch.empty(m.weight.shape).normal_(
                    0.0, std, generator=gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
