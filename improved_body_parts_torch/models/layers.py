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

A forward inside :class:`height_sharded` runs on one rank's rows of a
height split (``parallel.spatial``): each convolution that pads the
height takes those rows from the neighbouring ranks (the stride-2 stem
its ``SAME`` split of the global height), the SE layers take the global
mean, and everything else (1x1 convolutions, eval-mode BN, the pools, the
upsamples) runs unchanged on the rows it has.  Outside it the layers run
the plain forward.

Weight init matches the JAX package (reference: models/posenet.py:119-139):
conv N(0, 0.001), dense N(0, 0.01), biases zero, BN (1, 0); the BN-free
Associative-Embedding lineage draws its convs from N(0, 0.01)
(``AE_CONV_STD``; a conv's ``init_std`` attribute overrides the default).
"""
from __future__ import annotations

import threading
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01
CONV_STD = 0.001
DENSE_STD = 0.01
AE_CONV_STD = 0.01


_SHARD = threading.local()


def active_shard():
    """The height shard this thread's forward runs on (a
    ``parallel.spatial.HeightShard``), or None."""
    return getattr(_SHARD, "shard", None)


class height_sharded:
    """Context in which the layers run on this thread on ``shard``'s rows
    of a height split (``parallel.spatial.HeightShard``: its ``halo``,
    ``mean_hw`` and ``global_height``).  A thread-local, so another
    thread's forward (a serving replica's) stays plain."""

    def __init__(self, shard):
        self.shard = shard

    def __enter__(self):
        self.prev = active_shard()
        _SHARD.shard = self.shard
        return self.shard

    def __exit__(self, *exc):
        _SHARD.shard = self.prev
        return False


def _conv_rows(conv, x, pad_w: int):
    """``conv`` (an ``nn.Conv2d``, or an int8 layer around one) over
    ``x`` whose height padding is already in place: only the width pads
    (``pad_w`` on each side)."""
    layer = getattr(conv, "layer", conv)
    weight = conv.dequantized() if hasattr(conv, "dequantized") \
        else conv.weight
    return F.conv2d(x, weight, conv.bias, layer.stride, (0, pad_w),
                    layer.dilation, layer.groups)


def same_conv(conv, x):
    """``conv(x)`` for a stride-1 conv with symmetric padding; on a height
    shard its height padding is the neighbouring ranks' rows."""
    shard = active_shard()
    layer = getattr(conv, "layer", conv)
    if shard is None or layer.padding[0] == 0:
        return conv(x)
    p = layer.padding[0]
    return _conv_rows(conv, shard.halo(x, p, p), layer.padding[1])


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
        # the process group of the ranks that split the batch (set by
        # the train step when there is more than one): train mode then
        # normalises with the statistics of the global batch
        self.group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._cross_rank(x)
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
            self._update_running(mean, var)
        return y

    def _update_running(self, mean, var):
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)

    def _cross_rank(self, x):
        """Train mode over the global batch, normalised as the one-rank
        path's ``F.batch_norm`` does: the per-channel mean from Σx and
        the count summed over ``self.group``, then the variance from the
        centred Σ(x - mean)² summed again (two passes, so float32 loses
        nothing to the cancellation in ``mean(x²) - mean(x)²``).  Both
        sums go through the differentiable ``all_reduce``, whose backward
        sums the gradient over the same ranks: the gradient a rank's
        loss sends back through the sums reaches every rank's rows, so
        the data ranks' gradients summed are the single-process step's.
        The running stats take Flax's ``mean(x²) - mean(x)²``, as the
        one-rank path's do, from a Σx² summed with the mean.  Reduced in
        float32 (float64 for a float64 input)."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        dims = (0, 2, 3)
        shape = (1, c, 1, 1)
        count = torch.full((1,), x.numel() // c, dtype=dt, device=x.device)
        with torch.no_grad():
            sq = (xf * xf).sum(dims)
        sums = all_reduce(torch.cat([xf.sum(dims), count, sq]),
                          group=self.group)
        n = sums[c]
        mean = sums[:c] / n
        xc = xf - mean.view(shape)
        var = all_reduce((xc * xc).sum(dims), group=self.group) / n
        if self.update_stats:
            with torch.no_grad():
                fast = torch.clamp(sums[c + 1:] / n - mean * mean, min=0.0)
                self._update_running(mean.detach(), fast)
        y = xc * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.to(dt).view(shape) + self.bias.to(dt).view(shape)
        return y.to(x.dtype)


def set_batch_norm_group(module: nn.Module, group) -> None:
    """Every :class:`BatchNorm` of ``module`` normalises over the ranks
    of ``group`` in train mode (None: over this rank's rows only)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
    """conv + optional BN + activation (reference:
    layers_transposed.py:90-120).

    With BN the conv has no bias; without BN it does, as in the Flax model.
    ``activation`` is ``"leaky"`` (LeakyReLU 0.01) or ``"relu"`` (the AE
    lineage, ae_layer.py:53-54); ``init_std`` is the conv's init scale.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, use_bn: bool = True, relu: bool = True,
                 dilation: int = 1, activation: str = "leaky",
                 init_std: float = CONV_STD):
        super().__init__()
        if stride == 1 and kernel_size % 2 == 0:
            raise ValueError("even stride-1 kernels need asymmetric SAME "
                             "padding; no IMHN layer uses one")
        if activation not in ("leaky", "relu"):
            raise ValueError(f"activation {activation!r} not leaky/relu")
        self.stride = stride
        self.kernel_size = kernel_size
        self.dilation = dilation
        pad = 0 if stride > 1 else dilation * (kernel_size - 1) // 2
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=pad, dilation=dilation,
                              bias=not use_bn)
        self.conv.init_std = init_std
        self.bn = BatchNorm(cout) if use_bn else None
        self.relu = relu
        self.activation = activation

    def forward(self, x):
        if self.stride > 1:
            shard = active_shard()
            geometry = (self.kernel_size, self.stride, self.dilation)
            pw = same_padding(x.shape[3], *geometry)
            if shard is None:
                ph = same_padding(x.shape[2], *geometry)
                x = self.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))
            else:
                # SAME's split of the global height; a shard starts on an
                # even row, so its outputs are the global ones
                ph = same_padding(shard.global_height(x.shape[2]),
                                  *geometry)
                x = _conv_rows(self.conv, F.pad(shard.halo(x, *ph),
                                                (pw[0], pw[1])), 0)
        else:
            x = same_conv(self.conv, x)
        if self.bn is not None:
            x = self.bn(x)
        if not self.relu:
            return x
        return F.relu(x) if self.activation == "relu" else leaky_relu(x)


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
        y = leaky_relu(self.bn2(same_conv(self.conv2, y)))
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
        shard = active_shard()
        y = x.mean(dim=(2, 3)) if shard is None else shard.mean_hw(x)
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


class BackboneSimple(nn.Module):
    """Stride-4 stem without the dilated branch: 7x7/2 conv →
    Residual(128) → maxpool/2 → Residual(128) → Residual(features)
    (reference: layers_transposed_final.py:82-107)."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.stem = ConvBlock(3, 64, kernel_size=7, stride=2)
        self.res1 = Residual(64, 128)
        self.res2 = Residual(128, 128)
        self.res3 = Residual(128, features)

    def forward(self, x):
        x = self.res2(max_pool_2x2(self.res1(self.stem(x))))
        return self.res3(x)


class ConvStem(nn.Module):
    """Plain conv stem of the light and AE networks (posenet3.py:56-62,
    ae_pose.py): 7x7/2 conv(64) → conv(128) → maxpool/2 → conv(128) →
    conv(features); ``block`` holds the ConvBlock options (the AE stem is
    BN-free with ReLU)."""

    def __init__(self, features: int = 256, **block):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBlock(3, 64, kernel_size=7, stride=2, **block),
            ConvBlock(64, 128, kernel_size=3, **block),
            ConvBlock(128, 128, kernel_size=3, **block),
            ConvBlock(128, features, kernel_size=3, **block)])

    def forward(self, x):
        x = self.convs[1](self.convs[0](x))
        return self.convs[3](self.convs[2](max_pool_2x2(x)))


class HourglassFinal(nn.Module):
    """The 'final' hourglass cell (reference:
    layers_transposed_final.py:111-199): all-conv blocks, a skip branch
    without its activation, two refine convs after the upsample (the
    second without activation) and LeakyReLU after the add.  Returns the
    depth+1 scales, largest first, like :class:`Hourglass`."""

    def __init__(self, depth: int = 4, features: int = 256,
                 increase: int = 128):
        super().__init__()

        def ch(i):
            return features + increase * i

        self.depth = depth
        self.skips = nn.ModuleList(ConvBlock(ch(i), ch(i), relu=False)
                                   for i in range(depth))
        self.downs = nn.ModuleList(ConvBlock(ch(i), ch(i + 1))
                                   for i in range(depth))
        self.inner = ConvBlock(ch(depth), ch(depth))
        levels = list(reversed(range(depth)))
        self.lows = nn.ModuleList(ConvBlock(ch(i + 1), ch(i)) for i in levels)
        self.refines = nn.ModuleList(
            nn.Sequential(ConvBlock(ch(i), ch(i)),
                          ConvBlock(ch(i), ch(i), relu=False))
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
            y = leaky_relu(skips[i] + refined)
            scales.append(y)
        return scales[::-1]


class HourglassAE(nn.Module):
    """The classic single-output hourglass of the Associative-Embedding
    lineage (reference: models/ae_layer.py:68-91): 3x3 convs with bias
    and ReLU, N(0, 0.01) init, nearest upsample, recursive; returns one
    map at the input's scale."""

    def __init__(self, depth: int = 4, features: int = 256,
                 increase: int = 128):
        super().__init__()
        nf = features + increase

        def conv(cin, cout):
            c = nn.Conv2d(cin, cout, 3, padding=1, bias=True)
            c.init_std = AE_CONV_STD
            return c

        self.up1 = conv(features, features)
        self.low1 = conv(features, nf)
        self.low2 = (HourglassAE(depth - 1, nf, increase) if depth > 1
                     else conv(nf, nf))
        self.nested = depth > 1
        self.low3 = conv(nf, features)

    def forward(self, x):
        up1 = F.relu(same_conv(self.up1, x))
        low1 = F.relu(same_conv(self.low1, max_pool_2x2(x)))
        low2 = (self.low2(low1) if self.nested
                else F.relu(same_conv(self.low2, low1)))
        return up1 + upsample_nearest_2x(F.relu(same_conv(self.low3, low2)))


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init matching the JAX package's initializers: conv
    N(0, 0.001) (the AE lineage's N(0, 0.01): a conv's ``init_std``),
    dense N(0, 0.01), biases zero, BN scale 1 / bias 0, running stats
    (0, 1).  Draws on a CPU generator, so one seed gives the same weights
    whatever device the model later moves to."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (getattr(m, "init_std", CONV_STD)
                       if isinstance(m, nn.Conv2d) else DENSE_STD)
                m.weight.copy_(torch.empty(m.weight.shape).normal_(
                    0.0, std, generator=gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
