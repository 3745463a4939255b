"""The IMHN PoseNet and its variants in PyTorch (counterpart of
``improved_body_parts_tpu/models/posenet.py``).

Architecture: stride-4 Backbone stem → ``nstack`` hourglasses, each emitting
5 scales of features; per scale a Features head (2 convs + SE) and a 1x1
output head regress ``num_layers`` channels; identity connections carry
merged features+predictions across stacks at every scale
(reference: models/posenet.py:82-117).

``PoseNet(images)`` takes NHWC images in [0, 1] and returns ``[nstack][5]``
NHWC float32 predictions, largest scale first, like the Flax model.

Variants (``config.model.variant``), as the JAX package's ``build_model``:

- ``imhn``: :class:`PoseNet`, the production 4-stack network;
- ``imhn_independent``: :class:`PoseNet` without the cross-stack
  residual (posenet_independent.py:1-3);
- ``imhn_light``: :class:`PoseNetLight` (posenet3.py), plain conv stem,
  SE before the cache add, one full-width conv per scale;
- ``imhn_final``: :class:`PoseNetFinal` (posenet_final.py), simple
  backbone, the 'final' hourglass, SE before the cache add and
  compress-first Features heads;
- ``imhn_wide``: :class:`PoseNetWide` (posenet2.py), full-width heads and
  BN-free merges;
- ``ae``: :class:`PoseNetAE` (ae_pose.py), BN-free with ReLU and one
  full-resolution output per stack (``[nstack][1]``).

Compute type follows ``build_model``: bf16 under autocast with fp32
parameters when ``config.train.bf16_compute`` (the Flax ``dtype=bf16,
param_dtype=fp32`` split), fp32 on request.  ``build_model(train=True)``
returns the model in train mode: BatchNorm normalises with batch
statistics and updates its running averages (``models.layers.BatchNorm``),
and the predictions carry gradients.  ``remat`` recomputes each hourglass
in the backward pass (``torch.utils.checkpoint``, the Flax ``nn.remat``):
the recomputation leaves BN's running stats alone, so they are updated
once a step, as in Flax.  As in the JAX package, only ``imhn`` and
``imhn_independent`` honour ``remat``.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import Config
from .layers import (
    AE_CONV_STD,
    Backbone,
    BackboneSimple,
    ConvBlock,
    ConvStem,
    Hourglass,
    HourglassAE,
    HourglassFinal,
    SELayer,
    frozen_bn_stats,
    init_weights,
)


class Features(nn.Module):
    """Per-scale pre-regression head: 2x Conv3x3 + SE
    (reference: models/posenet.py:24-40).  Scale ``j`` comes in at
    ``inp_dim + j*increase`` channels and leaves at ``inp_dim``."""

    def __init__(self, inp_dim: int, increase: int, nscale: int,
                 se_reduction: int = 16):
        super().__init__()
        self.heads = nn.ModuleList(
            nn.Sequential(
                ConvBlock(inp_dim + j * increase, inp_dim, kernel_size=3),
                ConvBlock(inp_dim, inp_dim, kernel_size=3),
                SELayer(inp_dim, se_reduction))
            for j in range(nscale))

    def forward(self, fms):
        return [head(f) for head, f in zip(self.heads, fms)]


class MergeHead(nn.Module):
    """One scale's output head and, on non-final stacks, the merge of
    prediction + features back to the scale's width
    (reference: posenet.py:102-114).  ``merge_bn=False`` gives the merge
    convs a bias and no BN (the wide variant, posenet2.py:65-75); ``block``
    holds further ConvBlock options (the AE lineage's)."""

    def __init__(self, inp_dim: int, width: int, oup_dim: int, last: bool,
                 merge_bn: bool = True, **block):
        super().__init__()
        self.pred = ConvBlock(inp_dim, oup_dim, kernel_size=1, relu=False,
                              **dict(block, use_bn=False))
        if last:
            self.merge_pred = self.merge_feat = None
        else:
            kw = dict(block, use_bn=merge_bn and block.get("use_bn", True))
            self.merge_pred = ConvBlock(oup_dim, width, kernel_size=1,
                                        relu=False, **kw)
            self.merge_feat = ConvBlock(inp_dim, width, kernel_size=1,
                                        relu=False, **kw)

    def forward(self, f):
        pred = self.pred(f)
        if self.merge_pred is None:
            return pred, None
        return pred, self.merge_pred(pred) + self.merge_feat(f)


class _StackedNet(nn.Module):
    """The NHWC entry shared by the variants: the input cast to the
    parameters' float type (a no-op for the fp32 model; bf16 under bf16
    storage; int8 storage keeps biases and norms fp32), bf16 autocast when
    built so, the subclass's ``stacks(x)`` (NCHW features in,
    ``[nstack][nscale]`` NCHW predictions out), and NHWC fp32 predictions
    out.  A subclass sets ``total_stride``, the input rows of one bottom
    row (4 x 2^hourglass_depth): the unit a height split deals out
    (``parallel.spatial``)."""

    compute_dtype = torch.float32

    def forward(self, images: torch.Tensor) -> List[List[torch.Tensor]]:
        """images: (N, H, W, 3) float in [0, 1] → [nstack][nscale] NHWC
        fp32."""
        dtype = next(p.dtype for p in self.parameters()
                     if p.is_floating_point())
        x = images.permute(0, 3, 1, 2).to(dtype)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            return [[p.permute(0, 2, 3, 1).float() for p in stack]
                    for stack in self.stacks(x)]

    def _regress(self, heads, feats, x, cache):
        """Every scale's output head; the scale-0 merge feeds the next
        stack's input and each merge refreshes the cross-stack cache."""
        preds = []
        for j, (head, f) in enumerate(zip(heads, feats)):
            pred, merged = head(f)
            preds.append(pred)
            if merged is not None:
                if j == 0:
                    x = x + merged
                cache[j] = merged
        return preds, x


def _heads(nstack, nscale, widths, oup_dim, merge_widths, merge_bn=True):
    """The ``[nstack][nscale]`` MergeHeads: scale ``j`` reads
    ``widths[j]`` channels and merges back to ``merge_widths[j]``."""
    return nn.ModuleList(
        nn.ModuleList(MergeHead(widths[j], merge_widths[j], oup_dim,
                                last=i == nstack - 1, merge_bn=merge_bn)
                      for j in range(nscale))
        for i in range(nstack))


class PoseNet(_StackedNet):
    """Stacked IMHN (reference: models/posenet.py:43-117);
    ``cross_stack_residual=False`` is the independent ablation."""

    def __init__(self, nstack: int = 4, inp_dim: int = 256, oup_dim: int = 50,
                 increase: int = 128, hourglass_depth: int = 4,
                 cross_stack_residual: bool = True, se_reduction: int = 16,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        nscale = hourglass_depth + 1
        widths = [inp_dim + j * increase for j in range(nscale)]
        self.nstack = nstack
        self.total_stride = 4 * 2 ** hourglass_depth
        self.remat = remat
        self.cross_stack_residual = cross_stack_residual
        self.compute_dtype = compute_dtype
        self.backbone = Backbone(features=inp_dim)
        self.hourglasses = nn.ModuleList(
            Hourglass(hourglass_depth, inp_dim, increase)
            for _ in range(nstack))
        self.features = nn.ModuleList(
            Features(inp_dim, increase, nscale, se_reduction)
            for _ in range(nstack))
        self.outs = _heads(nstack, nscale, [inp_dim] * nscale, oup_dim,
                           widths)

    def stacks(self, x):
        x = self.backbone(x)
        preds: List[List[torch.Tensor]] = []
        cache: List[Optional[torch.Tensor]] = [None] * len(self.outs[0])
        for i in range(self.nstack):
            feats = self._hourglass(i, x)
            if self.cross_stack_residual and i > 0:
                feats = [f + c for f, c in zip(feats, cache)]
            stack, x = self._regress(self.outs[i], self.features[i](feats),
                                     x, cache)
            preds.append(stack)
        return preds

    def _hourglass(self, i: int, x: torch.Tensor) -> List[torch.Tensor]:
        hg = self.hourglasses[i]
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return hg(x)
        return checkpoint(
            hg, x, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_bn_stats(hg)))


class _AttendedNet(_StackedNet):
    """The light, final and wide variants: per stack an hourglass, a
    full-width SE gate on each scale BEFORE the cross-stack cache add,
    a per-scale head (``head``), then the output heads and merges."""

    def __init__(self, backbone, hourglass, nstack, inp_dim, oup_dim,
                 increase, hourglass_depth, se_reduction, compute_dtype,
                 head, head_out_full_width, merge_bn=True):
        super().__init__()
        nscale = hourglass_depth + 1
        widths = [inp_dim + j * increase for j in range(nscale)]
        self.nstack = nstack
        self.total_stride = 4 * 2 ** hourglass_depth
        self.compute_dtype = compute_dtype
        self.backbone = backbone
        self.hourglasses = nn.ModuleList(
            hourglass(hourglass_depth, inp_dim, increase)
            for _ in range(nstack))
        self.attention = nn.ModuleList(
            nn.ModuleList(SELayer(w, se_reduction) for w in widths)
            for _ in range(nstack))
        self.heads = nn.ModuleList(
            nn.ModuleList(head(w) for w in widths) for _ in range(nstack))
        self.outs = _heads(nstack, nscale,
                           widths if head_out_full_width
                           else [inp_dim] * nscale,
                           oup_dim, widths, merge_bn=merge_bn)

    def stacks(self, x):
        x = self.backbone(x)
        preds: List[List[torch.Tensor]] = []
        cache: List[Optional[torch.Tensor]] = [None] * len(self.outs[0])
        for i in range(self.nstack):
            feats = [se(f) for se, f in zip(self.attention[i],
                                            self.hourglasses[i](x))]
            if i > 0:
                feats = [f + c for f, c in zip(feats, cache)]
            feats = [h(f) for h, f in zip(self.heads[i], feats)]
            stack, x = self._regress(self.outs[i], feats, x, cache)
            preds.append(stack)
        return preds


class PoseNetLight(_AttendedNet):
    """Light 4-stage IMHN (reference: models/posenet3.py): plain conv stem
    (posenet3.py:56-62), single-conv full-width Features
    (posenet3.py:34-37), full-width output heads and merges."""

    def __init__(self, nstack=4, inp_dim=256, oup_dim=50, increase=128,
                 hourglass_depth=4, se_reduction=16,
                 compute_dtype=torch.float32):
        super().__init__(ConvStem(inp_dim), Hourglass, nstack, inp_dim,
                         oup_dim, increase, hourglass_depth, se_reduction,
                         compute_dtype, lambda w: ConvBlock(w, w),
                         head_out_full_width=True)


class PoseNetFinal(_AttendedNet):
    """The 'final' IMHN (reference: models/posenet_final.py): simple
    backbone, the 'final' hourglass, Features heads that 1x1-compress the
    scale width first (posenet_final.py:37-43)."""

    def __init__(self, nstack=4, inp_dim=256, oup_dim=50, increase=128,
                 hourglass_depth=4, se_reduction=16,
                 compute_dtype=torch.float32):
        super().__init__(
            BackboneSimple(inp_dim), HourglassFinal, nstack, inp_dim,
            oup_dim, increase, hourglass_depth, se_reduction, compute_dtype,
            lambda w: nn.Sequential(ConvBlock(w, inp_dim, kernel_size=1),
                                    ConvBlock(inp_dim, inp_dim),
                                    ConvBlock(inp_dim, inp_dim)),
            head_out_full_width=False)


class PoseNetWide(_AttendedNet):
    """3-stage wide IMHN (reference: models/posenet2.py): dilated
    backbone, Features and output heads at the full per-scale width,
    merges without BN (posenet2.py:65-75)."""

    def __init__(self, nstack=3, inp_dim=256, oup_dim=50, increase=128,
                 hourglass_depth=4, se_reduction=16,
                 compute_dtype=torch.float32):
        super().__init__(
            Backbone(inp_dim), Hourglass, nstack, inp_dim, oup_dim,
            increase, hourglass_depth, se_reduction, compute_dtype,
            lambda w: nn.Sequential(ConvBlock(w, w), ConvBlock(w, w)),
            head_out_full_width=True, merge_bn=False)


class PoseNetAE(_StackedNet):
    """Associative-Embedding-style stacked hourglass (reference:
    models/ae_pose.py:22-58): BN-free ReLU conv stem, one
    full-resolution output per stack, pred+feature merge into the next
    stack.  Returns ``[nstack][1]``."""

    def __init__(self, nstack=4, inp_dim=256, oup_dim=50, increase=128,
                 hourglass_depth=4, compute_dtype=torch.float32):
        super().__init__()
        block = dict(use_bn=False, activation="relu", init_std=AE_CONV_STD)
        self.nstack = nstack
        self.total_stride = 4 * 2 ** hourglass_depth
        self.compute_dtype = compute_dtype
        self.backbone = ConvStem(inp_dim, **block)
        self.hourglasses = nn.ModuleList(
            HourglassAE(hourglass_depth, inp_dim, increase)
            for _ in range(nstack))
        self.features = nn.ModuleList(
            nn.Sequential(ConvBlock(inp_dim, inp_dim, **block),
                          ConvBlock(inp_dim, inp_dim, **block))
            for _ in range(nstack))
        self.outs = nn.ModuleList(
            MergeHead(inp_dim, inp_dim, oup_dim, last=i == nstack - 1,
                      **block)
            for i in range(nstack))

    def stacks(self, x):
        x = self.backbone(x)
        preds = []
        for i in range(self.nstack):
            f = self.features[i](self.hourglasses[i](x))
            pred, merged = self.outs[i](f)
            preds.append([pred])
            if merged is not None:
                x = x + merged
        return preds


VARIANTS = ("imhn", "imhn_independent", "imhn_light", "imhn_final",
            "imhn_wide", "ae")


def build_model(config: Config, dtype: Optional[torch.dtype] = None,
                device="cuda", seed: int = 0, train: bool = False
                ) -> nn.Module:
    """Construct the model selected by ``config.model.variant`` (one of
    :data:`VARIANTS`, as the JAX package's ``build_model``) on ``device``
    (``"cuda"`` unless the caller asks for ``"cpu"``; ``"meta"`` builds
    shapes only, for counting parameters), with seeded weights
    (:func:`models.layers.init_weights`), in eval mode unless ``train``.
    ``dtype`` is the compute type: bf16 when ``config.train.bf16_compute``,
    else fp32.  ``config.model.remat`` is ignored in eval mode (nothing is
    kept for a backward pass)."""
    m = config.model
    if m.variant not in VARIANTS:
        raise ValueError(f"unknown model variant {m.variant!r}")
    if dtype is None:
        dtype = torch.bfloat16 if config.train.bf16_compute else torch.float32
    common = dict(nstack=m.nstack, inp_dim=m.inp_dim,
                  oup_dim=config.skeleton.num_layers, increase=m.increase,
                  hourglass_depth=m.hourglass_depth, compute_dtype=dtype)
    se = dict(se_reduction=m.se_reduction)

    def make():
        if m.variant in ("imhn", "imhn_independent"):
            return PoseNet(cross_stack_residual=m.variant == "imhn",
                           remat=m.remat, **se, **common)
        if m.variant == "ae":
            return PoseNetAE(**common)
        cls = {"imhn_light": PoseNetLight, "imhn_final": PoseNetFinal,
               "imhn_wide": PoseNetWide}[m.variant]
        return cls(**se, **common)

    if str(device) == "meta":
        with torch.device("meta"):
            return make().train(train)
    dev = resolve_device(device)
    model = init_weights(make(), seed)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.to(dev).train(train)
