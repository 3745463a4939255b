"""The IMHN PoseNet in PyTorch (counterpart of
``improved_body_parts_tpu/models/posenet.py``).

Architecture: stride-4 Backbone stem → ``nstack`` hourglasses, each emitting
5 scales of features; per scale a Features head (2 convs + SE) and a 1x1
output head regress ``num_layers`` channels; identity connections carry
merged features+predictions across stacks at every scale
(reference: models/posenet.py:82-117).

``PoseNet(images)`` takes NHWC images in [0, 1] and returns ``[nstack][5]``
NHWC float32 predictions, largest scale first, like the Flax model.

Compute type follows ``build_model``: bf16 under autocast with fp32
parameters when ``config.train.bf16_compute`` (the Flax ``dtype=bf16,
param_dtype=fp32`` split), fp32 on request.  ``build_model(train=True)``
returns the model in train mode: BatchNorm normalises with batch
statistics and updates its running averages (``models.layers.BatchNorm``),
and the predictions carry gradients.  Only the ``imhn`` variant is ported;
``build_model`` raises ``NotImplementedError`` for the other five
(ROADMAP queue).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import Config
from .layers import Backbone, ConvBlock, Hourglass, SELayer, init_weights


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
    (reference: posenet.py:102-114)."""

    def __init__(self, inp_dim: int, width: int, oup_dim: int, last: bool):
        super().__init__()
        self.pred = ConvBlock(inp_dim, oup_dim, kernel_size=1, use_bn=False,
                              relu=False)
        if last:
            self.merge_pred = self.merge_feat = None
        else:
            self.merge_pred = ConvBlock(oup_dim, width, kernel_size=1,
                                        relu=False)
            self.merge_feat = ConvBlock(inp_dim, width, kernel_size=1,
                                        relu=False)

    def forward(self, f):
        pred = self.pred(f)
        if self.merge_pred is None:
            return pred, None
        return pred, self.merge_pred(pred) + self.merge_feat(f)


class PoseNet(nn.Module):
    """Stacked IMHN (reference: models/posenet.py:43-117)."""

    def __init__(self, nstack: int = 4, inp_dim: int = 256, oup_dim: int = 50,
                 increase: int = 128, hourglass_depth: int = 4,
                 cross_stack_residual: bool = True, se_reduction: int = 16,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        nscale = hourglass_depth + 1
        self.nstack = nstack
        self.cross_stack_residual = cross_stack_residual
        self.compute_dtype = compute_dtype
        self.backbone = Backbone(features=inp_dim)
        self.hourglasses = nn.ModuleList(
            Hourglass(hourglass_depth, inp_dim, increase)
            for _ in range(nstack))
        self.features = nn.ModuleList(
            Features(inp_dim, increase, nscale, se_reduction)
            for _ in range(nstack))
        self.outs = nn.ModuleList(
            nn.ModuleList(MergeHead(inp_dim, inp_dim + j * increase, oup_dim,
                                    last=i == nstack - 1)
                          for j in range(nscale))
            for i in range(nstack))

    def forward(self, images: torch.Tensor) -> List[List[torch.Tensor]]:
        """images: (N, H, W, 3) float in [0, 1] → [nstack][5] NHWC fp32."""
        # NHWC → NCHW view: channels-last strides, no copy; in the
        # parameters' type (a no-op for the fp32 model)
        x = images.permute(0, 3, 1, 2).to(self.backbone.stem.conv.weight.dtype)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            x = self.backbone(x)
            preds: List[List[torch.Tensor]] = []
            cache: List[Optional[torch.Tensor]] = [None] * len(self.outs[0])
            for i in range(self.nstack):
                feats = self.hourglasses[i](x)
                if self.cross_stack_residual and i > 0:
                    feats = [f + c for f, c in zip(feats, cache)]
                feats = self.features[i](feats)
                preds_instack = []
                for j, (head, f) in enumerate(zip(self.outs[i], feats)):
                    pred, merged = head(f)
                    preds_instack.append(
                        pred.permute(0, 2, 3, 1).float())
                    if merged is not None:
                        if j == 0:
                            x = x + merged
                        cache[j] = merged
                preds.append(preds_instack)
        return preds


def build_model(config: Config, dtype: Optional[torch.dtype] = None,
                device="cuda", seed: int = 0, train: bool = False
                ) -> PoseNet:
    """Construct the model selected by ``config.model.variant`` on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``; ``"meta"``
    builds shapes only, for counting parameters), with seeded weights
    (:func:`models.layers.init_weights`), in eval mode unless ``train``.
    ``dtype`` is the compute type: bf16 when ``config.train.bf16_compute``,
    else fp32.  ``config.model.remat`` is ignored in eval mode (nothing is
    kept for a backward pass) and not ported for training."""
    m = config.model
    if m.variant != "imhn":
        raise NotImplementedError(
            f"model variant {m.variant!r} is not ported yet; only 'imhn' is "
            "(ROADMAP.md, queue 1: the other five variants)")
    if train and m.remat:
        raise NotImplementedError(
            "remat=True (per-stack rematerialisation) is not ported for "
            "training (ROADMAP.md, queue 1); canonical trains without it")
    if dtype is None:
        dtype = torch.bfloat16 if config.train.bf16_compute else torch.float32
    kw = dict(nstack=m.nstack, inp_dim=m.inp_dim,
              oup_dim=config.skeleton.num_layers, increase=m.increase,
              hourglass_depth=m.hourglass_depth,
              se_reduction=m.se_reduction, compute_dtype=dtype)
    if str(device) == "meta":
        with torch.device("meta"):
            return PoseNet(**kw).train(train)
    dev = resolve_device(device)
    model = init_weights(PoseNet(**kw), seed)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.to(dev).train(train)
