"""Multi-scale masked focal L2 loss (counterpart of
``improved_body_parts_tpu/ops/losses.py``), channels-last like the JAX
package: predictions (N, H, W, C) from the NHWC model, GT from the
heatmapper.

Semantics are the reference's distributed loss (loss_model.py): focal
factor ``|1 - st|`` with ``st = where(gt >= 0.01, pred - alpha, 1 - pred -
beta)``, task weights on the person-mask and keypoint channels as a (C,)
vector, per-scale GT average pooling and a bilinear, antialiased miss-mask
resize binarised at 0.5, scale losses combined by ``scale_weight`` and
divided by the global batch.

:func:`focal_l2` with ``gamma=1``, ``alpha=beta=0`` and a ``chan`` vector
(the form :func:`multi_task_loss` uses) goes through
``ops.cuda_focal.focal_l2_fused``: the hand-written kernels on a CUDA
tensor, their plain versions on a CPU one.  Other gammas, :func:`l2` and
:func:`l1` are plain PyTorch; the JAX package has no kernel for them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import Config
from .cuda_focal import focal_l2_fused


def avg_pool_to(x: torch.Tensor, size) -> torch.Tensor:
    """Adaptive average pool NHWC -> (N, size[0], size[1], C) for integer
    ratios (replaces F.adaptive_avg_pool2d, loss_model.py:52)."""
    n, h, w, c = x.shape
    th, tw = size
    if h % th or w % tw:
        raise ValueError(f"avg_pool_to: {(h, w)} is not a multiple of "
                         f"{tuple(size)}")
    kh, kw = h // th, w // tw
    if kh == 1 and kw == 1:
        return x
    return x.reshape(n, th, kh, tw, kw, c).mean(dim=(2, 4))


def downsample_mask(mask: torch.Tensor, size) -> torch.Tensor:
    """Bilinear-resize the (N, H, W, C) miss mask, then zero everything
    below 0.5 (loss_model.py:55-56).  ``jax.image.resize`` antialiases
    when it downsamples; ``antialias=True`` matches it (within 1.2e-7 on
    the CPU; without it the error is 0.26)."""
    n, h, w, c = mask.shape
    th, tw = size
    if (h, w) != (th, tw):
        mask = F.interpolate(mask.permute(0, 3, 1, 2), size=(th, tw),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)
    return torch.where(mask < 0.5, torch.zeros_like(mask), mask)


def _chan_scale(num_layers: int, heat_start: int, bkg_start: int,
                multi_task_weight: float, keypoint_task_weight: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-channel task weights (loss_model.py:146-149): person-mask channel
    x multi_task_weight, keypoint channels x keypoint_task_weight."""
    chan = torch.ones((num_layers,), dtype=dtype, device=device)
    chan[heat_start:bkg_start] *= keypoint_task_weight
    chan[bkg_start] *= multi_task_weight
    return chan


def _unstacked(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` without its size-1 stack axis: a (1, N, H, W, C) label
    broadcast over the stacks -> (N, H, W, C); None for anything else."""
    if t.dim() == 5 and t.shape[0] == 1:
        return t[0]
    if t.dim() == 4:
        return t
    return None


def focal_l2(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
             gamma: float = 1.0, alpha: float = 0.0, beta: float = 0.0,
             chan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-stack focal L2 (loss_model.py:133-161).  pred: (S, N, H, W, C);
    gt and mask broadcast along the stack axis.  Returns (S,) sums.

    The kernel form (gamma 1, alpha = beta = 0, a (C,) ``chan``, gt and a
    one-channel mask shared by every stack) goes to ``focal_l2_fused``.
    Any other form is plain PyTorch autograd, whose gradient at the kink
    ``|1 - st| = 0`` is 0 where JAX's is +-1."""
    g, m = _unstacked(gt), _unstacked(mask)
    if (gamma == 1.0 and alpha == 0.0 and beta == 0.0 and chan is not None
            and g is not None and m is not None and m.shape[-1] == 1
            and g.shape == pred.shape[1:] and m.shape == g.shape[:-1] + (1,)):
        return focal_l2_fused(pred, g, m, chan)
    st = torch.where(gt >= 0.01, pred - alpha, 1.0 - pred - beta)
    factor = torch.abs(1.0 - st)
    if gamma != 1.0:
        factor = factor ** gamma
    out = (pred - gt) ** 2 * factor * mask
    if chan is not None:
        out = out * chan
    return out.sum(dim=(1, 2, 3, 4))


def l2(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
       chan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain masked L2 (loss_model.py:102-131).  Same shapes as focal_l2."""
    out = (pred - gt) ** 2 * mask
    if chan is not None:
        out = out * chan
    return out.sum(dim=(1, 2, 3, 4))


def l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor
       ) -> torch.Tensor:
    """Masked L1 for offset regression (loss_model.py:83-100); per-stack
    sums over (S, N, H, W, C)."""
    return (torch.abs(pred - gt) * mask).sum(dim=(1, 2, 3, 4))


def multi_task_loss(preds: Sequence[Sequence[torch.Tensor]],
                    gt: torch.Tensor, mask_miss: torch.Tensor,
                    config: Config, use_focal: bool = True) -> torch.Tensor:
    """Total training loss over nstack stacks x nscale scales.

    :param preds: [nstack][nscale] NHWC float32 predictions
    :param gt: (N, H, W, num_layers) GT heatmaps at stride 4
    :param mask_miss: (N, H, W, 1) miss mask in [0, 1]
    :returns: scalar, the per-stack losses weighted by nstack_weight and
        scale_weight, divided by the global batch size when
        ``normalize_by_global_batch`` (loss_model.py:34-40, 133-161)
    """
    sk, tr = config.skeleton, config.train
    nstack, nscale = len(preds), len(preds[0])
    if len(tr.scale_weight) != nscale or len(tr.nstack_weight) != nstack:
        raise ValueError(f"{nstack} stacks x {nscale} scales of predictions "
                         f"against nstack_weight {tr.nstack_weight} and "
                         f"scale_weight {tr.scale_weight}")
    dev = gt.device
    # a non_blocking copy: with non_blocking=False the host would wait
    # for the device to finish the forward before the loss is enqueued
    nstack_w = torch.tensor(tr.nstack_weight, dtype=torch.float32).to(
        dev, non_blocking=True)
    scale_w = list(tr.scale_weight)
    chan = _chan_scale(sk.num_layers, sk.heat_start, sk.bkg_start,
                       tr.multi_task_weight, tr.keypoint_task_weight,
                       device=dev)
    loss_fn = focal_l2 if use_focal else l2
    total = 0.0
    for s in range(nscale):
        pred_s = torch.stack([preds[i][s] for i in range(nstack)], dim=0)
        size = pred_s.shape[2:4]
        gt_s = avg_pool_to(gt, size)
        mask_s = downsample_mask(mask_miss, size)
        per_stack = loss_fn(pred_s, gt_s[None], mask_s[None], chan=chan)
        total = (total + (per_stack * nstack_w).sum() / nstack_w.sum()
                 * scale_w[s])
    total = total / sum(scale_w)
    if tr.normalize_by_global_batch:
        total = total / gt.shape[0]
    return total
