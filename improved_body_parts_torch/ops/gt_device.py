"""Ground-truth heatmap synthesis on the device (counterpart of
``improved_body_parts_tpu/ops/gt_device.py``).

The label tensor is made on the device from padded joint coordinates, so
only (people, parts, 3) joints and the two masks cross the host→device
copy instead of the (H/4, W/4, 50) float maps.  The JAX package computes
it outside any Pallas kernel, and so does the port: plain PyTorch ops over
the whole batch, vectorised over batch × people × parts (a loop per
person would put hundreds of launches into every step).

Semantics match the host heatmapper (``data.heatmapper``):

- keypoint Gaussians evaluated at the stride-center coordinates,
  combined by max over people, restricted to the reference's square
  window around the joint's grid cell (py_data_heatmapper.py:111-131);
  the cell is ``round(x / stride)`` rounded half to even, as
  ``jnp.round`` and ``torch.round`` both do;
- limb maps: a Gaussian of the distance to the segment's line inside the
  segment's box padded by ``paf_thre`` (rounded to the grid the same
  way), floored at 0.01 where it falls to ``limb_gaussian_thre``, and
  averaged over the people whose box covers the cell
  (py_data_heatmapper.py:163-240);
- background channels: the person mask eroded by a 3x3 window (a min
  over the window, the border replicated) and the max over the keypoint
  channels (py_data_heatmapper.py:73-80).

People are padded to a fixed ``max_people``; a padding row carries
visibility 2 and contributes nothing.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import SkeletonConfig
from ..data.heatmapper import Heatmapper


def make_gt_synthesizer(config: SkeletonConfig) -> Callable:
    """Build ``synthesize(joints, mask_all) -> (N, H, W, num_layers)``.

    :param joints: (N, max_people, num_parts, 3) float, visibility < 2 =
        annotated (padding rows carry 2)
    :param mask_all: (N, H, W) or (N, H, W, 1) float in [0, 1] on the
        stride-4 grid
    :returns: float32 labels on the joints' device, channel-last
    """
    # the host heatmapper's derived constants, so the two GT paths share
    # the window half-extent and the stride-center grid
    hm = Heatmapper(config)
    tp = config.transform_params
    sigma2x2 = float(hm.double_sigma2)
    paf_sigma2x2 = 2.0 * tp.paf_sigma * tp.paf_sigma
    g = hm.gaussian_size // 2
    limb_thre = tp.limb_gaussian_thre
    paf_thre = config.paf_thre
    stride = config.stride
    limb_from = [f for f, _ in config.limbs_conn]
    limb_to = [t for _, t in config.limbs_conn]
    grid_x = torch.from_numpy(hm.grid_x)
    grid_y = torch.from_numpy(hm.grid_y)

    def synthesize(joints: torch.Tensor, mask_all: torch.Tensor
                   ) -> torch.Tensor:
        dev = joints.device
        joints = joints.to(torch.float32)
        gx, gy = grid_x.to(dev), grid_y.to(dev)
        ix = torch.arange(gx.numel(), dtype=torch.float32, device=dev)
        iy = torch.arange(gy.numel(), dtype=torch.float32, device=dev)
        xs, ys, vis = joints[..., 0], joints[..., 1], joints[..., 2]

        # keypoints: (N, P, K) joints -> (N, K, H, W), max over people
        cx = torch.round(xs / stride)[..., None]
        cy = torch.round(ys / stride)[..., None]
        ex = torch.exp(-((gx - xs[..., None]) ** 2) / sigma2x2)
        ey = torch.exp(-((gy - ys[..., None]) ** 2) / sigma2x2)
        ex = ex * ((ix - cx).abs() <= g)
        ey = ey * ((iy - cy).abs() <= g)
        ey = ey * (vis < 2)[..., None]
        heat = (ey[..., :, None] * ex[..., None, :]).amax(dim=1)

        # limbs: (N, P, L) segments -> (N, L, H, W), averaged over people
        x1, y1 = xs[..., limb_from], ys[..., limb_from]
        x2, y2 = xs[..., limb_to], ys[..., limb_to]
        lvis = torch.maximum(vis[..., limb_from], vis[..., limb_to])
        dx, dy = x2 - x1, y2 - y1
        norm = torch.sqrt(dx * dx + dy * dy)
        ok = (lvis < 2) & (norm > 0)
        min_sx = torch.round((torch.minimum(x1, x2) - paf_thre) / stride)
        max_sx = torch.round((torch.maximum(x1, x2) + paf_thre) / stride)
        min_sy = torch.round((torch.minimum(y1, y2) - paf_thre) / stride)
        max_sy = torch.round((torch.maximum(y1, y2) + paf_thre) / stride)
        in_x = (ix >= min_sx[..., None]) & (ix <= max_sx[..., None])
        in_y = ((iy >= min_sy[..., None]) & (iy <= max_sy[..., None])
                & ok[..., None])
        window = in_y[..., :, None] & in_x[..., None, :]   # (N, P, L, H, W)
        e = lambda t: t[..., None, None]  # noqa: E731
        dist = (e(dx) * (e(y1) - gy[:, None])
                - (e(x1) - gx) * e(dy)).abs() / (e(norm) + 1e-6)
        resp = torch.exp(-(dist ** 2) / paf_sigma2x2)
        resp = torch.where(resp <= limb_thre, 0.01, resp)
        acc = (resp * window).sum(dim=1)
        count = window.sum(dim=1)
        paf = torch.where(count > 0, acc / count.clamp(min=1), 0.0)

        mask = mask_all.to(device=dev, dtype=torch.float32)
        if mask.dim() == 4:
            mask = mask[..., 0]
        eroded = -F.max_pool2d(-mask[:, None], 3, stride=1, padding=1)
        reverse = heat.amax(dim=1, keepdim=True)
        full = torch.cat([paf, heat, eroded, reverse], dim=1)
        return full.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()

    return synthesize
