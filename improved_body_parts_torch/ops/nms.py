"""Host-side peak NMS + sub-pixel refinement (NumPy).

The port's own copy of the NumPy half of
``improved_body_parts_tpu/ops/nms.py`` (reference: utils/util.py:177-211
``keypoint_heatmap_nms`` and ``refine_centroid``): a 3x3 max-pool with
reflect padding and threshold, and a weighted centroid over a (2r+1)^2
box that falls back to the raw anchor when the box crosses the border.
The device path does the same inside ``ops.peaks.topk_peaks``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def peak_mask_np(heat: np.ndarray, thre: float = 0.1) -> np.ndarray:
    """Boolean 3x3-NMS peak mask (reflect padding) of (H, W, C) maps."""
    padded = np.pad(heat, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    hmax = heat.copy()
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            np.maximum(hmax, padded[dy:dy + heat.shape[0],
                                    dx:dx + heat.shape[1]], out=hmax)
    return (hmax == heat) & (heat >= thre)


def refine_peaks(score_map: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                 radius: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted-centroid refinement of integer peaks on one channel.

    Returns (x_refined, y_refined, score).  Peaks whose window crosses the
    border keep their integer coords and raw score (util.py:201-202).
    """
    h, w = score_map.shape
    n = xs.shape[0]
    if n == 0:
        return (np.zeros(0), np.zeros(0), np.zeros(0))
    r = radius
    inside = ((xs - r >= 0) & (xs + r + 1 <= w)
              & (ys - r >= 0) & (ys + r + 1 <= h))

    offs = np.arange(-r, r + 1)
    wy = np.clip(ys[:, None] + offs[None, :], 0, h - 1)
    wx = np.clip(xs[:, None] + offs[None, :], 0, w - 1)
    boxes = score_map[wy[:, :, None], wx[:, None, :]]  # (n, 2r+1, 2r+1)

    total = boxes.sum(axis=(1, 2))
    total = np.where(total == 0, 1.0, total)
    gx = (boxes * offs[None, None, :]).sum(axis=(1, 2)) / total
    gy = (boxes * offs[None, :, None]).sum(axis=(1, 2)) / total

    x_ref = np.where(inside, xs + gx, xs.astype(np.float64))
    y_ref = np.where(inside, ys + gy, ys.astype(np.float64))
    score = np.where(inside, boxes.mean(axis=(1, 2)), score_map[ys, xs])
    return x_ref, y_ref, score
