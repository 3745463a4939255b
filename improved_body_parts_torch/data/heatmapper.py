"""Ground-truth heatmap synthesis on the stride-4 grid.

The port's copy of ``improved_body_parts_tpu/data/heatmapper.py``
(NumPy/cv2 only), so the same joints give the same bits in both packages.

Host-side NumPy; semantics follow the reference heatmapper
(reference: py_cocodata_server/py_data_heatmapper.py) with the same
quantization-avoiding trick: Gaussians are evaluated at the *original-resolution
stride-center coordinates* ``arange(n)*stride + stride/2 - 0.5``
(py_data_heatmapper.py:40-48), never by downsampling a full-res map.

Differences from the reference (documented deviations):
- Output is channel-LAST (H, W, C) — the natural layout for NHWC TPU convs;
  the reference transposes to CHW for torch (py_data_heatmapper.py:97).
- Keypoint Gaussians are splatted with a single vectorized scatter-max over all
  (person, joint) instances instead of a Python loop per joint.

Channel layout (reference config/config.py:96-103): limbs [0, paf_layers),
keypoints [heat_start, bkg_start), eroded person mask at bkg_start, max of
keypoint channels at bkg_start+1.
"""
from __future__ import annotations

from math import ceil, log, sqrt
from typing import Tuple

import cv2
import numpy as np

from ..config import SkeletonConfig


class Heatmapper:
    def __init__(self, config: SkeletonConfig):
        self.config = config
        tp = config.transform_params
        self.sigma = tp.sigma
        self.paf_sigma = tp.paf_sigma
        self.double_sigma2 = 2.0 * self.sigma * self.sigma
        self.keypoint_thre = tp.keypoint_gaussian_thre
        self.limb_thre = tp.limb_gaussian_thre
        # Window half-extent so the tails below keypoint_thre are dropped
        # (reference: py_data_heatmapper.py:30).
        self.gaussian_size = ceil(
            sqrt(-self.double_sigma2 * log(self.keypoint_thre)) / config.stride) * 2
        self.paf_thre = config.paf_thre

        stride = config.stride
        h, w = config.grid_shape
        # Stride-center sample coordinates in original-resolution units.
        self.grid_x = (np.arange(w) * stride + stride / 2 - 0.5).astype(np.float32)
        self.grid_y = (np.arange(h) * stride + stride / 2 - 0.5).astype(np.float32)

    # ------------------------------------------------------------------ #
    def create_heatmaps(self, joints: np.ndarray, mask_all: np.ndarray
                        ) -> np.ndarray:
        """Build the full (H, W, num_layers) GT tensor.

        :param joints: (num_people, num_parts, 3) in original-resolution coords
            with visibility in col 2 (0 hidden / 1 visible / 2 absent — both
            0 and 1 count as annotated, reference: py_data_heatmapper.py:160).
        :param mask_all: (H, W) float in [0,1], person-area mask on the grid.
        """
        cfg = self.config
        heatmaps = np.zeros(cfg.parts_shape, dtype=np.float32)
        self.put_joints(heatmaps, joints)
        self.put_limbs(heatmaps, joints)

        # Person-mask background channel: eroded mask_all
        # (reference: py_data_heatmapper.py:73-76).
        kernel = np.ones((3, 3), np.uint8)
        heatmaps[:, :, cfg.bkg_start] = cv2.erode(mask_all, kernel)

        # Reverse-keypoint channel: max over all keypoint channels
        # (reference: py_data_heatmapper.py:78-80).
        sl = slice(cfg.heat_start, cfg.heat_start + cfg.heat_layers)
        heatmaps[:, :, cfg.bkg_start + 1] = np.amax(heatmaps[:, :, sl], axis=2)

        return np.clip(heatmaps, 0.0, 1.0)

    # ------------------------------------------------------------------ #
    def put_joints(self, heatmaps: np.ndarray, joints: np.ndarray) -> None:
        """Splat all keypoint Gaussians with one scatter-max per axis pass.

        Equivalent to the reference's per-joint windowed outer products
        (py_data_heatmapper.py:99-155): same windows, same stride-center
        evaluation, overlapping people combined by max, not mean.
        """
        assert heatmaps.flags["C_CONTIGUOUS"], (
            "put_joints scatters into heatmaps.reshape(-1), which must be a "
            "view; pass a C-contiguous array")
        cfg = self.config
        h, w = cfg.grid_shape
        g = self.gaussian_size // 2
        win = 2 * g + 1  # window is [c-g, c+g] inclusive

        vis = joints[:, :, 2] < 2  # annotated
        people_idx, part_idx = np.nonzero(vis)
        if people_idx.size == 0:
            return
        xs = joints[people_idx, part_idx, 0].astype(np.float32)
        ys = joints[people_idx, part_idx, 1].astype(np.float32)
        n = xs.shape[0]

        cx = np.round(xs / cfg.stride).astype(np.int64)
        cy = np.round(ys / cfg.stride).astype(np.int64)
        offs = np.arange(-g, g + 1, dtype=np.int64)
        ix = cx[:, None] + offs[None, :]           # (n, win)
        iy = cy[:, None] + offs[None, :]
        valid_x = (ix >= 0) & (ix < w)
        valid_y = (iy >= 0) & (iy < h)

        gx = self.grid_x[np.clip(ix, 0, w - 1)]
        gy = self.grid_y[np.clip(iy, 0, h - 1)]
        exp_x = np.exp(-((gx - xs[:, None]) ** 2) / self.double_sigma2)
        exp_y = np.exp(-((gy - ys[:, None]) ** 2) / self.double_sigma2)

        vals = exp_y[:, :, None] * exp_x[:, None, :]          # (n, win, win)
        valid = valid_y[:, :, None] & valid_x[:, None, :]

        chan = cfg.heat_start + part_idx                      # (n,)
        flat = ((iy[:, :, None] * w + ix[:, None, :]) * cfg.num_layers
                + chan[:, None, None])
        target = heatmaps.reshape(-1)
        np.maximum.at(target, flat[valid], vals[valid].astype(np.float32))

    # ------------------------------------------------------------------ #
    def put_limbs(self, heatmaps: np.ndarray, joints: np.ndarray) -> None:
        """Scalar body-part (limb) maps, count-averaged across instances
        (reference: py_data_heatmapper.py:163-240)."""
        cfg = self.config
        for i, (fr, to) in enumerate(cfg.limbs_conn):
            visible = (joints[:, fr, 2] < 2) & (joints[:, to, 2] < 2)
            layer = cfg.paf_start + i
            self._put_limb_channel(heatmaps, layer, joints[visible, fr, 0:2],
                                   joints[visible, to, 0:2])

    def _put_limb_channel(self, heatmaps: np.ndarray, layer: int,
                          joint_from: np.ndarray, joint_to: np.ndarray) -> None:
        cfg = self.config
        h, w = cfg.grid_shape
        count = np.zeros((h, w), dtype=np.float32)
        acc = heatmaps[:, :, layer]

        for (x1, y1), (x2, y2) in zip(joint_from, joint_to):
            dx, dy = x2 - x1, y2 - y1
            if dx * dx + dy * dy == 0:  # zero-length limb kills the NN; skip
                continue

            min_sx, max_sx = sorted((x1, x2))
            min_sy, max_sy = sorted((y1, y2))
            # include endpoints: pad bbox by paf_thre in original coords
            min_sx = int(round((min_sx - self.paf_thre) / cfg.stride))
            min_sy = int(round((min_sy - self.paf_thre) / cfg.stride))
            max_sx = int(round((max_sx + self.paf_thre) / cfg.stride))
            max_sy = int(round((max_sy + self.paf_thre) / cfg.stride))
            if max_sx < 0 or max_sy < 0:
                continue
            min_sx, min_sy = max(min_sx, 0), max(min_sy, 0)

            sx = slice(min_sx, max_sx + 1)
            sy = slice(min_sy, max_sy + 1)
            X = self.grid_x[sx][None, :]
            Y = self.grid_y[sy][:, None]
            resp = limb_response(X, Y, self.paf_sigma, x1, y1, x2, y2,
                                 self.limb_thre)
            acc[sy, sx] += resp
            count[sy, sx] += 1.0

        nz = count > 0  # average overlapping limb instances by count
        acc[nz] /= count[nz]


class OffsetMapper:
    """Sub-pixel offset ground truth (reference: py_data_heatmapper.py:242-299
    ``put_offset`` — dormant in the reference's final path, kept for the
    offset-regression experiments of posenet_final/config_final).

    All keypoints share one (x, y) offset channel pair; offsets are normalized
    by (offset_size * stride), averaged where windows overlap, and the mask
    marks touched cells.
    """

    def __init__(self, config: SkeletonConfig):
        self.config = config
        hm = Heatmapper(config)
        self.offset_size = hm.gaussian_size // 2 + 1
        self.grid_x = hm.grid_x
        self.grid_y = hm.grid_y

    def create_offsets(self, joints: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(H, W, 2) offset vectors + (H, W, 2) mask, channel-last."""
        cfg = self.config
        h, w = cfg.grid_shape
        offsets = np.zeros((h, w, 2), dtype=np.float32)
        counts = np.zeros((h, w, 2), dtype=np.float32)
        g = self.offset_size // 2
        norm = self.offset_size * cfg.stride

        vis = joints[:, :, 2] < 2
        pi, ki = np.nonzero(vis)
        for x, y in zip(joints[pi, ki, 0], joints[pi, ki, 1]):
            cx = int(round(x / cfg.stride))
            cy = int(round(y / cfg.stride))
            x0, x1 = max(cx - g, 0), min(cx + g + 1, w)
            y0, y1 = max(cy - g, 0), min(cy + g + 1, h)
            if x1 <= 0 or y1 <= 0 or x0 >= w or y0 >= h:
                continue
            ox = (self.grid_x[x0:x1] - x) / norm
            oy = (self.grid_y[y0:y1] - y) / norm
            offsets[y0:y1, x0:x1, 0] += ox[None, :]
            offsets[y0:y1, x0:x1, 1] += oy[:, None]
            counts[y0:y1, x0:x1, :] += 1.0

        nz = counts > 0
        offsets[nz] /= counts[nz]
        mask = nz.astype(np.float32)
        return offsets, mask


def limb_response(X, Y, sigma, x1, y1, x2, y2, thresh=0.01):
    """Gaussian of point-to-segment-line distance (the scalar 'PAF')
    (reference: py_data_heatmapper.py:309-340 ``distances``).

    Responses at or below ``thresh`` are set to 0.01, matching the reference's
    floor (py_data_heatmapper.py:336) — the floor marks 'this window was
    touched' for the count-averaging step.
    """
    xD, yD = x2 - x1, y2 - y1
    norm = sqrt(xD * xD + yD * yD)
    dist = np.abs((xD * (y1 - Y) - (x1 - X) * yD) / (norm + 1e-6))
    resp = np.exp(-(dist ** 2) / (2.0 * sigma * sigma)).astype(np.float32)
    resp[resp <= thresh] = 0.01
    return resp
