"""Image/keypoint augmentation as a single composed affine transform.

The port's copy of ``improved_body_parts_tpu/data/transformer.py``
(NumPy/cv2 only), so the same seed gives the same bits in both packages.

Host-side (NumPy/OpenCV) part of the input pipeline.  Semantics follow the
reference transformer (reference: py_cocodata_server/py_data_transformer.py):
all geometric augmentations — recenter on the main person, rotate, scale to
``target_dist``, flip, recenter+shift — compose into ONE 2x3 affine matrix which
is applied once with ``cv2.warpAffine`` to the image and both masks, and by
matrix multiplication to the joint coordinates (py_data_transformer.py:43-89,
112-184).

Randomness is explicit: an ``AugmentParams`` is drawn from a
``numpy.random.Generator`` so the pipeline is seedable per-host and per-epoch
(the TPU-native replacement for the reference's process-global ``random``
module, whose DataLoader fork hazard is noted at data/mydataset.py:33).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import cos, pi, sin
from typing import Optional, Tuple

import cv2
import numpy as np

from ..config import SkeletonConfig, TransformParams

# The image normalization constant, shared with the on-device prologue
# (train.step.normalize_images).  Multiplication by the f32 reciprocal —
# not division by 255 — on BOTH sides: XLA rewrites division-by-constant
# into reciprocal multiplication, so dividing on the host would leave the
# two wire formats 1 ULP apart on 126 of the 256 uint8 values.  With the
# shared constant the uint8 and f32 wires are bit-identical end to end
# (exhaustively checked over all 256 values in test_input_pipeline.py).
IMAGE_NORM_SCALE = np.float32(1.0 / 255.0)


@dataclass(frozen=True)
class AugmentParams:
    """One draw of augmentation parameters (reference: AugmentSelection)."""
    flip: bool = False
    tint: bool = False
    degree: float = 0.0
    shift: Tuple[int, int] = (0, 0)
    scale: float = 1.0

    @staticmethod
    def sample(tp: TransformParams, rng: np.random.Generator) -> "AugmentParams":
        """Random draw (reference: py_data_transformer.py:18-30)."""
        flip = rng.uniform() < tp.flip_prob
        tint = rng.uniform() < tp.tint_prob
        degree = rng.uniform(-1.0, 1.0) * tp.max_rotate_degree
        scale = (
            (tp.scale_max - tp.scale_min) * rng.uniform() + tp.scale_min
            if rng.uniform() < tp.scale_prob else 1.0)
        shift = (
            int(rng.uniform(-1.0, 1.0) * tp.center_perterb_max),
            int(rng.uniform(-1.0, 1.0) * tp.center_perterb_max))
        return AugmentParams(flip, tint, degree, shift, scale)

    @staticmethod
    def identity() -> "AugmentParams":
        return AugmentParams()


def build_affine(aug: AugmentParams, center: Tuple[float, float],
                 scale_provided: float, config: SkeletonConfig
                 ) -> Tuple[np.ndarray, float]:
    """Compose center→rotate→scale→flip→recenter(+shift) into one 2x3 matrix.

    ``scale_provided`` is main-person height / image size; the person is
    normalized so its height is ``target_dist`` (0.6) of the output
    (reference: py_data_transformer.py:43-89).
    Returns (2x3 affine matrix, applied scale factor).
    """
    tp = config.transform_params
    scale_self = scale_provided * (config.height / (config.height - 1))
    A = cos(aug.degree / 180.0 * pi)
    B = sin(aug.degree / 180.0 * pi)
    scale_size = tp.target_dist / scale_self * aug.scale

    center_x, center_y = center
    center2zero = np.array([[1.0, 0.0, -center_x],
                            [0.0, 1.0, -center_y],
                            [0.0, 0.0, 1.0]])
    rotate = np.array([[A, B, 0.0],
                       [-B, A, 0.0],
                       [0.0, 0.0, 1.0]])
    scale_m = np.array([[scale_size, 0.0, 0.0],
                        [0.0, scale_size, 0.0],
                        [0.0, 0.0, 1.0]])
    flip_m = np.array([[-1.0 if aug.flip else 1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])
    center2center = np.array(
        [[1.0, 0.0, config.width / 2 - 0.5 + aug.shift[0]],
         [0.0, 1.0, config.height / 2 - 0.5 + aug.shift[1]],
         [0.0, 0.0, 1.0]])
    combined = center2center @ flip_m @ scale_m @ rotate @ center2zero
    return combined[0:2], scale_size


def distort_color(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """HSV jitter on a uint8 BGR image (reference: py_data_transformer.py:98-110)."""
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.int16)
    hsv[:, :, 0] = np.clip(hsv[:, :, 0] - 10 + rng.integers(0, 21), 0, 179)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] - 20 + rng.integers(0, 81), 0, 255)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] - 20 + rng.integers(0, 61), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


class Transformer:
    """Applies one composed affine to image, masks, and joints.

    Outputs float32: image HxWx3 in [0,1]; mask_miss and mask_all resized to the
    stride-4 grid in [0,1] (reference: py_data_transformer.py:112-184).
    """

    def __init__(self, config: SkeletonConfig):
        self.config = config

    def transform(self, img: np.ndarray, mask_miss: np.ndarray,
                  mask_all: np.ndarray, joints: np.ndarray,
                  objpos: Tuple[float, float], scale_provided: float,
                  aug: Optional[AugmentParams] = None,
                  rng: Optional[np.random.Generator] = None,
                  wire: str = "f32",
                  image_out: Optional[np.ndarray] = None):
        """
        :param img: HxWx3 uint8 (BGR, as read by cv2)
        :param mask_miss: HxW uint8, 0 = masked (no annotation)
        :param mask_all: HxW uint8, 255 = person area
        :param joints: (num_people, num_parts, 3) float — x, y, visibility
            (0 hidden / 1 visible / 2 absent, recoded by the corpus builder)
        :param wire: image wire format — ``"f32"`` returns the image as
            float32 in [0, 1] (the legacy contract); ``"uint8"`` returns
            the warped uint8 pixels untouched, for pipelines that ship
            uint8 and normalize on device.  The f32 image is EXACTLY
            ``uint8_image.astype(float32) / 255``, so the two wires are
            bit-identical after normalization.
        :param image_out: optional preallocated (height, width, 3)
            contiguous uint8 array; with ``wire="uint8"`` the warp renders
            directly into it (zero-copy into, e.g., a shared-memory ring
            slot) and it is returned as the image.
        :returns: (image, mask_miss, mask_all, joints) — masks/joints
            float32; image per ``wire``
        """
        cfg = self.config
        if aug is None:
            rng = rng if rng is not None else np.random.default_rng()
            aug = AugmentParams.sample(cfg.transform_params, rng)
        if aug.tint:
            if rng is None:
                raise ValueError(
                    "aug.tint=True requires an rng (color jitter draws random "
                    "offsets); pass rng= to keep the pipeline seedable")
            img = distort_color(img, rng)

        assert scale_provided != 0, "scale_provided is zero"
        M, _ = build_affine(aug, objpos, scale_provided, cfg)

        size = (cfg.width, cfg.height)
        dst = image_out if wire == "uint8" else None
        img = cv2.warpAffine(img, M, size, dst=dst, flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=(124, 127, 127))
        mask_miss = cv2.warpAffine(mask_miss, M, size, flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT,
                                   borderValue=255)
        mask_miss = cv2.resize(mask_miss, cfg.grid_shape[::-1],
                               interpolation=cv2.INTER_AREA)
        mask_all = cv2.warpAffine(mask_all, M, size, flags=cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        mask_all = cv2.resize(mask_all, cfg.grid_shape[::-1],
                              interpolation=cv2.INTER_AREA)

        # Transform joints with the same matrix: homogeneous coords as column
        # vectors (reference: py_data_transformer.py:161-170).
        joints = joints.copy()
        homo = joints.copy()
        homo[:, :, 2] = 1.0
        warped = np.matmul(M, homo.transpose([0, 2, 1])).transpose([0, 2, 1])
        joints[:, :, 0:2] = warped

        if aug.flip:  # L/R keypoint identity swap (py_data_transformer.py:173-177)
            left, right = list(cfg.left_parts), list(cfg.right_parts)
            joints[:, left + right, :] = joints[:, right + left, :]

        image = (img if wire == "uint8"
                 else img.astype(np.float32) * IMAGE_NORM_SCALE)
        return (image,
                mask_miss.astype(np.float32) / 255.0,
                mask_all.astype(np.float32) / 255.0,
                joints.astype(np.float32))
