"""Single-image demo: predict → decode → skeleton / heatmap rendering
(counterpart of ``improved_body_parts_tpu/infer/demo.py``).

Reference: demo_image.py — same pipeline as evaluation plus visualization:
skeleton drawn as filled ellipse polygons over the limb draw list
(demo_image.py:573-595) and an HSV color-flow rendering of a limb map
(demo_image.py:64-101).  ``draw_skeletons`` and ``limb_flow_bgr`` are
copies of the JAX package's; ``run_demo`` draws over the port's
``Predictor``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np

from ..config import InferenceParams, SkeletonConfig, default_inference_params
from .predict import Predictor

# body-part palette (reference: evaluate.py:32-35)
COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85], [193, 193, 255],
    [106, 106, 255], [20, 147, 255], [128, 114, 250], [130, 238, 238],
    [48, 167, 238], [180, 105, 255],
]


def draw_skeletons(image_bgr: np.ndarray, subset: np.ndarray,
                   candidate: np.ndarray, skeleton: SkeletonConfig,
                   stick_width: int = 4) -> np.ndarray:
    """Render keypoints + limbs for each assembled person
    (reference: demo_image.py:538-595)."""
    canvas = image_bgr.copy()
    n = skeleton.num_parts
    for person in subset:
        for part in range(n):
            idx = int(person[part, 0])
            if idx < 0:
                continue
            x, y = candidate[idx][:2]
            cv2.circle(canvas, (int(x), int(y)), 4,
                       COLORS[part % len(COLORS)], thickness=-1)
    for person in subset:
        for li, limb in enumerate(skeleton.draw_limbs):
            fr, to = skeleton.limbs_conn[limb]
            ia, ib = int(person[fr, 0]), int(person[to, 0])
            if ia < 0 or ib < 0:
                continue
            xa, ya = candidate[ia][:2]
            xb, yb = candidate[ib][:2]
            mx, my = (xa + xb) / 2, (ya + yb) / 2
            length = np.hypot(xa - xb, ya - yb)
            angle = np.degrees(np.arctan2(ya - yb, xa - xb))
            poly = cv2.ellipse2Poly(
                (int(mx), int(my)), (int(length / 2), stick_width),
                int(angle), 0, 360, 1)
            overlay = canvas.copy()
            cv2.fillConvexPoly(overlay, poly, COLORS[li % len(COLORS)])
            canvas = cv2.addWeighted(canvas, 0.4, overlay, 0.6, 0)
    return canvas


def limb_flow_bgr(limb_map: np.ndarray) -> np.ndarray:
    """HSV rendering of one limb response map
    (reference: demo_image.py:64-101): hue = local gradient orientation of
    the response field (the directional information), value = magnitude."""
    gx = cv2.Sobel(limb_map.astype(np.float32), cv2.CV_32F, 1, 0)
    gy = cv2.Sobel(limb_map.astype(np.float32), cv2.CV_32F, 0, 1)
    _, ang = cv2.cartToPolar(gx, gy)
    mag = np.abs(limb_map)
    mag = mag / max(mag.max(), 1e-6)
    hsv = np.zeros((*limb_map.shape, 3), np.uint8)
    hsv[..., 0] = (ang / (2 * np.pi) * 179).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = (mag * 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def run_demo(predictor: Predictor, image_path: str, output_path: str,
             params: Optional[InferenceParams] = None,
             use_native: bool = True,
             device_decode: bool = False) -> Tuple[np.ndarray, tuple]:
    """Full demo (reference: demo_image.py __main__): returns (canvas,
    (subset, candidate)) and writes the rendering to ``output_path``.

    The host lane is the host full-map protocol (``Predictor.predict``:
    the maps averaged over the predictor's grid at the original
    resolution, assembled on the host).  ``device_decode=True`` runs the
    fused lane (``Predictor.predict_decoded``) and draws straight off the
    device person table; an overflowed frame falls back to the host lane.
    The lane used is reported as a ``demo_decode`` event through the
    process sink, on stdout when none is installed."""
    from ..obs.events import get_sink
    from .decode import assemble, device_subset_candidate

    # the predictor's own params, not the module default
    params = params or getattr(predictor, "params", None) \
        or default_inference_params()[0]
    image = cv2.imread(image_path)
    if image is None:
        raise IOError(f"cannot read {image_path}")
    sk = predictor.skeleton
    lane = "host"
    if device_decode:
        dev = predictor.predict_decoded(image, params=params)
        if dev.ok:
            lane = "device"
            subset, candidate = device_subset_candidate(dev)
        else:
            lane = "host_fallback"      # capacity overflow: degrade
    if lane != "device":
        heat, paf = predictor.predict(image, params=params)
        subset, candidate = assemble(heat, paf, params, sk, use_native)
    if device_decode:
        sink = get_sink()
        if sink.enabled:
            sink.emit("demo_decode", lane=lane, people=len(subset))
        else:
            print(f"decode lane: {lane} ({len(subset)} people)")
    canvas = draw_skeletons(image, subset, candidate, sk)
    cv2.imwrite(output_path, canvas)
    return canvas, (subset, candidate)
