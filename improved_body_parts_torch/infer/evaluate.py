"""COCO keypoint evaluation driver (counterpart of
``improved_body_parts_tpu/infer/evaluate.py``).

Reference: evaluate.py:501-622 — per-image predict → decode → COCO-format
results JSON → COCOeval, or the dependency-free OKS evaluator
(``infer.oks``) where pycocotools is absent.  Everything device-side goes
through the port's ``Predictor``: the compact lane, the full-map lane
(``fast``), the fused device decode (``device_decode``), the scale /
rotation grid on the device (``compact`` with a grid) and the host
full-map protocol (``Predictor.predict``, neither flag).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

from ..config import InferenceParams, default_inference_params
from ..obs.events import get_sink, strict_dump
from ..utils import AverageMeter
from .decode import CompactOverflow, decode, decode_compact
from .predict import Predictor, trivial_grid

def _report(event: str, text: str, **fields) -> None:
    """Progress reports reach the run's telemetry stream when a sink is
    installed (a structured record an eval run can be audited from),
    stdout otherwise."""
    sink = get_sink()
    if sink.enabled:
        sink.emit(event, **fields)
    else:
        print(text)


def process_image(predictor: Predictor, image_bgr: np.ndarray,
                  params: InferenceParams, use_native: bool = True,
                  timer: Optional[AverageMeter] = None,
                  fast: bool = False, compact: bool = False):
    """predict + decode one image → [(coco keypoints, score)]
    (reference: evaluate.py:501-543).

    ``fast=True`` (single-scale protocol only) keeps NMS on the device and
    decodes the full maps at network-input resolution, rescaling
    coordinates back (``Predictor.predict_fast``).  ``compact=True`` also
    keeps peak refinement and limb pair scoring on the device
    (``Predictor.predict_compact``, or ``predict_compact_ms`` for a
    multi-scale grid); an overflow falls back to the fast path for the
    trivial grid, else to the host full-map protocol.  Neither flag runs
    the host full-map protocol (``Predictor.predict``: the maps averaged
    over the grid at the original resolution) and decodes there."""
    if compact:
        try:
            if len(params.scale_search) > 1:
                res = predictor.predict_compact_ms(
                    image_bgr, thre1=params.thre1, params=params)
            else:
                res = predictor.predict_compact(
                    image_bgr, thre1=params.thre1, params=params)
            t0 = time.perf_counter()
            results = decode_compact(res, params, predictor.skeleton,
                                     use_native=use_native)
            if timer is not None:
                timer.update(time.perf_counter() - t0)
            return results
        except CompactOverflow:
            # predict_fast rejects a grid: a grid's overflow falls
            # through to the host full-map protocol below
            fast = trivial_grid(params)
    if fast:
        heat, paf, peak_mask, coord_scale = predictor.predict_fast(
            image_bgr, params=params)
        t0 = time.perf_counter()
        results = decode(heat, paf, params, predictor.skeleton,
                         use_native=use_native, peak_mask=peak_mask,
                         coord_scale=coord_scale)
    else:
        heat, paf = predictor.predict(image_bgr, params=params)
        t0 = time.perf_counter()
        results = decode(heat, paf, params, predictor.skeleton,
                         use_native=use_native)
    if timer is not None:
        timer.update(time.perf_counter() - t0)
    return results


def format_results(keypoints: Dict[int, list], res_file: str) -> None:
    """COCO results JSON (reference: evaluate.py:563-582); v=1 when either
    coordinate is nonzero."""
    out = []
    for image_id, people in keypoints.items():
        for keypoint_list, score in people:
            flat: List[float] = []
            for pt in keypoint_list:
                x, y = (0.0, 0.0) if pt is None else pt
                flat.extend([x, y, 1 if x > 0 or y > 0 else 0])
            out.append({"image_id": image_id, "category_id": 1,
                        "keypoints": flat, "score": score})
    os.makedirs(os.path.dirname(os.path.abspath(res_file)), exist_ok=True)
    with open(res_file, "w") as f:
        # strict emission: a bare-NaN token would break COCO.loadRes
        strict_dump(out, f)


def validation(predictor: Predictor, anno_file: str, images_dir: str,
               dump_name: str = "cuda",
               validation_ids: Optional[Sequence[int]] = None,
               max_images: int = 500,
               params: Optional[InferenceParams] = None,
               use_native: bool = True, results_dir: str = "results",
               fast: bool = False, compact: bool = False,
               compact_batch: int = 0, device_decode: bool = False):
    """Run COCOeval on ``validation_ids`` (default: the first
    ``max_images`` val ids — the reference's first-500 protocol,
    evaluate.py:597-598).  Needs pycocotools: raises ``ImportError``
    without it (:func:`validation_oks` needs nothing).

    Returns the COCOeval object (stats[0] is AP)."""
    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval

    params = params or default_inference_params()[0]
    coco_gt = COCO(anno_file)
    if validation_ids is None:
        validation_ids = coco_gt.getImgIds()[:max_images]
    missing = set(validation_ids) - set(coco_gt.getImgIds())
    if missing:
        raise ValueError(f"ids not in {anno_file}: {sorted(missing)[:8]}")

    decode_timer = AverageMeter()
    keypoints = _collect_detections(
        predictor, {i: coco_gt.imgs[i]["file_name"] for i in validation_ids},
        images_dir, list(validation_ids), params, use_native, fast,
        decode_timer, compact=compact, compact_batch=compact_batch,
        device_decode=device_decode)

    res_file = os.path.join(results_dir, f"person_keypoints_{dump_name}.json")
    format_results(keypoints, res_file)
    coco_dt = coco_gt.loadRes(res_file)
    coco_eval = COCOeval(coco_gt, coco_dt, "keypoints")
    coco_eval.params.imgIds = list(validation_ids)
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    if decode_timer.count:
        fps = 1.0 / max(decode_timer.avg, 1e-9)
        _report("decode_fps",
                f"keypoint assignment: {fps:.1f} FPS "
                f"(avg {decode_timer.avg * 1000:.1f} ms)",
                fps=round(fps, 2),
                avg_ms=round(decode_timer.avg * 1000, 3))
    return coco_eval


def _collect_detections(predictor: Predictor, id_to_name: Dict[int, str],
                        images_dir: str, ids: Sequence[int],
                        params: InferenceParams, use_native: bool,
                        fast: bool,
                        decode_timer: Optional[AverageMeter] = None,
                        compact: bool = False,
                        compact_batch: int = 0,
                        device_decode: bool = False) -> Dict[int, list]:
    """Run inference over ``ids`` — the one detection-collection loop shared
    by the COCOeval and OKS protocols.  ``fast`` uses the pipelined
    single-scale full-map path (forward N+1 overlaps threaded decode N);
    ``compact`` keeps peak extraction + pair scoring on the device;
    ``compact_batch`` > 1 runs the shape-bucketed batched mode;
    ``device_decode`` runs the greedy assembly on the device too (the
    fused lane)."""

    def load(image_id):
        image = cv2.imread(os.path.join(images_dir, id_to_name[image_id]))
        if image is None:
            raise IOError(f"missing image {id_to_name[image_id]}")
        return image

    keypoints: Dict[int, list] = {}
    if fast or compact or compact_batch >= 1 or device_decode:
        from .pipeline import pipelined_inference

        t0 = time.perf_counter()
        results_iter = pipelined_inference(
            predictor, (load(i) for i in ids), params,
            use_native=use_native, compact=compact,
            compact_batch=compact_batch, device_decode=device_decode)
        for image_id, results in zip(ids, results_iter):
            keypoints[image_id] = results
        dt = time.perf_counter() - t0
        fps = len(ids) / max(dt, 1e-9)
        _report("pipeline_fps",
                f"end-to-end (pipelined): {fps:.1f} FPS",
                fps=round(fps, 2), images=len(ids))
    else:
        for image_id in ids:
            keypoints[image_id] = process_image(predictor, load(image_id),
                                                params, use_native,
                                                decode_timer, fast=False)
    return keypoints


def load_coco_ground_truth(anno_file: str):
    """Parse a person_keypoints_*.json with the stdlib (no pycocotools):
    returns (image_id -> file_name, image_id -> list of GT dicts in the
    ``infer.oks`` format)."""
    with open(anno_file) as f:
        data = json.load(f)
    person_ids = {c["id"] for c in data.get("categories", [])
                  if c.get("name") == "person"} or {1}
    images = {im["id"]: im["file_name"] for im in data["images"]}
    gts: Dict[int, list] = {i: [] for i in images}
    for ann in data.get("annotations", []):
        if ann.get("category_id", 1) not in person_ids:
            continue
        kp = np.asarray(ann.get("keypoints", [0] * 51),
                        np.float64).reshape(-1, 3)
        bbox = ann.get("bbox")
        gts.setdefault(ann["image_id"], []).append({
            "keypoints": kp,
            "area": float(ann.get("area") or
                          (bbox[2] * bbox[3] if bbox else 1.0)),
            "bbox": tuple(bbox) if bbox else None,
            "iscrowd": int(ann.get("iscrowd", 0)),
        })
    return images, gts


def validation_oks(predictor: Predictor, anno_file: str, images_dir: str,
                   validation_ids: Optional[Sequence[int]] = None,
                   max_images: int = 500,
                   params: Optional[InferenceParams] = None,
                   use_native: bool = True, fast: bool = False,
                   compact: bool = False, compact_batch: int = 0,
                   device_decode: bool = False,
                   dump_name: str = "cuda", results_dir: str = "results"):
    """The first-500 protocol evaluated with the dependency-free OKS
    evaluator (COCOeval ignore/crowd/maxDets semantics) — runs without
    pycocotools.  The detections JSON is still written, so it can be
    re-scored with pycocotools elsewhere.  Returns the 10-stat COCO
    keypoint summary {AP, AP50, AP75, AP_M, AP_L, AR, AR50, AR75, AR_M,
    AR_L} (area-split entries are nan when the val set has no GT in that
    range)."""
    from .oks import evaluate_oks

    params = params or default_inference_params()[0]
    images, gts = load_coco_ground_truth(anno_file)
    if validation_ids is None:
        ids = list(images)[:max_images]
    else:
        ids = list(validation_ids)
        missing = set(ids) - set(images)
        if missing:
            raise ValueError(
                f"ids not in {anno_file}: {sorted(missing)[:8]}")

    detections = _collect_detections(predictor, images, images_dir, ids,
                                     params, use_native, fast,
                                     compact=compact,
                                     compact_batch=compact_batch,
                                     device_decode=device_decode)
    res_file = os.path.join(results_dir, f"person_keypoints_{dump_name}.json")
    format_results(detections, res_file)

    metrics = evaluate_oks({i: gts.get(i, []) for i in ids}, detections)
    _report("oks_summary",
            "  ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
            **{k: round(v, 6) for k, v in metrics.items()})
    return metrics
