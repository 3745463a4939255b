"""Dependency-free COCO-style OKS keypoint evaluation.

A copy of ``improved_body_parts_tpu/infer/oks.py``: the port imports nothing
of the JAX package, and its tests hold the two equal.

The canonical evaluation path uses pycocotools' COCOeval
(infer/evaluate.py, reference: evaluate.py:616-621); this module provides the
same AP/AR protocol — greedy OKS matching per image at thresholds
0.50:0.05:0.95 with 101-point interpolated precision — in pure NumPy, so AP
smoke tests run in environments without pycocotools (its C extension is a
host-side dependency, SURVEY.md §2.9).

Fidelity to COCOeval (pycocotools cocoeval.py) includes the discriminating
edge cases, each pinned by analytic goldens in tests/test_oks_and_variants.py:
- greedy per-image matching, detections by descending score, each taking the
  best still-unmatched GT above the threshold;
- **ignore regions**: a GT with no labeled keypoints (crowd regions and
  un-annotated people) never counts toward recall, and detections matched to
  it are dropped rather than counted as false positives — COCOeval's
  gtIg/dtIg logic;
- the **crowd OKS fallback**: for a GT without labeled keypoints, similarity
  is computed from each detected keypoint's distance OUTSIDE the doubly
  expanded GT bbox (computeOks' ``k1 == 0`` branch), so detections inside a
  crowd region are absorbed by it;
- **maxDets = 20** detections per image (the COCO keypoint protocol);
- **area-range splits** (AP_M/AP_L, AR_M/AR_L): per range, GTs outside the
  range are ignored, and an UNMATCHED detection whose own area (the
  loadRes-style tight keypoint bbox) is outside the range is ignored
  rather than counted as a false positive.

Formats:
- ground truth: per image, list of dicts {"keypoints": (17, 3) array in COCO
  order with v flags, "area": float, optional "bbox": (x, y, w, h),
  optional "ignore": bool}
- detections: per image, list of (coco_keypoints [17 x (x, y) | None], score)
  — exactly what ``decode`` returns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# per-keypoint falloff constants (k = 2*sigma) from the COCO keypoint task
COCO_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089])

OKS_THRESHOLDS = np.arange(0.5, 0.95 + 1e-9, 0.05)

MAX_DETS = 20  # COCO keypoint protocol (COCOeval Params.maxDets)

# keypoint-task area ranges (COCOeval Params.setKpParams: no 'small')
AREA_RANGES = {
    "all": (0.0, 1e5 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e5 ** 2),
}


def oks(det_xy: np.ndarray, gt: np.ndarray, area: float,
        bbox: Optional[Sequence[float]] = None) -> float:
    """Object keypoint similarity between one detection and one GT person.

    :param det_xy: (17, 2) detected coordinates (0,0 = missing)
    :param gt: (17, 3) GT with visibility flags (v > 0 = labeled)
    :param area: GT segment area (scale normalizer)
    :param bbox: GT (x, y, w, h); used only for the no-labeled-keypoints
        crowd fallback (COCOeval computeOks ``k1 == 0``)
    """
    vis = gt[:, 2] > 0
    k2 = (2 * COCO_SIGMAS) ** 2
    if vis.any():
        d2 = ((det_xy[vis] - gt[vis, :2]) ** 2).sum(axis=1)
        e = d2 / (2.0 * max(area, 1e-9) * k2[vis])
    elif bbox is not None:
        # distance outside the doubly-expanded bbox, over ALL keypoints
        x, y, w, h = bbox
        x0, x1 = x - w, x + 2 * w
        y0, y1 = y - h, y + 2 * h
        dx = (np.maximum(0.0, x0 - det_xy[:, 0])
              + np.maximum(0.0, det_xy[:, 0] - x1))
        dy = (np.maximum(0.0, y0 - det_xy[:, 1])
              + np.maximum(0.0, det_xy[:, 1] - y1))
        e = (dx ** 2 + dy ** 2) / (2.0 * max(area, 1e-9) * k2)
    else:
        return 0.0
    return float(np.exp(-e).mean())


def _gt_ignore(gt: Dict) -> bool:
    """COCOeval keypoint _prepare: ignore a GT if flagged, crowd, or without
    a single labeled keypoint."""
    if gt.get("ignore") or gt.get("iscrowd"):
        return True
    kpts = np.asarray(gt["keypoints"], dtype=np.float64)
    return not (kpts[:, 2] > 0).any()


def _oks_matrix(gts: Sequence[Dict], dts: Sequence[Tuple]) -> np.ndarray:
    """(n_det, n_gt) OKS similarities — computed ONCE per image and reused
    across all thresholds (the COCOeval computeOks/accumulate split)."""
    mat = np.zeros((len(dts), len(gts)))
    for di, (coords, _) in enumerate(dts):
        det_xy = np.array([(0.0, 0.0) if c is None else c for c in coords])
        for gi, gt in enumerate(gts):
            mat[di, gi] = oks(
                det_xy, np.asarray(gt["keypoints"], dtype=np.float64),
                gt["area"], bbox=gt.get("bbox"))
    return mat


def _match_image(oks_mat: np.ndarray, det_scores: np.ndarray,
                 gt_ignored: np.ndarray, gt_crowd: np.ndarray, thr: float,
                 det_outside: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Greedy matching for one image at one threshold (COCOeval evaluateImg):
    detections by descending score, each takes its best available GT; crowd
    GTs stay available after matching; a detection that lands on an ignored
    GT is itself ignored (neither TP nor FP).

    GT columns must be ordered non-ignored first (COCOeval's gtind sort).

    ``det_outside`` marks detections whose own area falls outside the
    active area range: if UNMATCHED they are ignored rather than counted
    as false positives (evaluateImg's ``dtIg = dtIg | (dtm==0 & outside)``).

    Returns (scores, is_tp, det_ignored, number of non-ignored GT).
    """
    n_det, n_gt = oks_mat.shape
    order = np.argsort(-det_scores, kind="stable")
    matched = np.zeros(n_gt, dtype=bool)
    scores = np.empty(n_det)
    tps = np.zeros(n_det, dtype=bool)
    ignored = np.zeros(n_det, dtype=bool)
    for oi, di in enumerate(order):
        best_oks, best_gi = thr, -1
        for gi in range(n_gt):
            if matched[gi] and not gt_crowd[gi]:
                continue
            # already matched to a real GT and reached the (trailing)
            # ignored section — a real match never downgrades to ignore
            if best_gi > -1 and not gt_ignored[best_gi] and gt_ignored[gi]:
                break
            if oks_mat[di, gi] >= best_oks:
                best_oks, best_gi = oks_mat[di, gi], gi
        scores[oi] = det_scores[di]
        if best_gi >= 0:
            matched[best_gi] = True
            ignored[oi] = gt_ignored[best_gi]
            tps[oi] = not ignored[oi]
        elif det_outside is not None and det_outside[di]:
            ignored[oi] = True
    return scores, tps, ignored, int((~gt_ignored).sum())


def average_precision(scores: np.ndarray, tps: np.ndarray, n_gt: int
                      ) -> float:
    """101-point interpolated AP (the COCOeval accumulate protocol)."""
    if n_gt == 0:
        return np.nan
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(tps[order])
    fp = np.cumsum(~tps[order])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # make precision monotonically decreasing from the right
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    recall_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    prec_at = np.where(idx < precision.size, precision[np.minimum(
        idx, precision.size - 1)], 0.0)
    return float(prec_at.mean())


def _det_area(coords) -> float:
    """Detection area the way pycocotools COCO.loadRes derives it for
    keypoint results: the tight bbox over ALL keypoint coordinates —
    including (0, 0) placeholders for missing keypoints.  A quirk, but
    it is exactly what COCOeval sees for the dt-side area gating."""
    xy = np.array([(0.0, 0.0) if c is None else c for c in coords],
                  dtype=np.float64)
    x0, y0 = xy.min(axis=0)
    x1, y1 = xy.max(axis=0)
    return float((x1 - x0) * (y1 - y0))


def evaluate_oks(ground_truth: Dict[int, Sequence[Dict]],
                 detections: Dict[int, Sequence[Tuple]]
                 ) -> Dict[str, float]:
    """The 10-stat COCO keypoint summary: AP / AP50 / AP75 / AP_M / AP_L
    and AR / AR50 / AR75 / AR_M / AR_L (COCOeval summarize, kps mode).

    :param ground_truth: image_id -> list of GT person dicts
    :param detections: image_id -> list of (coords, score) from ``decode``
    """
    per_image = {}
    for image_id, gts in ground_truth.items():
        dts = sorted(detections.get(image_id, []),
                     key=lambda d: -d[1])[:MAX_DETS]
        per_image[image_id] = (
            _oks_matrix(gts, dts),  # column order = original gts order
            np.asarray([score for _, score in dts], dtype=np.float64),
            np.asarray([_gt_ignore(g) for g in gts], dtype=bool),
            np.asarray([bool(g.get("iscrowd")) for g in gts], dtype=bool),
            np.asarray([float(g["area"]) for g in gts], dtype=np.float64),
            np.asarray([_det_area(coords) for coords, _ in dts],
                       dtype=np.float64))

    def mean_or_nan(x):
        return float(np.nanmean(x)) if not np.isnan(x).all() else float("nan")

    out: Dict[str, float] = {}
    for rng_name, (lo, hi) in AREA_RANGES.items():
        # range-specific ignore (evaluateImg: gtIg = _ignore or area
        # outside aRng), then non-ignored GTs first (COCOeval's gtind
        # sort) so the matching loop's early break on the ignored tail is
        # valid — all threshold-independent, so precomputed per image
        prepared = []
        for (mat, det_scores, g_base_ign, g_crowd, g_area,
             d_area) in per_image.values():
            g_ign = g_base_ign | (g_area < lo) | (g_area > hi)
            gt_order = np.argsort(g_ign, kind="stable")
            d_out = (d_area < lo) | (d_area > hi)
            prepared.append((mat[:, gt_order], det_scores,
                             g_ign[gt_order], g_crowd[gt_order], d_out))
        aps = []
        recalls = []
        for thr in OKS_THRESHOLDS:
            all_scores, all_tps, total_gt = [], [], 0
            for mat, det_scores, g_ign, g_crowd, d_out in prepared:
                s, t, d_ign, n = _match_image(
                    mat, det_scores, g_ign, g_crowd, thr,
                    det_outside=d_out)
                all_scores.append(s[~d_ign])
                all_tps.append(t[~d_ign])
                total_gt += n
            scores = (np.concatenate(all_scores) if all_scores
                      else np.zeros(0))
            tps = (np.concatenate(all_tps) if all_tps
                   else np.zeros(0, dtype=bool))
            aps.append(average_precision(scores, tps, total_gt))
            recalls.append(tps.sum() / total_gt if total_gt else np.nan)

        aps = np.asarray(aps)
        recalls = np.asarray(recalls)
        suffix = {"all": "", "medium": "_M", "large": "_L"}[rng_name]
        if rng_name == "all":
            out["AP"] = mean_or_nan(aps)
            out["AP50"] = float(aps[0])
            out["AP75"] = float(aps[5])
            out["AR"] = mean_or_nan(recalls)
            out["AR50"] = float(recalls[0])
            out["AR75"] = float(recalls[5])
        else:
            out["AP" + suffix] = mean_or_nan(aps)
            out["AR" + suffix] = mean_or_nan(recalls)
    return out
