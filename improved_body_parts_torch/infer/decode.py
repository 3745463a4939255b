"""Host finish of the fused device decode (NumPy).

The port's own copy of the device-decode half of
``improved_body_parts_tpu/infer/decode.py``: the payload records
(:class:`CompactResult`, :class:`DeviceDecoded`), the overflow exception
and the O(people) id -> coordinate lookup that turns the device's person
table into COCO keypoints (reference: evaluate.py:523-543).  The host
decoder (``find_peaks`` / ``find_connections`` / ``find_people``) and the
compact re-decode are not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import SkeletonConfig


def subsets_to_keypoints(subset: np.ndarray, candidate: np.ndarray,
                         skeleton: SkeletonConfig
                         ) -> List[Tuple[List[Optional[Tuple[float, float]]],
                                         float]]:
    """Convert assembled subsets to COCO-order keypoints + person score
    (reference: evaluate.py:523-543; score = 1 - 1/total_score)."""
    results = []
    mapping = skeleton.dt_gt_mapping
    n = skeleton.num_parts
    for person in subset:
        coords = []
        for idx in person[:n, 0]:
            if idx == -1:
                coords.append((0.0, 0.0))
            else:
                x, y = candidate[int(idx)][:2]
                coords.append((float(x), float(y)))
        coco_coords: List[Optional[Tuple[float, float]]] = [None] * 17
        for dt_index, gt_index in mapping.items():
            if gt_index is None:
                continue
            coco_coords[gt_index] = coords[dt_index]
        score = 1.0 - 1.0 / person[n, 0]
        results.append((coco_coords, float(score)))
    return results


class CompactResult(NamedTuple):
    """Host-side compact records of one image: top-K peak records + rank-
    ordered accepted limb candidates, both computed on the device."""
    peaks: object        # ops.peaks.TopKPeaks of numpy arrays, (C, K)
    stats: object        # ops.peaks.LimbCandidates of numpy arrays, (L, M)
    image_size: int      # valid decoded-map height (the length-prior scale)
    coord_scale: Tuple[float, float]


class CompactOverflow(RuntimeError):
    """A keypoint channel had more NMS peaks than the compact path's top-K
    capacity (or a limb more accepted pairs than its candidate cap); the
    caller should fall back to the full-map path."""


class DeviceDecoded(NamedTuple):
    """Host-side payload of the fused device-decode path
    (``Predictor.predict_decoded``): the assembled person table plus the
    compact records it was built from (the fallback input when an
    overflow flag is set).

    ``subset`` uses flat slot ids (``channel * top_k + slot``) -- feed it
    to :func:`decode_device`.
    """
    subset: np.ndarray          # (P_max, num_parts + 2, 2) float32
    mask: np.ndarray            # (P_max,) bool -- pruned-in people
    n_people: int
    peak_overflow: bool         # host path would raise CompactOverflow
    cand_overflow: bool         # host path would raise CompactOverflow
    person_overflow: bool       # device person table hit capacity
    compact: CompactResult

    @property
    def ok(self) -> bool:
        """True when the device assembly is authoritative (no capacity
        overflowed); False routes the caller to the host fallback."""
        return not (self.peak_overflow or self.cand_overflow
                    or self.person_overflow)


def device_subset_candidate(dev: DeviceDecoded
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(subset, candidate) from a fused device decode: the pruned person
    table (float64) plus a candidate array indexed by the flat slot ids
    (``channel * K + slot``), coordinates scaled back to original-image
    space."""
    pk = dev.compact.peaks
    sx, sy = dev.compact.coord_scale
    candidate = np.stack(
        [pk.x_ref.ravel().astype(np.float64) * sx,
         pk.y_ref.ravel().astype(np.float64) * sy,
         pk.score.ravel().astype(np.float64),
         np.arange(pk.score.size, dtype=np.float64)], axis=1)
    return dev.subset[dev.mask].astype(np.float64), candidate


def decode_device(dev: DeviceDecoded, skeleton: SkeletonConfig
                  ) -> List[Tuple[List[Optional[Tuple[float, float]]],
                                  float]]:
    """Finish a fused device decode on the host: O(people) work only.

    Callers must check ``dev.ok`` first; decoding an overflowed result
    would silently drop people.
    """
    subset, candidate = device_subset_candidate(dev)
    return subsets_to_keypoints(subset, candidate, skeleton)
