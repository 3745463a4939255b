"""Heatmap decoding on the host: peaks → limb connections → greedy person
assembly, and the host finish of the compact and fused device payloads.

The port's own copy of ``improved_body_parts_tpu/infer/decode.py``
(reference: evaluate.py:169-498), NumPy only: the pair-scoring loops are
vectorized (the reference's pure-Python double loops are its
acknowledged 5.2 FPS bottleneck, README.md:68).  A native C++ path for
the assembly lives in ``infer.native`` (same semantics, built from
native/decoder.cpp); ``find_people`` here is the reference NumPy path.
The serving engine runs this module on its overflow fallbacks and on its
host-pool lane.

Data model (matches the reference so AP-sensitive tie-breaking is preserved):
- ``peaks``: per part, an (n_i, 4) array of [x, y, score, global_peak_id]
- ``connections``: per limb, an (m_k, 6) array of
  [peak_id_A, peak_id_B, score, index_in_candA, index_in_candB, length]
- ``subset``: (P, num_parts+2, 2) — per person, per part
  [peak_id, confidence]; row -2 = [total score, —]; row -1 =
  [part count, longest limb length]

Documented deviation: the reference's sub-pixel refinement transposes its x/y
offset grids (evaluate.py:194 → utils/util.py:205-207), adding the y-offset to
x and vice versa; we apply the offsets to their own axes (the reference notes
the refinement "dose not affect the results").
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import InferenceParams, SkeletonConfig
from ..ops.nms import peak_mask_np, refine_peaks


def find_peaks(heatmap: np.ndarray, params: InferenceParams,
               num_parts: int = 18,
               peak_mask: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Peak lists per keypoint channel (reference: evaluate.py:169-203).

    :param heatmap: (H, W, >=num_parts) averaged keypoint maps
    :param peak_mask: optional precomputed boolean NMS mask (the on-device
        fast path, Predictor.predict_fast); computed on the host otherwise
    :returns: per part, (n_i, 4) array [x, y, score, global id]
    """
    heat32 = np.ascontiguousarray(heatmap[:, :, :num_parts], dtype=np.float32)
    mask = (peak_mask[:, :, :num_parts] if peak_mask is not None
            else peak_mask_np(heat32, thre=params.thre1))

    # one pass over the boolean volume in part-major order (the per-channel
    # nonzero loop over float maps was the decode hot spot)
    cs_all, ys_all, xs_all = np.nonzero(mask.transpose(2, 0, 1))
    bounds = np.searchsorted(cs_all, np.arange(num_parts + 1))

    all_peaks: List[np.ndarray] = []
    peak_counter = 0
    for part in range(num_parts):
        lo, hi = bounds[part], bounds[part + 1]
        xs, ys = xs_all[lo:hi], ys_all[lo:hi]
        x_ref, y_ref, score = refine_peaks(
            heat32[:, :, part], xs, ys, params.offset_radius)
        n = xs.shape[0]
        ids = np.arange(peak_counter, peak_counter + n, dtype=np.float64)
        all_peaks.append(
            np.stack([x_ref, y_ref, score, ids], axis=1) if n else
            np.zeros((0, 4)))
        peak_counter += n
    return all_peaks


def _sample_limb_scores(paf_channel: np.ndarray, a: np.ndarray, b: np.ndarray,
                        m: np.ndarray, num_samples: int) -> np.ndarray:
    """Sample the limb map between every A/B pair.

    Pair (i, j) is sampled at m[i,j] points evenly spaced over the FULL
    segment — linspace(A, B, m) like the reference (evaluate.py:232-239) —
    laid out in the first m slots of a fixed (nA, nB, num_samples) tensor
    (nearest-pixel lookup).
    """
    h, w = paf_channel.shape
    s = np.arange(num_samples, dtype=np.float64)
    # t[i,j,s] = s / (m[i,j]-1), the linspace positions for that pair
    denom = np.maximum(m - 1, 1).astype(np.float64)
    t = np.minimum(s[None, None, :] / denom[:, :, None], 1.0)
    pts = a[:, None, None, :] + t[..., None] * (
        b[None, :, None, :] - a[:, None, None, :])
    xi = np.clip(np.round(pts[..., 0]).astype(np.int64), 0, w - 1)
    yi = np.clip(np.round(pts[..., 1]).astype(np.int64), 0, h - 1)
    return paf_channel[yi, xi]


def find_connections(all_peaks: Sequence[np.ndarray], paf: np.ndarray,
                     image_size: int, params: InferenceParams,
                     limbs_conn: Sequence[Tuple[int, int]]
                     ) -> Tuple[List[np.ndarray], List[int]]:
    """Score and greedily select limb connections
    (reference: evaluate.py:206-276).

    :param paf: (H, W, paf_layers) averaged limb maps
    :param image_size: the length-penalty scale; the reference passes the
        image *height* (evaluate.py:510 passes ``oriImg.shape[0]``)
    :returns: (connections per limb, indices of limbs with no candidates)
    """
    connection_all: List[np.ndarray] = []
    special_k: List[int] = []
    S = params.mid_num

    for k, (ia, ib) in enumerate(limbs_conn):
        cand_a, cand_b = all_peaks[ia], all_peaks[ib]
        na, nb = len(cand_a), len(cand_b)
        if na == 0 or nb == 0:
            special_k.append(k)
            connection_all.append(np.zeros((0, 6)))
            continue

        a_xy, b_xy = cand_a[:, :2], cand_b[:, :2]
        vec = b_xy[None, :, :] - a_xy[:, None, :]
        norm = np.sqrt((vec ** 2).sum(-1))                     # (na, nb)
        # the reference samples min(round(norm+1), S) points per pair
        m = np.minimum(np.round(norm + 1).astype(np.int64), S)  # (na, nb)
        scores = _sample_limb_scores(paf[:, :, k], a_xy, b_xy, m, S)
        sample_idx = np.arange(S)[None, None, :]
        valid = sample_idx < m[:, :, None]
        msum = np.where(m > 0, m, 1)
        mean_score = (scores * valid).sum(-1) / msum
        above = ((scores > params.thre2) & valid).sum(-1)

        prior, ok = _acceptance(mean_score, above, m, norm, image_size,
                                params)
        connection_all.append(
            _greedy_select(cand_a, cand_b, prior, ok, norm))
    return connection_all, special_k


def _acceptance(mean_score: np.ndarray, above: np.ndarray, m: np.ndarray,
                norm: np.ndarray, image_size: int, params: InferenceParams
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The limb acceptance rule shared by the host and compact paths:
    length-penalized prior + the ≥connect_ration-of-samples criterion
    (reference: evaluate.py:241-251)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        prior = mean_score + np.minimum(0.5 * image_size / norm - 1.0, 0.0)
    ok = ((above >= params.connect_ration * m)
          & (prior > 0) & (norm > 0))
    return prior, ok


def _greedy_select(cand_a: np.ndarray, cand_b: np.ndarray, prior: np.ndarray,
                   ok: np.ndarray, norm: np.ndarray) -> np.ndarray:
    """Greedy one-to-one limb selection over the (nA, nB) pair grid, sorted
    by 0.5·prior + 0.25·(endpoint scores) (reference: evaluate.py:254-271).
    """
    na, nb = len(cand_a), len(cand_b)
    ii, jj = np.nonzero(ok)
    if ii.size == 0:
        return np.zeros((0, 6))
    sel_prior = prior[ii, jj]
    rank = (0.5 * sel_prior + 0.25 * cand_a[ii, 2] + 0.25 * cand_b[jj, 2])
    order = np.argsort(-rank, kind="stable")

    used_a = np.zeros(na, bool)
    used_b = np.zeros(nb, bool)
    rows = []
    limit = min(na, nb)
    for o in order:
        i, j = ii[o], jj[o]
        if used_a[i] or used_b[j]:
            continue
        used_a[i] = used_b[j] = True
        rows.append([cand_a[i, 3], cand_b[j, 3], sel_prior[o],
                     float(i), float(j), norm[i, j]])
        if len(rows) >= limit:
            break
    return np.asarray(rows, dtype=np.float64)


def find_people(connection_all: Sequence[np.ndarray],
                special_k: Sequence[int],
                all_peaks: Sequence[np.ndarray],
                params: InferenceParams,
                limbs_conn: Sequence[Tuple[int, int]],
                num_parts: int = 18) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy assembly of limb connections into people
    (reference: evaluate.py:279-498).  Tie-breaking order preserved.

    :returns: (subset (P, num_parts+2, 2), candidate (total_peaks, 4))
    """
    rows = num_parts + 2
    subset = -1 * np.ones((0, rows, 2))
    candidate = (np.concatenate([p for p in all_peaks], axis=0)
                 if sum(len(p) for p in all_peaks) else np.zeros((0, 4)))

    for k, (index_a, index_b) in enumerate(limbs_conn):
        if k in special_k:
            continue
        conns = connection_all[k]
        part_as = conns[:, 0]
        part_bs = conns[:, 1]

        for i in range(len(conns)):
            score = conns[i][2]
            limb_len = conns[i][-1]
            found_idx = []
            for j in range(len(subset)):
                if int(subset[j][index_a][0]) == int(part_as[i]) or \
                        int(subset[j][index_b][0]) == int(part_bs[i]):
                    if len(found_idx) < 2:
                        found_idx.append(j)
            found = len(found_idx)

            if found == 1:
                j = found_idx[0]
                if int(subset[j][index_b][0]) == -1 and \
                        params.len_rate * subset[j][-1][1] > limb_len:
                    # slot empty and the new limb is not absurdly long:
                    # assign part B to this person (evaluate.py:320-344)
                    subset[j][index_b][0] = part_bs[i]
                    subset[j][index_b][1] = score
                    subset[j][-1][0] += 1
                    subset[j][-2][0] += candidate[int(part_bs[i]), 2] + score
                    subset[j][-1][1] = max(limb_len, subset[j][-1][1])
                elif int(subset[j][index_b][0]) != int(part_bs[i]):
                    if subset[j][index_b][1] >= score:
                        pass  # existing connection is more confident
                    elif params.len_rate * subset[j][-1][1] <= limb_len:
                        pass
                    else:
                        # replace the weaker existing part B
                        # (evaluate.py:346-363)
                        subset[j][-2][0] -= (
                            candidate[int(subset[j][index_b][0]), 2]
                            + subset[j][index_b][1])
                        subset[j][index_b][0] = part_bs[i]
                        subset[j][index_b][1] = score
                        subset[j][-2][0] += candidate[int(part_bs[i]), 2] + score
                        subset[j][-1][1] = max(limb_len, subset[j][-1][1])
                elif int(subset[j][index_b][0]) == int(part_bs[i]) and \
                        subset[j][index_b][1] <= score:
                    # same part re-detected with higher confidence: rescore
                    # (evaluate.py:368-380)
                    subset[j][-2][0] -= (
                        candidate[int(subset[j][index_b][0]), 2]
                        + subset[j][index_b][1])
                    subset[j][index_b][0] = part_bs[i]
                    subset[j][index_b][1] = score
                    subset[j][-2][0] += candidate[int(part_bs[i]), 2] + score
                    subset[j][-1][1] = max(limb_len, subset[j][-1][1])

            elif found == 2:
                j1, j2 = found_idx
                membership1 = (subset[j1][:-2, 0] >= 0).astype(int)
                membership2 = (subset[j2][:-2, 0] >= 0).astype(int)
                if ((membership1 + membership2) == 2).sum() == 0:
                    # disjoint people sharing this limb: merge, gated by
                    # confidence and length priors (evaluate.py:403-424)
                    min_limb1 = np.min(subset[j1, :-2, 1][membership1 == 1])
                    min_limb2 = np.min(subset[j2, :-2, 1][membership2 == 1])
                    min_tolerance = min(min_limb1, min_limb2)
                    if score < params.connection_tole * min_tolerance or \
                            params.len_rate * subset[j1][-1][1] <= limb_len:
                        continue
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:, 0] += subset[j2][-2:, 0]
                    subset[j1][-2][0] += score
                    subset[j1][-1][1] = max(limb_len, subset[j1][-1][1])
                    subset = np.delete(subset, j2, 0)
                else:
                    # two people compete for this limb (evaluate.py:426-460)
                    if conns[i][0] in subset[j1, :-2, 0]:
                        c1 = np.where(subset[j1, :-2, 0] == conns[i][0])
                        c2 = np.where(subset[j2, :-2, 0] == conns[i][1])
                    else:
                        c1 = np.where(subset[j1, :-2, 0] == conns[i][1])
                        c2 = np.where(subset[j2, :-2, 0] == conns[i][0])
                    c1, c2 = int(c1[0][0]), int(c2[0][0])
                    assert c1 != c2, "one keypoint shared by two people"
                    if score < subset[j1][c1][1] and score < subset[j2][c2][1]:
                        continue
                    small_j, remove_c = j1, c1
                    if subset[j1][c1][1] > subset[j2][c2][1]:
                        small_j, remove_c = j2, c2
                    if params.remove_recon > 0:
                        subset[small_j][-2][0] -= (
                            candidate[int(subset[small_j][remove_c][0]), 2]
                            + subset[small_j][remove_c][1])
                        subset[small_j][remove_c][0] = -1
                        subset[small_j][remove_c][1] = -1
                        subset[small_j][-1][0] -= 1

            elif found == 0:
                # no owner: create a new person (evaluate.py:473-488)
                row = -1 * np.ones((rows, 2))
                row[index_a][0] = part_as[i]
                row[index_a][1] = score
                row[index_b][0] = part_bs[i]
                row[index_b][1] = score
                row[-1][0] = 2
                row[-1][1] = limb_len
                row[-2][0] = (candidate[conns[i, :2].astype(int), 2].sum()
                              + score)
                subset = np.concatenate((subset, row[None]), axis=0)

    # prune sparse / low-confidence people (evaluate.py:491-496)
    keep = []
    for i in range(len(subset)):
        parts_count = subset[i][-1][0]
        if parts_count >= params.min_parts and \
                subset[i][-2][0] / parts_count >= params.min_mean_score:
            keep.append(i)
    return subset[keep], candidate


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


def assemble(heatmap: np.ndarray, paf: np.ndarray, params: InferenceParams,
             skeleton: SkeletonConfig, use_native: bool = True,
             peak_mask: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(heat, paf) maps → (subset, candidate): peaks + connection scoring +
    greedy assembly, dispatched to the native C++ path when built."""
    all_peaks = find_peaks(heatmap, params, skeleton.num_parts, peak_mask)
    image_size = heatmap.shape[0]
    if use_native:
        from .native import native_available, native_find_connections_people
        if native_available():
            return native_find_connections_people(
                all_peaks, paf, image_size, params, skeleton.limbs_conn,
                skeleton.num_parts)
    connection_all, special_k = find_connections(
        all_peaks, paf, image_size, params, skeleton.limbs_conn)
    return find_people(connection_all, special_k, all_peaks, params,
                       skeleton.limbs_conn, skeleton.num_parts)


class CompactResult(NamedTuple):
    """Host-side payload of the compact inference path
    (``Predictor.predict_compact``): top-K peak records + rank-ordered
    accepted limb candidates, both computed on the device (``ops.peaks``).
    """
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
    (``Predictor.predict_decoded``): the assembled person table from
    ``ops.assembly.greedy_assemble`` plus the compact records it was
    built from (the fallback input when an overflow flag is set).

    ``subset`` uses flat slot ids (``channel * top_k + slot``) — feed it
    to :func:`decode_device`, never to the host ``subsets_to_keypoints``
    with a row-major candidate array.
    """
    subset: np.ndarray          # (P_max, num_parts + 2, 2) float32
    mask: np.ndarray            # (P_max,) bool — pruned-in people
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


class EscalationSignals(NamedTuple):
    """The free per-request difficulty readout of the fused decode
    payload (what a cascade's escalation policy reads): person count,
    the three capacity-overflow flags and the weakest kept person's mean
    per-part assembly score — all already in the single fetch, so a
    routing decision on them costs zero extra device work.
    """
    n_people: int
    peak_overflow: bool
    cand_overflow: bool
    person_overflow: bool
    #: min over kept people of (total score / part count) — the
    #: assembly's own pruning statistic; +inf when nobody was kept
    min_mean_score: float
    #: True when the signals came from the authoritative device assembly
    #: (False = an overflow routed this request to the host fallback;
    #: the flags above still say WHY)
    fused: bool


def device_signals(dev: "DeviceDecoded") -> EscalationSignals:
    """Extract :class:`EscalationSignals` from a fused device decode —
    O(people) reads on the already-fetched buffer, no decode needed."""
    n = dev.subset.shape[1] - 2
    kept = dev.subset[dev.mask]
    if len(kept):
        counts = np.maximum(kept[:, n + 1, 0], 1.0)
        min_mean = float(np.min(kept[:, n, 0] / counts))
    else:
        min_mean = float("inf")
    return EscalationSignals(
        n_people=int(dev.n_people),
        peak_overflow=bool(dev.peak_overflow),
        cand_overflow=bool(dev.cand_overflow),
        person_overflow=bool(dev.person_overflow),
        min_mean_score=min_mean,
        fused=dev.ok)


def device_subset_candidate(dev: "DeviceDecoded"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(subset, candidate) from a fused device decode, in the host
    decoder's array convention: the pruned person table (float64) plus a
    candidate array indexed by the kernel's flat slot ids
    (``channel * K + slot``), coordinates scaled back to original-image
    space.  :func:`subsets_to_keypoints` consumes this pair
    directly."""
    pk = dev.compact.peaks
    sx, sy = dev.compact.coord_scale
    candidate = np.stack(
        [pk.x_ref.ravel().astype(np.float64) * sx,
         pk.y_ref.ravel().astype(np.float64) * sy,
         pk.score.ravel().astype(np.float64),
         np.arange(pk.score.size, dtype=np.float64)], axis=1)
    return dev.subset[dev.mask].astype(np.float64), candidate


def decode_device(dev: "DeviceDecoded", skeleton: SkeletonConfig
                  ) -> List[Tuple[List[Optional[Tuple[float, float]]],
                                  float]]:
    """Finish a fused device decode on the host: O(people) work only.

    The device already ran peak extraction, candidate scoring AND greedy
    assembly (``ops.assembly``); all that remains is the id→coordinate
    lookup + COCO reordering of ``subsets_to_keypoints``, fed with a
    candidate array in the kernel's flat slot-id indexing
    (``channel * K + slot``) with coordinates scaled back to
    original-image space.

    Callers must check ``dev.ok`` first (``infer.pipeline
    .device_decode_fn`` wraps this with the documented overflow
    fallback); decoding an overflowed result would silently drop people.
    """
    subset, candidate = device_subset_candidate(dev)
    return subsets_to_keypoints(subset, candidate, skeleton)


def decode_compact(compact: CompactResult, params: InferenceParams,
                   skeleton: SkeletonConfig, use_native: bool = True):
    """Decode from on-device peak records + accepted limb candidates.

    Equivalent to ``decode`` on the fast path's maps: peak lists are
    rebuilt in the host path's row-major order; the device already applied
    the acceptance rule and ranked the surviving pairs
    (``ops.peaks.limb_topk_from_stats``), so the host walks each limb's
    candidates in rank order applying only the one-to-one used-peak filter
    (reference: evaluate.py:260-271), then person assembly runs unchanged
    (dispatching to the native C++ ``assemble_people`` when built).

    :raises CompactOverflow: when a channel's true NMS peak count exceeds
        the top-K capacity (``Predictor(compact_topk=...)``) or a limb's
        accepted-pair count exceeds the candidate cap.  Callers (the
        pipeline) catch this and fall back to the full-map path.
    :raises RuntimeError: when a device candidate references an invalid
        peak slot — a corrupt payload, deliberately NOT CompactOverflow:
        it must surface as a hard error, never a silent fallback.
    """
    pk, cd = compact.peaks, compact.stats
    num_parts = skeleton.num_parts
    over = np.nonzero(pk.count > pk.valid.shape[1])[0]
    if over.size:
        raise CompactOverflow(
            f"channels {over.tolist()} have {pk.count[over].tolist()} NMS "
            f"peaks > top-K capacity {pk.valid.shape[1]}")
    over = np.nonzero(cd.count > cd.valid.shape[1])[0]
    if over.size:
        raise CompactOverflow(
            f"limbs {over.tolist()} have {cd.count[over].tolist()} accepted "
            f"pairs > candidate capacity {cd.valid.shape[1]}")

    # rebuild per-part peak lists in the host path's order: row-major by
    # raw integer coords (np.nonzero order), ids sequential across parts
    all_peaks: List[np.ndarray] = []
    slot_pos: List[np.ndarray] = []   # top-K slot -> row-major index
    peak_counter = 0
    k_cap = pk.valid.shape[1]
    for c in range(num_parts):
        slots = np.nonzero(pk.valid[c])[0]
        order = np.lexsort((pk.xs[c, slots], pk.ys[c, slots]))
        slots = slots[order]
        n = slots.size
        ids = np.arange(peak_counter, peak_counter + n, dtype=np.float64)
        all_peaks.append(
            np.stack([pk.x_ref[c, slots].astype(np.float64),
                      pk.y_ref[c, slots].astype(np.float64),
                      pk.score[c, slots].astype(np.float64), ids], axis=1)
            if n else np.zeros((0, 4)))
        pos = np.full(k_cap, -1, np.int64)
        pos[slots] = np.arange(n)
        slot_pos.append(pos)
        peak_counter += n

    connection_all: List[np.ndarray] = []
    special_k: List[int] = []
    for k, (ia, ib) in enumerate(skeleton.limbs_conn):
        cand_a, cand_b = all_peaks[ia], all_peaks[ib]
        na, nb = len(cand_a), len(cand_b)
        if na == 0 or nb == 0:
            special_k.append(k)
            connection_all.append(np.zeros((0, 6)))
            continue
        # device candidates arrive acceptance-filtered and rank-sorted;
        # apply the one-to-one greedy used filter in that order
        used_a = np.zeros(na, bool)
        used_b = np.zeros(nb, bool)
        rows = []
        limit = min(na, nb)
        for slot in np.nonzero(cd.valid[k])[0]:
            sa = int(cd.slot_a[k, slot])
            sb = int(cd.slot_b[k, slot])
            # hard errors even under `python -O`: an out-of-range or
            # invalid slot would silently wrap to another peak (Python
            # negative indexing) and corrupt skeletons
            if not (0 <= sa < k_cap and 0 <= sb < k_cap):
                raise RuntimeError(
                    f"limb {k}: device candidate slot out of range "
                    f"(a={sa}, b={sb}, capacity={k_cap})")
            i = slot_pos[ia][sa]
            j = slot_pos[ib][sb]
            if i < 0 or j < 0:
                raise RuntimeError(
                    f"limb {k}: device candidate references an invalid "
                    f"peak slot (a={sa}, b={sb})")
            if used_a[i] or used_b[j]:
                continue
            used_a[i] = used_b[j] = True
            rows.append([cand_a[i, 3], cand_b[j, 3],
                         float(cd.prior[k, slot]), float(i), float(j),
                         float(cd.norm[k, slot])])
            if len(rows) >= limit:
                break
        connection_all.append(np.asarray(rows, dtype=np.float64)
                              if rows else np.zeros((0, 6)))

    subset = candidate = None
    if use_native:
        from .native import native_assemble_available, native_assemble_people
        if native_assemble_available():
            subset, candidate = native_assemble_people(
                connection_all, all_peaks, params, skeleton.limbs_conn,
                num_parts)
    if subset is None:
        subset, candidate = find_people(connection_all, special_k, all_peaks,
                                        params, skeleton.limbs_conn,
                                        num_parts)
    if len(candidate):
        candidate = candidate.copy()
        candidate[:, 0] *= compact.coord_scale[0]
        candidate[:, 1] *= compact.coord_scale[1]
    return subsets_to_keypoints(subset, candidate, skeleton)


def decode(heatmap: np.ndarray, paf: np.ndarray, params: InferenceParams,
           skeleton: SkeletonConfig, use_native: bool = True,
           peak_mask: Optional[np.ndarray] = None,
           coord_scale: Optional[Tuple[float, float]] = None):
    """Full decode: (H,W,heat+bkg) + (H,W,paf) maps → list of
    (coco keypoints, score) (reference: evaluate.py:501-543 ``process``).

    ``coord_scale`` maps decoded coordinates back to original-image space
    when decoding at network-input resolution (Predictor.predict_fast).
    """
    subset, candidate = assemble(heatmap, paf, params, skeleton, use_native,
                                 peak_mask)
    if coord_scale is not None and len(candidate):
        candidate = candidate.copy()
        candidate[:, 0] *= coord_scale[0]
        candidate[:, 1] *= coord_scale[1]
    return subsets_to_keypoints(subset, candidate, skeleton)
