"""Temporal track identity: frame-to-frame greedy matching of decoded
people on an OKS-style keypoint similarity (the port's own copy of
``improved_body_parts_tpu/stream/track.py``).

The serve engine decodes each frame independently; this module is what
turns per-frame person lists into *tracks* — a per-stream, monotonically
assigned id that follows the same physical person across frames.  The
matcher reuses the COCO OKS falloff constants (``infer.oks``) so
"same person" means the same thing the evaluation protocol means by it,
with the scale normalizer taken from the track's own keypoint extent
(video frames carry no GT segment area).

Matching is greedy on the global similarity maximum — the same
tie-breaking discipline as the decoder's limb assignment and COCOeval's
per-detection matching — which keeps the tracker fully deterministic for
a given detection stream (the property the synthetic-suite gates assert:
0 identity switches on clean non-crossing streams).

All host-side NumPy: per frame the matrix is at most
(live tracks × detections) ≈ 20×20 similarities, orders of magnitude
below one frame's decode — a device variant would only add lane
shapes for dynamic people counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..infer.oks import COCO_SIGMAS

# keypoints as decode emits them: 17 COCO-order entries, (x, y) or None
Keypoints = List[Optional[Tuple[float, float]]]

_K2 = (2.0 * COCO_SIGMAS) ** 2


def _to_arrays(coords: Keypoints) -> Tuple[np.ndarray, np.ndarray]:
    """(17, 2) float64 coordinates + (17,) validity mask."""
    xy = np.zeros((len(coords), 2), dtype=np.float64)
    valid = np.zeros(len(coords), dtype=bool)
    for i, c in enumerate(coords):
        if c is not None:
            xy[i] = c
            valid[i] = True
    return xy, valid


def _extent_area(xy: np.ndarray, valid: np.ndarray) -> float:
    """OKS scale normalizer from the keypoints themselves: the tight
    bbox over the valid joints (floored so a near-degenerate pose —
    one visible joint — cannot blow the exponent up)."""
    if not valid.any():
        return 1.0
    v = xy[valid]
    w = float(v[:, 0].max() - v[:, 0].min())
    h = float(v[:, 1].max() - v[:, 1].min())
    return max(w * h, 64.0)


def keypoint_similarity(ref_xy: np.ndarray, ref_valid: np.ndarray,
                        det_xy: np.ndarray, det_valid: np.ndarray,
                        area: Optional[float] = None) -> float:
    """OKS-style similarity in [0, 1] between a reference pose (a track's
    last keypoints) and a detection, over the joints BOTH carry.

    Unlike evaluation OKS (``infer.oks.oks``), missing joints are
    excluded from the mean instead of penalized: a joint that went
    occluded between frames says nothing about identity.
    """
    both = ref_valid & det_valid
    if not both.any():
        return 0.0
    if area is None:
        area = _extent_area(ref_xy, ref_valid)
    d2 = ((det_xy[both] - ref_xy[both]) ** 2).sum(axis=1)
    e = d2 / (2.0 * max(area, 1e-9) * _K2[both])
    return float(np.exp(-e).mean())


def greedy_match(sim: np.ndarray, threshold: float
                 ) -> List[Tuple[int, int]]:
    """Greedy one-to-one assignment on the (n_ref, n_det) similarity
    matrix: repeatedly take the global maximum above ``threshold``.
    Ties break on the lowest reference index then lowest detection
    index (deterministic for a deterministic detection stream)."""
    if sim.size == 0:
        return []
    pairs: List[Tuple[int, int]] = []
    work = sim.copy()
    while True:
        ri, di = np.unravel_index(int(np.argmax(work)), work.shape)
        if work[ri, di] < threshold:
            return pairs
        pairs.append((int(ri), int(di)))
        work[ri, :] = -1.0
        work[:, di] = -1.0


class TrackedPerson(NamedTuple):
    """One detection with its temporal identity attached — what a
    :class:`stream.session.StreamSession` delivers per frame."""
    track_id: int
    keypoints: Keypoints
    score: float
    age: int            # delivered frames since this track was born


@dataclass
class Track:
    """Internal per-track state."""
    track_id: int
    xy: np.ndarray                 # (17, 2) last matched coordinates
    valid: np.ndarray              # (17,) last matched validity
    keypoints: Keypoints
    score: float
    hits: int = 1                  # frames this track matched
    misses: int = 0                # consecutive unmatched frames
    born_at: int = 0               # tracker frame index at birth
    last_seen: int = 0             # tracker frame index of last match
    #: (17, 2) px/frame constant-velocity estimate from the last two
    #: observations (None until the second match) — what the stream
    #: fast path extrapolates skipped frames from
    vel: Optional[np.ndarray] = None

    def predicted_xy(self, at_frame: int) -> np.ndarray:
        """Constant-velocity position at ``at_frame`` (>= last_seen):
        the last observation advanced by the velocity estimate."""
        if self.vel is None:
            return self.xy
        return self.xy + self.vel * max(at_frame - self.last_seen, 0)


class Tracker:
    """Greedy frame-to-frame keypoint tracker for ONE stream.

    ::

        tracker = Tracker(max_age=10, min_similarity=0.2)
        for people in per_frame_decodes:          # [(coords, score), ...]
            tracked = tracker.update(people)      # [TrackedPerson, ...]

    - a detection matching a live track (OKS-style similarity ≥
      ``min_similarity``, greedy global-max assignment) inherits its id;
    - an unmatched detection births a new track with the next id from a
      per-tracker monotonic counter (ids are never reused, so a reborn
      person is a *visible* birth, not a silent identity steal);
    - an unmatched track coasts (its last pose stays the match
      reference) for up to ``max_age`` consecutive frames, then dies.

    ``births`` / ``deaths`` are the track-churn counters the obs stack
    exports; identity *switches* need ground truth and live in
    :class:`IdentitySwitchCounter` (the synthetic gates / bench).
    """

    def __init__(self, max_age: int = 10, min_similarity: float = 0.2):
        if max_age < 0:
            raise ValueError(f"max_age={max_age} must be >= 0")
        if not 0.0 < min_similarity <= 1.0:
            raise ValueError(f"min_similarity={min_similarity} "
                             "must be in (0, 1]")
        self.max_age = max_age
        self.min_similarity = min_similarity
        self.tracks: List[Track] = []
        self.frame_index = 0       # frames seen (update() calls)
        self.births = 0
        self.deaths = 0
        self._next_id = 1

    @property
    def active(self) -> int:
        """Live tracks (matched or still coasting)."""
        return len(self.tracks)

    def update(self, people: Sequence[Tuple[Keypoints, float]]
               ) -> List[TrackedPerson]:
        """Consume one frame's decoded people; returns them with track
        ids attached, in detection order."""
        dets = [_to_arrays(coords) for coords, _ in people]
        sim = np.zeros((len(self.tracks), len(dets)), dtype=np.float64)
        for ti, tr in enumerate(self.tracks):
            area = _extent_area(tr.xy, tr.valid)
            for di, (xy, valid) in enumerate(dets):
                sim[ti, di] = keypoint_similarity(tr.xy, tr.valid,
                                                  xy, valid, area=area)
        pairs = greedy_match(sim, self.min_similarity)
        det_track: Dict[int, Track] = {}
        matched_tracks = set()
        for ti, di in pairs:
            tr = self.tracks[ti]
            xy, valid = dets[di]
            coords, score = people[di]
            # constant-velocity estimate from the last two OBSERVATIONS
            # of this track, per joint, over the real frame gap (a track
            # re-found after coasting/skipping divides by the full gap).
            # Joints not visible in both frames keep their previous
            # estimate (an occluded joint keeps moving with the person).
            gap = max(self.frame_index - tr.last_seen, 1)
            both = tr.valid & valid
            vel = (tr.vel.copy() if tr.vel is not None
                   else np.zeros_like(xy))
            vel[both] = (xy[both] - tr.xy[both]) / gap
            tr.vel = vel
            tr.xy, tr.valid = xy, valid
            tr.keypoints, tr.score = list(coords), float(score)
            tr.hits += 1
            tr.misses = 0
            tr.last_seen = self.frame_index
            det_track[di] = tr
            matched_tracks.add(ti)
        for di, (xy, valid) in enumerate(dets):
            if di in det_track:
                continue
            coords, score = people[di]
            tr = Track(track_id=self._next_id, xy=xy, valid=valid,
                       keypoints=list(coords), score=float(score),
                       born_at=self.frame_index,
                       last_seen=self.frame_index)
            self._next_id += 1
            self.births += 1
            self.tracks.append(tr)
            det_track[di] = tr
        survivors: List[Track] = []
        for ti, tr in enumerate(self.tracks):
            if ti < len(sim) and ti not in matched_tracks:
                tr.misses += 1
                if tr.misses > self.max_age:
                    self.deaths += 1
                    continue
            survivors.append(tr)
        self.tracks = survivors
        out = [TrackedPerson(det_track[di].track_id, people[di][0],
                             float(people[di][1]),
                             self.frame_index - det_track[di].born_at)
               for di in range(len(dets))]
        self.frame_index += 1
        return out

    @property
    def confirmed(self) -> int:
        """Live tracks the most recent real frame actually matched
        (``misses == 0``) — the population :meth:`predict_frame` answers
        with; coasting tracks are excluded (their person was already
        missing from the last observation)."""
        return sum(1 for tr in self.tracks if tr.misses == 0)

    def predict_frame(self) -> List[TrackedPerson]:
        """Advance ONE frame without detections: every confirmed track
        answers with its constant-velocity extrapolation — the stream
        fast path's tracker tier (``stream.fastpath``).

        Consumes a frame slot exactly like :meth:`update` (ages and
        later velocity gaps stay in real-frame units) but mutates no
        track state: the next real frame's match still compares against
        the last OBSERVED pose extrapolated over the full gap
        (:meth:`Track.predicted_xy`), so repeated skips extrapolate
        linearly instead of compounding prediction error.
        """
        out: List[TrackedPerson] = []
        for tr in self.tracks:
            if tr.misses:
                continue
            xy = tr.predicted_xy(self.frame_index)
            kps: Keypoints = [
                (float(xy[j, 0]), float(xy[j, 1])) if tr.valid[j] else None
                for j in range(len(tr.valid))]
            out.append(TrackedPerson(tr.track_id, kps, tr.score,
                                     self.frame_index - tr.born_at))
        self.frame_index += 1
        return out

    def union_box(self) -> Optional[Tuple[float, float, float, float]]:
        """Tight (x0, y0, x1, y1) over every live track's valid joints
        at their constant-velocity position for the CURRENT frame index
        (coasting tracks included — their person may only have missed a
        detection), or ``None`` with no live tracks.  The stream fast
        path crops ROI re-inference to this box."""
        lo = np.array([np.inf, np.inf])
        hi = np.array([-np.inf, -np.inf])
        any_joint = False
        for tr in self.tracks:
            if not tr.valid.any():
                continue
            xy = tr.predicted_xy(self.frame_index)[tr.valid]
            lo = np.minimum(lo, xy.min(axis=0))
            hi = np.maximum(hi, xy.max(axis=0))
            any_joint = True
        if not any_joint:
            return None
        return (float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1]))

    def live_ids(self) -> List[int]:
        return [tr.track_id for tr in self.tracks]

    def snapshot(self) -> dict:
        return {"frames": self.frame_index, "active": self.active,
                "births": self.births, "deaths": self.deaths,
                "next_id": self._next_id}


class IdentitySwitchCounter:
    """Identity-switch accounting against known ground truth (the
    synthetic video suite / ``cli.stream_bench``).

    Per frame, ground-truth people are greedily matched to the
    tracker's output on the same OKS-style similarity; a GT person whose
    matched track id DIFFERS from the last track id it was matched to is
    one identity switch (the MOTA IDSW convention — first appearance and
    frames where the person went unmatched are not switches).
    """

    def __init__(self, min_similarity: float = 0.2):
        self.min_similarity = min_similarity
        self.switches = 0
        self.matched_frames = 0
        self._last: Dict[object, int] = {}     # gt id -> last track id

    def update(self, gt_people: Sequence[Tuple[object, Keypoints]],
               tracked: Sequence[TrackedPerson]) -> int:
        """Consume one frame; returns switches counted THIS frame.

        :param gt_people: (gt_id, 17-keypoint list) per planted person
        :param tracked: the tracker's output for the same frame
        """
        refs = [_to_arrays(coords) for _, coords in gt_people]
        dets = [_to_arrays(p.keypoints) for p in tracked]
        sim = np.zeros((len(refs), len(dets)), dtype=np.float64)
        for gi, (gxy, gvalid) in enumerate(refs):
            area = _extent_area(gxy, gvalid)
            for di, (dxy, dvalid) in enumerate(dets):
                sim[gi, di] = keypoint_similarity(gxy, gvalid, dxy, dvalid,
                                                  area=area)
        frame_switches = 0
        for gi, di in greedy_match(sim, self.min_similarity):
            gt_id = gt_people[gi][0]
            tid = tracked[di].track_id
            prev = self._last.get(gt_id)
            if prev is not None and prev != tid:
                frame_switches += 1
            self._last[gt_id] = tid
            self.matched_frames += 1
        self.switches += frame_switches
        return frame_switches

    def snapshot(self) -> dict:
        return {"identity_switches": self.switches,
                "matched_frames": self.matched_frames}
