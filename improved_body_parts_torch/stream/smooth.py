"""Per-track temporal keypoint smoothing: One-Euro or EMA, gated on
joint presence so occluded joints never get dragged (the port's own copy
of ``improved_body_parts_tpu/stream/smooth.py``).

Decoded keypoints jitter frame to frame (peak refinement quantization +
detection noise); a video overlay wants them stable.  The One-Euro
filter (Casiez et al., CHI 2012) is the standard interactive-tracking
answer: a low-pass whose cutoff ADAPTS to speed — heavy smoothing when
the joint is near-still (where jitter is visible), light smoothing when
it moves fast (where lag is visible).  An EMA mode is kept as the
one-knob baseline.

The gate: a joint absent from this frame's decode (``None`` — occluded
or outside the crowd's assembly) produces ``None`` out and leaves the
filter state untouched; a joint that reappears after more than
``reset_after`` missed frames RESETS its filter instead of smoothing
from the stale pre-occlusion position — smoothing across an occlusion
would drag the joint from where it vanished toward where it reappeared
over several frames, which reads as a tail in the overlay and moves
every reappearing joint off its true position.

Host-side NumPy by design: per frame the filter touches at most
(tracks × 17 × 2) scalars — far below one frame's decode — and keeping
it off-device means no new jitted program, no recompile surface for
dynamic track counts, and nothing new for the graftaudit registry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .track import Keypoints


def _smoothing_alpha(cutoff_hz: float, freq_hz: float) -> float:
    """First-order low-pass coefficient for one step at ``freq_hz``."""
    tau = 1.0 / (2.0 * math.pi * max(cutoff_hz, 1e-6))
    return 1.0 / (1.0 + tau * freq_hz)


class _JointState:
    __slots__ = ("x", "dx", "last_frame")

    def __init__(self, x: np.ndarray, frame: int):
        self.x = x                  # (2,) filtered position
        self.dx = np.zeros(2)       # (2,) filtered velocity (units/frame*fps)
        self.last_frame = frame


class KeypointSmoother:
    """Stateful per-(track, joint) smoother for one stream.

    ::

        smoother = KeypointSmoother(mode="one_euro", fps=30.0)
        smoothed = smoother.apply(track_id, keypoints, frame_index)
        smoother.retain(tracker.live_ids())      # drop dead tracks' state

    ``mode="one_euro"`` knobs (``min_cutoff``, ``beta``, ``d_cutoff``)
    follow the paper's naming; ``mode="ema"`` uses ``ema_alpha`` (the
    weight of the NEW sample).  ``fps`` is the stream's nominal rate —
    frame gaps (dropped frames) scale the effective step so a 2-frame
    gap smooths like two steps, up to ``reset_after`` missed frames,
    past which the joint state resets (the occlusion gate).
    """

    def __init__(self, mode: str = "one_euro", fps: float = 30.0,
                 min_cutoff: float = 1.0, beta: float = 0.01,
                 d_cutoff: float = 1.0, ema_alpha: float = 0.4,
                 reset_after: int = 2):
        if mode not in ("one_euro", "ema"):
            raise ValueError(f"mode={mode!r} must be 'one_euro' or 'ema'")
        if fps <= 0:
            raise ValueError(f"fps={fps} must be > 0")
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={ema_alpha} must be in (0, 1]")
        if reset_after < 1:
            raise ValueError(f"reset_after={reset_after} must be >= 1")
        self.mode = mode
        self.fps = float(fps)
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.ema_alpha = float(ema_alpha)
        self.reset_after = int(reset_after)
        self._state: Dict[Tuple[int, int], _JointState] = {}

    def apply(self, track_id: int, keypoints: Keypoints,
              frame_index: int) -> Keypoints:
        """Smooth one track's keypoints for one frame; returns a new
        17-entry list (``None`` stays ``None``)."""
        out: Keypoints = []
        for joint, coord in enumerate(keypoints):
            if coord is None:
                out.append(None)        # gate: absent joints pass through
                continue
            x = np.asarray(coord, dtype=np.float64)
            key = (track_id, joint)
            st = self._state.get(key)
            # gap is the frame-index delta; gap - 1 frames were MISSED
            # (gap == 1 is consecutive) — reset only when MORE than
            # reset_after frames were missed, as documented
            gap = frame_index - st.last_frame if st is not None else 0
            if st is None or gap - 1 > self.reset_after or gap <= 0:
                # first sight, reappearance after occlusion, or a
                # non-monotonic frame index: start clean, no dragging
                self._state[key] = _JointState(x, frame_index)
                out.append((float(x[0]), float(x[1])))
                continue
            freq = self.fps / gap
            if self.mode == "ema":
                # a gap of g frames smooths like g EMA steps toward the
                # same sample: the retained weight of the old state is
                # (1 - alpha)^g (gap == 1 is exactly ema_alpha) — the
                # non-contiguous-frame-index contract the One-Euro
                # branch gets from its freq scaling below
                w = 1.0 - (1.0 - self.ema_alpha) ** gap
                st.x = w * x + (1.0 - w) * st.x
            else:
                dx = (x - st.x) * freq
                a_d = _smoothing_alpha(self.d_cutoff, freq)
                st.dx = a_d * dx + (1.0 - a_d) * st.dx
                cutoff = self.min_cutoff + self.beta * float(
                    np.linalg.norm(st.dx))
                a = _smoothing_alpha(cutoff, freq)
                st.x = a * x + (1.0 - a) * st.x
            st.last_frame = frame_index
            out.append((float(st.x[0]), float(st.x[1])))
        return out

    def forget(self, track_id: int) -> None:
        """Drop all state for one (dead) track."""
        for key in [k for k in self._state if k[0] == track_id]:
            del self._state[key]

    def retain(self, live_ids: Sequence[int]) -> None:
        """Drop state for every track NOT in ``live_ids`` — called after
        each tracker update so dead tracks cannot pin state forever (a
        long stream churns through unbounded ids otherwise)."""
        live = set(live_ids)
        for key in [k for k in self._state if k[0] not in live]:
            del self._state[key]

    @property
    def tracked_joints(self) -> int:
        return len(self._state)


def jitter_rms(xy_sequence: np.ndarray) -> float:
    """Per-joint jitter metric: RMS magnitude of the SECOND difference
    of a (T, 2) coordinate sequence (NaN rows = joint absent that frame;
    only triples of consecutive present frames contribute).

    The second difference cancels constant velocity, so for a person
    moving smoothly the metric isolates the frame-to-frame noise a
    smoother is supposed to remove — the gateable number of the
    acceptance criterion ("the smoothing filter measurably reduces a
    per-track jitter metric").
    """
    xy = np.asarray(xy_sequence, dtype=np.float64)
    if xy.ndim != 2 or xy.shape[1] != 2 or xy.shape[0] < 3:
        return 0.0
    ok = ~np.isnan(xy).any(axis=1)
    triple = ok[:-2] & ok[1:-1] & ok[2:]
    if not triple.any():
        return 0.0
    acc = xy[2:] - 2.0 * xy[1:-1] + xy[:-2]
    mag2 = (acc[triple] ** 2).sum(axis=1)
    return float(np.sqrt(mag2.mean()))


def keypoint_sequence_jitter(
        per_frame: Sequence[Keypoints]) -> float:
    """Mean :func:`jitter_rms` over the 17 joints of ONE track's
    per-frame keypoint lists (``None`` = absent)."""
    if not per_frame:
        return 0.0
    t = len(per_frame)
    n = len(per_frame[0])
    vals: List[float] = []
    for joint in range(n):
        seq = np.full((t, 2), np.nan)
        for fi, kps in enumerate(per_frame):
            c = kps[joint]
            if c is not None:
                seq[fi] = c
        v = jitter_rms(seq)
        if v > 0.0:
            vals.append(v)
    return float(np.mean(vals)) if vals else 0.0
