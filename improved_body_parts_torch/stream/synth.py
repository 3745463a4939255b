"""Deterministic synthetic video: moving planted stick people, reusing
the SYNTH fixture machinery (``data.fixture``); the port's own copy of
``improved_body_parts_tpu/stream/synth.py``, frame for frame.

Tracker correctness must be a gateable number, not an eyeballed demo.
This generator produces, for a given seed, an exactly reproducible
sequence of frames with known per-person identity:

- each person is a ``data.fixture.synthetic_person`` stick figure (the
  same figures the learnable SYNTH corpus renders, so a trained/planted
  model can genuinely detect them);
- motion is constant-velocity with edge bounce; the **non-crossing**
  protocol confines each person to a private horizontal band (their
  bounding boxes can never overlap — any identity switch on this suite
  is a tracker bug, which is what lets tier-1 assert exactly 0);
- the **crossing** protocol (``crossing=True``) puts exactly two people
  at the same height moving through each other — the ambiguous case
  where a bounded number of switches is the honest spec;
- ``detections()`` derives decoder-shaped output (17 COCO-order
  keypoints + score) straight from the ground truth with seeded noise /
  dropout / order shuffling, so the tracker and smoother gates run in
  milliseconds without a model or a device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .track import Keypoints


class SyntheticVideo:
    """One deterministic stream of moving stick people.

    ::

        vid = SyntheticVideo(seed=0, num_people=3, num_frames=60)
        img = vid.frame(t)          # BGR uint8, rendered figures
        gt = vid.gt(t)              # [(person_id, (17,3) joints), ...]
        dets = vid.detections(t, noise=1.5)   # decoder-shaped output

    ``frame``/``gt``/``detections`` are pure functions of
    ``(constructor args, t)`` — any frame can be generated in any order,
    which is what lets N bench streams share one generator class without
    shared state.
    """

    def __init__(self, seed: int = 0, num_people: int = 2,
                 size: Tuple[int, int] = (240, 320), num_frames: int = 60,
                 crossing: bool = False, image_size: int = 512,
                 speed: float = 3.0, appear_at: Optional[Dict[int, int]]
                 = None, leave_at: Optional[Dict[int, int]] = None,
                 scene: str = "default"):
        from ..data.fixture import synthetic_person

        if crossing and num_people != 2:
            raise ValueError("crossing protocol is defined for exactly "
                             f"2 people, got {num_people}")
        if scene not in ("default", "static", "slow_pan"):
            raise ValueError(f"scene={scene!r} must be 'default', "
                             "'static' or 'slow_pan'")
        if crossing and scene != "default":
            raise ValueError("crossing defines its own motion; "
                             f"scene={scene!r} conflicts")
        self.scene = scene
        self.seed = int(seed)
        self.num_people = int(num_people)
        self.h, self.w = size
        self.num_frames = int(num_frames)
        self.crossing = crossing
        self.speed = float(speed)
        # person_id -> first/last frame the person is on canvas (bench
        # churn + track birth/death tests); default: whole stream
        self.appear_at = dict(appear_at or {})
        self.leave_at = dict(leave_at or {})
        rng = np.random.default_rng(self.seed)
        self._base: List[np.ndarray] = []      # (17, 3) centered joints
        self._start: List[np.ndarray] = []     # (2,) figure center at t=0
        self._vel: List[np.ndarray] = []       # (2,) px/frame
        self._half: List[np.ndarray] = []      # (2,) half extent (x, y)
        if crossing:
            bands = [(0.1, 0.9), (0.1, 0.9)]   # shared band: paths cross
        else:
            # private horizontal bands, one per person: boxes never meet
            edges = np.linspace(0.02, 0.98, self.num_people + 1)
            bands = [(edges[i], edges[i + 1])
                     for i in range(self.num_people)]
        for pid in range(self.num_people):
            y0, y1 = bands[pid]
            band_h = (y1 - y0) * self.h
            p = synthetic_person(rng, self.w, max(int(band_h), 24),
                                 image_size, all_visible=True)
            joints = np.asarray(p["joint"], dtype=np.float64)
            center = np.array([joints[:, 0].mean(), joints[:, 1].mean()])
            base = joints.copy()
            base[:, 0] -= center[0]
            base[:, 1] -= center[1]
            half = np.array([
                max(np.abs(base[:, 0]).max(), 1.0) + 3.0,
                max(np.abs(base[:, 1]).max(), 1.0) + 3.0])
            cy = (y0 * self.h + band_h / 2.0)
            if crossing:
                # two people at the SAME height, opposite horizontal
                # velocities, starting at opposite edges: they meet and
                # pass through each other mid-sequence
                cx = half[0] + 2.0 if pid == 0 else self.w - half[0] - 2.0
                v = np.array([self.speed if pid == 0 else -self.speed, 0.0])
                cy = self.h / 2.0
            else:
                cx = float(rng.uniform(half[0], self.w - half[0]))
                direction = 1.0 if rng.uniform() < 0.5 else -1.0
                v = np.array([direction * self.speed
                              * float(rng.uniform(0.7, 1.3)), 0.0])
            # scene protocols (fast-path gates): same seeded PLACEMENT
            # as the default churn — only the velocities change, AFTER
            # the rng draws, so a given seed puts people in the same
            # spots under every scene
            if scene == "static":
                # nothing moves: every frame's GT equals frame 0's —
                # the scene where skipping should approach max_skip_run
                v = np.zeros(2)
            elif scene == "slow_pan":
                # one SHARED slow velocity (a camera pan): constant-
                # velocity prediction is exact until a figure's
                # triangle-wave edge bounce (per-person extents make
                # bounces de-phase on long streams — bench lengths stay
                # inside the first leg)
                v = np.array([self.speed / 3.0, 0.0])
            self._base.append(base)
            self._start.append(np.array([cx, cy]))
            self._vel.append(v)
            self._half.append(half)

    # ---------------------------------------------------------- geometry
    def _center(self, pid: int, t: int) -> np.ndarray:
        """Figure center at frame ``t``: constant velocity, reflecting
        off the canvas edges (triangle-wave fold — stateless in t)."""
        c = self._start[pid] + self._vel[pid] * t
        out = c.copy()
        for axis in (0, 1):
            lo = self._half[pid][axis]
            hi = (self.w if axis == 0 else self.h) - self._half[pid][axis]
            span = max(hi - lo, 1.0)
            x = (c[axis] - lo) % (2.0 * span)
            out[axis] = lo + (x if x <= span else 2.0 * span - x)
        return out

    def present(self, pid: int, t: int) -> bool:
        return (self.appear_at.get(pid, 0) <= t
                < self.leave_at.get(pid, self.num_frames))

    def joints(self, pid: int, t: int) -> np.ndarray:
        """(17, 3) absolute joints (fixture visibility codes) at ``t``."""
        j = self._base[pid].copy()
        c = self._center(pid, t)
        j[:, 0] += c[0]
        j[:, 1] += c[1]
        return j

    # ------------------------------------------------------------ frames
    def frame(self, t: int) -> np.ndarray:
        """BGR uint8 frame ``t``: low-amplitude noise background (seeded
        per frame — deterministic) + the present figures rendered with
        the fixture's learnable draw protocol."""
        from ..data.fixture import draw_person

        rng = np.random.default_rng((self.seed, 977, t))
        img = rng.integers(0, 64, (self.h, self.w, 3), dtype=np.uint8)
        for pid in range(self.num_people):
            if self.present(pid, t):
                draw_person(img, self.joints(pid, t))
        return img

    def frames(self) -> List[np.ndarray]:
        return [self.frame(t) for t in range(self.num_frames)]

    def gt(self, t: int) -> List[Tuple[int, Keypoints]]:
        """Ground truth for frame ``t``: (person_id, 17 COCO-order
        keypoints) per present person — the ``IdentitySwitchCounter``
        input shape."""
        out = []
        for pid in range(self.num_people):
            if not self.present(pid, t):
                continue
            j = self.joints(pid, t)
            out.append((pid, [(float(x), float(y)) for x, y, _ in j]))
        return out

    def detections(self, t: int, noise: float = 0.0,
                   drop_joint_p: float = 0.0, shuffle: bool = True
                   ) -> List[Tuple[Keypoints, float]]:
        """Decoder-shaped detections for frame ``t``, derived from GT:
        per-joint Gaussian ``noise`` (px), per-joint dropout probability
        ``drop_joint_p`` (emitted as ``None`` — the occlusion gate's
        food), and person-order shuffling (a tracker keying on list
        order instead of geometry fails the gates immediately).  Seeded
        by ``(seed, t)`` — deterministic, frame-order independent."""
        rng = np.random.default_rng((self.seed, 1297, t))
        people = []
        for pid, coords in self.gt(t):
            kps: Keypoints = []
            for x, y in coords:
                if drop_joint_p > 0.0 and rng.uniform() < drop_joint_p:
                    kps.append(None)
                    continue
                kps.append((float(x + rng.normal(0.0, noise)),
                            float(y + rng.normal(0.0, noise)))
                           if noise > 0.0 else (x, y))
            people.append((kps, float(1.0 - 0.01 * pid)))
        if shuffle and len(people) > 1:
            order = rng.permutation(len(people))
            people = [people[i] for i in order]
        return people

    def stamped_frame(self, t: int) -> np.ndarray:
        """A cheap stand-in frame that encodes ``t`` in every pixel and
        each pixel's COLUMN coordinate alongside (:func:`read_stamp`) —
        so any width-crop of it is self-describing: the fast path's ROI
        tier can run over a :class:`DetectionEngine` exactly like a full
        frame, and the engine sees which window of the scene it was
        handed.  Rendering stick figures is pointless for an engine that
        answers from ground truth; this keeps the deterministic quality
        protocols allocation-cheap at full frame geometry."""
        if self.w >= 4096:
            raise ValueError("stamped frames encode columns in 12 bits "
                             f"(width {self.w} >= 4096)")
        img = np.empty((self.h, self.w, 3), dtype=np.uint8)
        img[..., 0] = np.uint8(t & 0xFF)
        xs = np.arange(self.w, dtype=np.uint16)
        img[..., 1] = (xs & 0xFF).astype(np.uint8)[None, :]
        img[..., 2] = (0xA0 | (xs >> 8)).astype(np.uint8)[None, :]
        return img


def read_stamp(image_bgr: np.ndarray) -> Tuple[int, int]:
    """``(t, x0)`` from a :meth:`SyntheticVideo.stamped_frame` or any
    width-crop of one — ``x0`` is the crop's left edge in full-frame
    coordinates (0 for the full frame).  ``t`` wraps at 256 (the
    generators are pure in ``t``, so benches index frames modulo the
    clip length anyway)."""
    px = image_bgr[0, 0]
    if (int(px[2]) & 0xF0) != 0xA0:
        raise ValueError("image is not a stamped synthetic frame")
    return int(px[0]), int(px[1]) | ((int(px[2]) & 0x0F) << 8)


class DetectionEngine:
    """Engine-contract fake: resolves stamped frames straight to the
    video's seeded :meth:`SyntheticVideo.detections` — the deterministic
    quality half of the fast-path A/B (``cli.stream_bench
    --fastpath``) and the session/fast-path protocol tests, running in
    microseconds without a model or device.

    Implements the duck-typed engine surface ``StreamSession`` uses
    (``submit(image) -> Future``, ``draining``); with ``emit_signals``
    the future resolves to ``(detections, EscalationSignals)`` like a
    fused-decode ``DynamicBatcher`` — the signals derived from the
    detections themselves (``stream.fastpath.signals_from_people``).
    A CROPPED stamped frame is answered like a real model would answer
    a crop: only joints inside the window, in crop-relative coordinates
    (people entirely outside are invisible — the person-count signal
    honestly reflects what the crop can see).  Futures resolve inline
    on the submitting thread; ``calls`` counts real forwards (what the
    fast path is supposed to be saving).
    """

    def __init__(self, video: SyntheticVideo, *, noise: float = 0.0,
                 drop_joint_p: float = 0.0, emit_signals: bool = True):
        self.video = video
        self.noise = float(noise)
        self.drop_joint_p = float(drop_joint_p)
        self.emit_signals = bool(emit_signals)
        self.draining = False
        self.calls = 0

    def submit(self, image_bgr: np.ndarray, *, deadline_s=None):
        from concurrent.futures import Future

        t, x0 = read_stamp(image_bgr)
        t %= max(self.video.num_frames, 1)
        dets = self.video.detections(t, noise=self.noise,
                                     drop_joint_p=self.drop_joint_p)
        w = image_bgr.shape[1]
        if x0 or w < self.video.w:      # the crop's limited view
            windowed = []
            for kps, score in dets:
                shifted: Keypoints = []
                for c in kps:
                    if c is None or not x0 <= c[0] < x0 + w:
                        shifted.append(None)
                    else:
                        shifted.append((c[0] - x0, c[1]))
                if any(c is not None for c in shifted):
                    windowed.append((shifted, score))
            dets = windowed
        self.calls += 1
        fut: Future = Future()
        if self.emit_signals:
            from .fastpath import signals_from_people

            fut.set_result((dets, signals_from_people(dets)))
        else:
            fut.set_result(dets)
        return fut
