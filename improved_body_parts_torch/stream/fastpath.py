"""Temporal-coherence fast path: the near-zero-cost serving tier below
the student — tracker-predicted frames, ROI re-inference, full forwards
(the port's own copy of ``improved_body_parts_tpu/stream/fastpath.py``).

Consecutive video frames are ~identical, yet a plain stream session
pays one full network forward per frame.  This module adds the two
cheaper answers and the policy that picks between them, per frame, in
submit order:

- **tracker tier**: the frame never touches the engine.  The tracker's
  constant-velocity state (``Tracker.predict_frame``) extrapolates
  every confirmed track one frame; the One-Euro smoother then treats
  the prediction like any other sample (its alpha already scales by the
  real frame gap).  Cost: microseconds of host NumPy.
- **roi tier**: a real forward over a CROP.  Because the predictor's
  scale protocol renormalizes input HEIGHT to ``boxsize``
  (``Predictor.compact_lane_shape_for``: ``scale = s0·boxsize/oh``), a
  vertically-cropped canvas is rescaled right back up — vertical
  cropping buys nothing and distorts person scale.  Width is where the
  compute lives: the ROI tier keeps full frame height and crops WIDTH
  to the union track box (+margin), anchored so the fixed ``roi_width``
  window always lies inside the frame.  That lands in exactly ONE extra
  lane bucket ``(H, roi_width)`` — narrower, cheaper, at identical
  person scale — which ``DynamicBatcher.warmup`` precompiles like any
  other bucket (the 0-post-warmup-recompile gate).  Decoded coordinates
  are pasted back into full-frame space by adding the crop offset.
- **full tier**: the ordinary full-frame forward — owed on cold start,
  whenever the fused-decode escalation signals say the scene changed,
  and periodically (``full_refresh_every``) so people entering OUTSIDE
  the ROI window are ever discovered.

The decision consumes the cascade's free fused-decode signals
(``infer.decode.EscalationSignals``, already in the fetch payload when
the engine runs ``emit_signals=True``): person-count DELTAS against the
last real frame, the assembly-score floor, and the capacity-overflow
flags.  Engines that do not emit signals still work — the session
derives a host-side approximation from the decoded people
(:func:`signals_from_people`).

Accounting extends ``serve.cascade.CascadeMetrics``' exact conservation
pattern to three tiers::

    submitted == answered_tracker + answered_roi + escalated_full
                 + failed + dropped + depth

with per-reason escalation counts — every REAL forward is an
"escalation" out of the tracker tier, tagged with why it was owed
(``cold`` / ``interval`` / ``refresh`` / ``people`` / ``score`` /
``overflow`` / ``roi_unfit`` / ``error``).  Per-tier latency
reservoirs feed the per-hop latency block, one entry per tier.

Pipelining caveat (by design): decisions are made at SUBMIT time from
the most recent DELIVERED real frame's signals, so with ``max_in_flight``
frames in the pipe a scene change shows up one round-trip late — the
same staleness any closed-loop controller has, bounded by
``max_skip_run`` (a real forward is owed at least every
``max_skip_run + 1`` frames).

All host-side NumPy on the session's existing locks: no new threads, no
new lane shapes beyond the one warmed ROI bucket.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils.meters import PercentileMeter
from .track import Keypoints, Tracker

#: the three tiers, cheap to expensive — and the conservation buckets
TIERS = ("tracker", "roi", "full")

#: escalation reasons a real forward can be owed for, in the order the
#: policy checks them (signal-forced reasons first, then the owed-
#: anyway reasons) — the keys of ``FastPathMetrics.escalations``
FASTPATH_REASONS = ("overflow", "people", "score", "error", "cold",
                    "refresh", "roi_unfit", "interval")


class _Signals(NamedTuple):
    """Shape-compatible stand-in for ``infer.decode.EscalationSignals``
    built host-side (:func:`signals_from_people`) when the engine does
    not emit the fused-decode payload."""
    n_people: int
    peak_overflow: bool
    cand_overflow: bool
    person_overflow: bool
    min_mean_score: float
    fused: bool


def signals_from_people(people: Sequence[Tuple[Keypoints, float]]):
    """Host-side escalation signals derived from decoded people — the
    fallback when the engine's futures carry bare skeletons (no
    ``emit_signals``).  The person count and weakest score are real;
    the overflow flags are unknowable here and read False, and
    ``fused=False`` says so."""
    scores = [float(s) for _, s in people]
    return _Signals(n_people=len(people), peak_overflow=False,
                    cand_overflow=False, person_overflow=False,
                    min_mean_score=min(scores) if scores else float("inf"),
                    fused=False)


def split_result(result):
    """``(skeletons, signals_or_None)`` from an engine future's payload.

    A fused-decode engine built with ``emit_signals=True`` resolves to
    ``(skeletons, EscalationSignals)``; everything else resolves to the
    bare skeleton list.  Duck-typed on the signals' field names so the
    session needn't import the decode module."""
    if (isinstance(result, tuple) and len(result) == 2
            and hasattr(result[1], "n_people")
            and hasattr(result[1], "min_mean_score")):
        return result[0], result[1]
    return result, None


def paste_back(people: Sequence[Tuple[Keypoints, float]],
               offset: Tuple[float, float]
               ) -> List[Tuple[Keypoints, float]]:
    """Decoded people from an ROI crop, translated back into full-frame
    coordinates (``offset`` is the crop's top-left corner)."""
    ox, oy = offset
    if not ox and not oy:
        return list(people)
    out: List[Tuple[Keypoints, float]] = []
    for kps, score in people:
        out.append(([None if c is None
                     else (float(c[0]) + ox, float(c[1]) + oy)
                     for c in kps], score))
    return out


@dataclass(frozen=True)
class FastPathConfig:
    """Knobs of the skip/ROI/full decision (``SessionManager(fastpath=
    FastPathConfig(...))`` turns the fast path on).

    The signal thresholds mirror ``serve.cascade.EscalationPolicy`` but
    operate on DELTAS where the cascade uses absolutes: a stream has a
    previous frame to compare against, and "the crowd changed" is the
    re-inference trigger, not "the crowd is large".
    """
    #: consecutive tracker-tier answers before a real forward is owed
    #: (the skip run); sustained-streams multiplier ~= max_skip_run + 1
    #: on scenes calm enough to skip
    max_skip_run: int = 3
    #: consecutive CALM real deliveries required before skipping starts
    #: (cold start, and re-proving the scene after any escalation)
    min_stable: int = 2
    #: fixed ROI crop width in px (the ONE extra warmup bucket,
    #: ``(frame_h, roi_width)``); 0 disables the ROI tier.  Must be
    #: strictly narrower than the frame to be worth a bucket.
    roi_width: int = 0
    #: padding added around the union track box before the fit check
    roi_margin: int = 32
    #: every Nth REAL forward is full-frame even when the box fits the
    #: ROI window (people entering outside the window are invisible to
    #: it); 0 disables the periodic refresh
    full_refresh_every: int = 4
    #: tolerated |person count − last real frame's count| before a full
    #: forward is owed (0 = any change escalates)
    people_delta: int = 0
    #: escalate when the weakest kept person's mean assembly score
    #: drops UNDER this floor (0 disables — same boundary semantics as
    #: the cascade policy: equality stays on the cheap tier)
    score_floor: float = 0.0
    #: any capacity-overflow flag owes a full forward (the device
    #: assembly was not authoritative)
    escalate_on_overflow: bool = True

    def __post_init__(self):
        if self.max_skip_run < 1:
            raise ValueError(f"max_skip_run={self.max_skip_run} must "
                             "be >= 1")
        if self.min_stable < 1:
            raise ValueError(f"min_stable={self.min_stable} must be >= 1")
        if self.roi_width < 0:
            raise ValueError(f"roi_width={self.roi_width} must be >= 0")
        if self.roi_margin < 0:
            raise ValueError(f"roi_margin={self.roi_margin} must be >= 0")
        if self.full_refresh_every < 0:
            raise ValueError(f"full_refresh_every="
                             f"{self.full_refresh_every} must be >= 0")
        if self.people_delta < 0:
            raise ValueError(f"people_delta={self.people_delta} must "
                             "be >= 0")
        if self.score_floor < 0:
            raise ValueError(f"score_floor={self.score_floor} must "
                             "be >= 0")


class TierDecision(NamedTuple):
    """One frame's routing: which tier answers, why a real forward was
    owed (``None`` on the tracker tier), and — ROI tier only — the
    crop's left edge in full-frame px."""
    tier: str
    reason: Optional[str]
    roi_x0: Optional[int]


class FastPathMetrics:
    """Three-tier conservation accounting for ONE stream's fast path —
    ``serve.cascade.CascadeMetrics``' exact-conservation pattern with a
    per-tier latency reservoir riding along (the per-hop block,
    one entry per tier).

    Invariant (the chaos harness's hammer): ``submitted ==
    answered_tracker + answered_roi + escalated_full + failed
    + dropped + depth``.
    """

    def __init__(self, latency_reservoir: int = 2048):
        self._lock = threading.Lock()
        self.submitted = 0
        self.answered_tracker = 0
        self.answered_roi = 0
        self.escalated_full = 0
        self.failed = 0
        self.dropped = 0
        self.depth = 0
        self.escalations: Dict[str, int] = {r: 0 for r in FASTPATH_REASONS}
        self.tier_latency: Dict[str, PercentileMeter] = {
            t: PercentileMeter(latency_reservoir) for t in TIERS}

    def on_submit(self, tier: str, reason: Optional[str]) -> None:
        with self._lock:
            self.submitted += 1
            self.depth += 1
            if reason is not None:
                self.escalations[reason] = (
                    self.escalations.get(reason, 0) + 1)

    def on_answer(self, tier: str, latency_s: float) -> None:
        with self._lock:
            if tier == "tracker":
                self.answered_tracker += 1
            elif tier == "roi":
                self.answered_roi += 1
            else:
                self.escalated_full += 1
            self.depth -= 1
            self.tier_latency[tier].update(latency_s)

    def on_fail(self, tier: str) -> None:
        with self._lock:
            self.failed += 1
            self.depth -= 1

    def on_drop(self, tier: str) -> None:
        with self._lock:
            self.dropped += 1
            self.depth -= 1

    def conservation(self) -> dict:
        """The per-tier conservation block (bench artifacts, chaos
        checks): every counter plus ``exact`` — True iff the invariant
        holds at this instant."""
        with self._lock:
            out = {
                "submitted": self.submitted,
                "answered_tracker": self.answered_tracker,
                "answered_roi": self.answered_roi,
                "escalated_full": self.escalated_full,
                "failed": self.failed,
                "dropped": self.dropped,
                "depth": self.depth,
            }
        out["exact"] = (out["submitted"]
                        == out["answered_tracker"] + out["answered_roi"]
                        + out["escalated_full"] + out["failed"]
                        + out["dropped"] + out["depth"])
        return out

    def sample(self):
        """One consistent (counts, escalations, per-tier latency
        summaries + sums) read for the registry collector."""
        with self._lock:
            counts = (("fastpath_submitted", self.submitted),
                      ("fastpath_answered_tracker", self.answered_tracker),
                      ("fastpath_answered_roi", self.answered_roi),
                      ("fastpath_escalated_full", self.escalated_full),
                      ("fastpath_failed", self.failed),
                      ("fastpath_dropped", self.dropped))
            escalations = dict(self.escalations)
            lat = {t: (m.summary(), m.sum)
                   for t, m in self.tier_latency.items()}
            depth = self.depth
        return counts, escalations, lat, depth

    def snapshot(self) -> dict:
        out = self.conservation()
        with self._lock:
            out["escalations"] = dict(self.escalations)
            out["tier_latency_ms"] = {
                t: m.summary(scale=1e3)
                for t, m in self.tier_latency.items()}
        return out


class FastPath:
    """Per-stream decision state + accounting; owned by one
    ``StreamSession`` and driven from its existing synchronization
    (``decide`` under the session's submit ordering, ``on_delivered`` /
    ``on_failed`` under its deliver lock) — an internal lock makes each
    call atomic without new lock-ordering edges."""

    def __init__(self, config: FastPathConfig,
                 metrics: Optional[FastPathMetrics] = None):
        self.config = config
        self.metrics = metrics or FastPathMetrics()
        self._lock = threading.Lock()
        # submit-side state
        self._skip_run = 0          # consecutive tracker answers so far
        self._real_since_full = 0   # ROI forwards since the last full
        # delivery-side state (from the last delivered REAL frame)
        self._stable = 0            # consecutive calm real deliveries
        self._pending_reason: Optional[str] = None  # full forward owed
        self._last_people: Optional[int] = None
        self._box: Optional[Tuple[float, float, float, float]] = None
        self._confirmed = 0

    # ------------------------------------------------------------ submit
    def decide(self, frame_h: int, frame_w: int) -> TierDecision:
        """Route ONE frame, in submit order."""
        cfg = self.config
        with self._lock:
            if self._pending_reason is not None:
                # a signal (or an engine error) owes a full forward
                # until the scene re-proves calm
                return self._real_locked("full", self._pending_reason,
                                         None)
            if self._stable < cfg.min_stable or self._confirmed == 0:
                return self._real_locked("full", "cold", None)
            if self._skip_run < cfg.max_skip_run:
                self._skip_run += 1
                return TierDecision("tracker", None, None)
            # a real forward is owed — ROI when the box fits, with a
            # periodic full-frame refresh so the window never goes blind
            tier, reason, x0 = self._roi_or_full_locked(frame_w)
            return self._real_locked(tier, reason, x0)

    def _real_locked(self, tier: str, reason: str,
                     roi_x0: Optional[int]) -> TierDecision:
        self._skip_run = 0
        if tier == "full":
            self._real_since_full = 0
        else:
            self._real_since_full += 1
        return TierDecision(tier, reason, roi_x0)

    def _roi_or_full_locked(self, frame_w: int
                            ) -> Tuple[str, str, Optional[int]]:
        cfg = self.config
        if cfg.roi_width <= 0:
            return "full", "interval", None
        if (cfg.full_refresh_every > 0
                and self._real_since_full + 1 >= cfg.full_refresh_every):
            return "full", "refresh", None
        if cfg.roi_width >= frame_w or self._box is None:
            return "full", "roi_unfit", None
        x0 = int(np.floor(self._box[0])) - cfg.roi_margin
        x1 = int(np.ceil(self._box[2])) + cfg.roi_margin + 1
        if min(x1, frame_w) - max(x0, 0) > cfg.roi_width:
            return "full", "roi_unfit", None
        # anchor the fixed-width window inside the frame: the crop is
        # always fully backed by image content (one bucket, no padding)
        x0 = min(max(x0, 0), frame_w - cfg.roi_width)
        return "roi", "interval", x0

    # ---------------------------------------------------------- delivery
    def on_delivered(self, tier: str, signals, tracker: Tracker) -> None:
        """Fold one DELIVERED frame's outcome into the policy state.
        ``signals`` is the fused-decode payload (or the host-side
        derivation) for real tiers, ignored for the tracker tier."""
        cfg = self.config
        with self._lock:
            if tier != "tracker":
                reason = None
                if cfg.escalate_on_overflow and (signals.peak_overflow
                                                 or signals.cand_overflow
                                                 or signals.person_overflow):
                    reason = "overflow"
                elif (self._last_people is not None
                      and abs(signals.n_people - self._last_people)
                      > cfg.people_delta):
                    reason = "people"
                elif (cfg.score_floor > 0
                      and signals.min_mean_score < cfg.score_floor):
                    reason = "score"
                self._last_people = int(signals.n_people)
                if reason is None:
                    self._stable += 1
                    if tier == "full":
                        self._pending_reason = None
                else:
                    self._stable = 0
                    self._pending_reason = reason
            self._box = tracker.union_box()
            self._confirmed = tracker.confirmed

    def on_failed(self, tier: str) -> None:
        """An engine error reached delivery: re-prove the scene with
        full forwards before skipping again."""
        with self._lock:
            self._stable = 0
            if self._pending_reason is None:
                self._pending_reason = "error"

    def snapshot(self) -> dict:
        with self._lock:
            policy = {
                "skip_run": self._skip_run,
                "stable": self._stable,
                "pending_reason": self._pending_reason,
                "confirmed": self._confirmed,
            }
        out = self.metrics.snapshot()
        out["policy"] = policy
        return out
