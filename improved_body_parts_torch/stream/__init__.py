"""Streaming video pose tracking: stateful per-stream sessions on top of
the serving engine (the port's own copy of
``improved_body_parts_tpu/stream``, NumPy over the port's engines).

Every workload below this package is an independent single image; real
pose traffic is video.  This package adds the stateful layer: per-stream ordered sessions over ``serve.DynamicBatcher``
(``session``), temporal track identity via frame-to-frame OKS matching
(``track``), optional confidence-gated temporal smoothing (``smooth``),
a deterministic synthetic video generator (``synth``) that makes
tracker correctness a gateable number instead of an eyeballed demo, and
the temporal-coherence fast path (``fastpath``): tracker-predicted
frame skipping + ROI re-inference under exact three-tier conservation.
"""
from .fastpath import (
    FastPath,
    FastPathConfig,
    FastPathMetrics,
    TierDecision,
    paste_back,
    signals_from_people,
)
from .session import FrameDropped, SessionManager, StreamMetrics, StreamSession
from .smooth import KeypointSmoother, jitter_rms, keypoint_sequence_jitter
from .synth import DetectionEngine, SyntheticVideo, read_stamp
from .track import (
    IdentitySwitchCounter,
    Track,
    TrackedPerson,
    Tracker,
    keypoint_similarity,
)

__all__ = [
    "DetectionEngine",
    "FastPath",
    "FastPathConfig",
    "FastPathMetrics",
    "FrameDropped",
    "IdentitySwitchCounter",
    "KeypointSmoother",
    "SessionManager",
    "StreamMetrics",
    "StreamSession",
    "SyntheticVideo",
    "TierDecision",
    "Track",
    "TrackedPerson",
    "Tracker",
    "jitter_rms",
    "keypoint_sequence_jitter",
    "keypoint_similarity",
    "paste_back",
    "read_stamp",
    "signals_from_people",
]
