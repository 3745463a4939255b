"""Inference: the device lanes of the predictor, their host decode, the
pipelined and serving plumbing shared with ``serve``, and evaluation
(COCOeval or the OKS evaluator)."""
from .decode import (
    CompactOverflow,
    CompactResult,
    DeviceDecoded,
    EscalationSignals,
    assemble,
    decode,
    decode_compact,
    decode_device,
    device_signals,
    device_subset_candidate,
    find_connections,
    find_peaks,
    find_people,
    subsets_to_keypoints,
)
from .evaluate import process_image, validation, validation_oks
from .oks import evaluate_oks
from .pipeline import compact_decode_fn, device_decode_fn, pipelined_inference
from .predict import (
    COMPACT_M_FACTOR,
    Predictor,
    center_pad,
    pad_right_down,
    trivial_grid,
)
from .resize import cubic_weights, resize_cubic, upsample_cubic

__all__ = [
    "COMPACT_M_FACTOR",
    "CompactOverflow",
    "CompactResult",
    "DeviceDecoded",
    "EscalationSignals",
    "Predictor",
    "assemble",
    "center_pad",
    "compact_decode_fn",
    "cubic_weights",
    "decode",
    "decode_compact",
    "decode_device",
    "device_decode_fn",
    "device_signals",
    "device_subset_candidate",
    "evaluate_oks",
    "find_connections",
    "find_peaks",
    "find_people",
    "pad_right_down",
    "pipelined_inference",
    "process_image",
    "resize_cubic",
    "subsets_to_keypoints",
    "trivial_grid",
    "upsample_cubic",
    "validation",
    "validation_oks",
]
