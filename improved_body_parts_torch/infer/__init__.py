"""Inference: the fused device-decode lane and its host finish."""
from .decode import (
    CompactOverflow,
    CompactResult,
    DeviceDecoded,
    decode_device,
    device_subset_candidate,
    subsets_to_keypoints,
)
from .predict import (
    COMPACT_M_FACTOR,
    Predictor,
    pad_right_down,
    trivial_grid,
)
from .resize import cubic_weights, upsample_cubic

__all__ = [
    "COMPACT_M_FACTOR",
    "CompactOverflow",
    "CompactResult",
    "DeviceDecoded",
    "Predictor",
    "cubic_weights",
    "decode_device",
    "device_subset_candidate",
    "pad_right_down",
    "subsets_to_keypoints",
    "trivial_grid",
    "upsample_cubic",
]
