"""Inference / post-processing parameters (the port's own copy of
``improved_body_parts_tpu/config/inference.py``, kept field-for-field
equal).

Replaces the reference's ConfigObj INI file with its hard-coded absolute path
(reference: utils/config, utils/config_reader.py:6-37) with a plain dataclass.
Field semantics and defaults match utils/config:14-41.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class InferenceParams:
    """Decode-time knobs (reference: utils/config [param] section)."""
    scale_search: Tuple[float, ...] = (1.0,)
    rotation_search: Tuple[float, ...] = (0.0,)
    thre1: float = 0.1           # keypoint peak threshold
    thre2: float = 0.1           # limb response threshold
    connect_ration: float = 0.8  # fraction of sampled points that must clear thre2
    mid_num: int = 20            # points sampled along a candidate limb
    min_num: int = 4
    len_rate: float = 16.0       # max allowed limb-length growth ratio
    connection_tole: float = 0.7  # tolerance when merging disjoint persons
    offset_radius: int = 2       # sub-pixel refinement window radius
    remove_recon: int = 0        # remove re-connected parts (0/1)
    # assembly pruning (reference: evaluate.py:491-496)
    min_parts: int = 2
    min_mean_score: float = 0.45
    # kept for field-for-field equality with the JAX package, where it
    # selects the Pallas decode kernels; the port has one engine: its
    # CUDA kernels on a CUDA tensor, their plain versions on a CPU one
    use_pallas_decode: bool = False


@dataclass(frozen=True)
class InferenceModelParams:
    """Input-geometry knobs (reference: utils/config [models] section)."""
    boxsize: int = 640
    stride: int = 4
    max_downsample: int = 64     # pad input to a multiple of this
    pad_value: int = 128
    # clamp for very large inputs (reference: evaluate.py:94-96)
    max_height: int = 2600
    max_width: int = 3800


def default_inference_params() -> Tuple[InferenceParams, InferenceModelParams]:
    """Replaces ``config_reader()`` (reference: utils/config_reader.py:6-37)."""
    return InferenceParams(), InferenceModelParams()
