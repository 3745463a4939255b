"""Decode ops of the port: peak extraction, limb scoring, assembly.

The hand-written kernels live in ``csrc/*.cu`` and are bound by
``ops.cuda_peaks`` / ``ops.cuda_assembly`` (built at first use by
``ops._build``)."""
from .assembly import AssemblyResult, candidate_walk, greedy_assemble
from .peaks import (
    LimbCandidates,
    PairStats,
    TopKPeaks,
    limb_pair_stats,
    limb_topk_from_stats,
    topk_peaks,
)

__all__ = [
    "AssemblyResult",
    "LimbCandidates",
    "PairStats",
    "TopKPeaks",
    "candidate_walk",
    "greedy_assemble",
    "limb_pair_stats",
    "limb_topk_from_stats",
    "topk_peaks",
]
