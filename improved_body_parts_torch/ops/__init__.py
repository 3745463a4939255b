"""Ops of the port: peak extraction, limb scoring, assembly, and the
training loss.

The hand-written kernels live in ``csrc/*.cu`` and are bound by
``ops.cuda_peaks`` / ``ops.cuda_assembly`` / ``ops.cuda_focal`` (built at
first use by ``ops._build``)."""
from .assembly import AssemblyResult, greedy_assemble
from .losses import focal_l2, l1, l2, multi_task_loss
from .peaks import (
    LimbCandidates,
    PairStats,
    TopKPeaks,
    limb_pair_stats,
    limb_topk_candidates,
    limb_topk_from_stats,
    topk_peaks,
)

__all__ = [
    "AssemblyResult",
    "LimbCandidates",
    "PairStats",
    "TopKPeaks",
    "focal_l2",
    "greedy_assemble",
    "l1",
    "l2",
    "limb_pair_stats",
    "limb_topk_candidates",
    "limb_topk_from_stats",
    "multi_task_loss",
    "topk_peaks",
]
