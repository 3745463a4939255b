"""Greedy skeleton assembly on the device -- the last decode stage.

Counterpart of ``improved_body_parts_tpu/ops/assembly.py``
``greedy_assemble``, batched over a leading image axis.  On a CUDA tensor
it launches ``csrc/assembly.cu`` (``ops.cuda_assembly
.greedy_assemble_kernel``): the walk over each limb's rank-ordered
candidates, the person-table rules (spawn, one, merge; compete only when
``remove_recon > 0``) and the prune, one block per image, with nothing
read back to the host.  On a CPU tensor it runs the kernel's plain
version (``greedy_assemble_plain``: the walk, then the rules as
branch-free rounds over the image axis).

The arithmetic is fp32 in the JAX package's order, with the same
``AssemblyResult`` fields and overflow flags.  Peaks are identified by
the flat slot id ``channel * K + slot``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import use_kernel
from .cuda_assembly import greedy_assemble_kernel, greedy_assemble_plain
from .peaks import LimbCandidates, TopKPeaks


class AssemblyResult(NamedTuple):
    """Fixed-capacity assembled-person tables, one per image.

    ``subset`` is (N, P_max, num_parts+2, 2) float32 in ``find_people``'s
    row layout: per part [flat peak id ``c*K+slot`` or -1, confidence];
    row -2 = [total score, -1]; row -1 = [part count, longest limb].
    Only rows with ``mask`` are people."""
    subset: torch.Tensor           # (N, P, num_parts + 2, 2) float32
    mask: torch.Tensor             # (N, P) bool -- pruned-in people
    n_people: torch.Tensor         # (N,) int32
    peak_overflow: torch.Tensor    # (N,) bool -- a channel's count > K
    cand_overflow: torch.Tensor    # (N,) bool -- a limb's count > M
    person_overflow: torch.Tensor  # (N,) bool -- table hit p_max


def greedy_assemble(peaks: TopKPeaks, cands: LimbCandidates, *,
                    limbs_from: Sequence[int], limbs_to: Sequence[int],
                    num_parts: int, p_max: int, len_rate: float,
                    connection_tole: float, remove_recon: int,
                    min_parts: int, min_mean_score: float) -> AssemblyResult:
    """Greedy person assembly over (N, C, K) peaks and (N, L, M) rank-
    ordered candidates (see the module docstring); ``p_max`` is the
    person-table capacity."""
    fn = (greedy_assemble_kernel if use_kernel(peaks.score)
          else greedy_assemble_plain)
    return AssemblyResult(*fn(
        peaks, cands, limbs_from=limbs_from, limbs_to=limbs_to,
        num_parts=num_parts, p_max=p_max, len_rate=len_rate,
        connection_tole=connection_tole, remove_recon=remove_recon,
        min_parts=min_parts, min_mean_score=min_mean_score))
