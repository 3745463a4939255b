"""On-device peak extraction + limb pair scoring (the compact decode path).

Counterpart of ``improved_body_parts_tpu/ops/peaks.py``, batched over a
leading image axis (the JAX package vmaps its per-image functions):

- :func:`topk_peaks`: 3x3 max-pool NMS + per-channel top-K selection +
  weighted-centroid sub-pixel refinement;
- :func:`limb_pair_stats`: the dense (L, K, K, S) limb sampling of every
  candidate A->B segment;
- :func:`limb_topk_from_stats`: acceptance + top-M rank selection of the
  accepted pairs (plain PyTorch here, as it is XLA code there);
- :func:`limb_topk_candidates`: the two in a row, from the maps to the
  ranked candidates.

The first two run their hand-written kernels (``ops.cuda_peaks``) on a
CUDA tensor and the kernels' plain PyTorch versions on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import device_tensor, use_kernel
from . import cuda_peaks


class TopKPeaks(NamedTuple):
    """Per-channel top-K NMS peaks: (N, C, K) arrays, ``count`` (N, C).

    Slots beyond a channel's real peak count carry ``valid=False``;
    ``count`` is the TRUE number of NMS peaks, so ``count > K`` signals
    overflow.  The unpacked host payload holds numpy arrays without the
    image axis, as the JAX package's does."""
    xs: torch.Tensor        # int32 raw column of each peak
    ys: torch.Tensor        # int32 raw row
    x_ref: torch.Tensor     # float32 sub-pixel-refined column
    y_ref: torch.Tensor     # float32 sub-pixel-refined row
    score: torch.Tensor     # float32 refined (window-mean) or raw score
    valid: torch.Tensor     # bool
    count: torch.Tensor     # int32 (N, C)


class PairStats(NamedTuple):
    """Dense limb-pair statistics, (N, L, K, K) over candidate A x B peaks
    (entries of invalid peak slots are garbage)."""
    mean_score: torch.Tensor  # float32
    above: torch.Tensor       # int32 -- samples with response > thre2
    num_samples: torch.Tensor  # int32 -- m = min(round(norm+1), S)
    norm: torch.Tensor        # float32


class LimbCandidates(NamedTuple):
    """Top-M accepted limb candidates per limb, rank-ordered: (N, L, M)
    arrays, ``count`` (N, L) -- the TRUE accepted-pair count, so
    ``count > M`` signals overflow."""
    slot_a: torch.Tensor   # int32 -- index into part A's top-K slots
    slot_b: torch.Tensor   # int32
    prior: torch.Tensor    # float32 -- connection score
    norm: torch.Tensor     # float32 -- limb length
    valid: torch.Tensor    # bool
    count: torch.Tensor    # int32 (N, L)


def topk_peaks(heat: torch.Tensor, valid_h: torch.Tensor,
               valid_w: torch.Tensor, *, thre: float, k: int,
               radius: int) -> TopKPeaks:
    """NMS + top-K + sub-pixel refinement on (N, H, W, C) keypoint maps.

    Responses outside each image's valid (valid_h, valid_w) region are
    masked out before NMS and the refinement's border check uses the
    valid extent, so padded-region activations can neither create nor
    suppress peaks.  Top-K order is (value desc, flat index asc).
    """
    fn = (cuda_peaks.topk_peaks_kernel if use_kernel(heat)
          else cuda_peaks.topk_peaks_plain)
    return TopKPeaks(*fn(heat, valid_h, valid_w, thre=thre, k=k,
                         radius=radius))


def limb_pair_stats(paf: torch.Tensor, x_ref: torch.Tensor,
                    y_ref: torch.Tensor, *, limbs_from: Sequence[int],
                    limbs_to: Sequence[int], num_samples: int,
                    thre2: float) -> PairStats:
    """Sample every limb channel along every candidate A->B segment: pair
    (a, b) at m = min(round(norm+1), S) evenly spaced points,
    nearest-pixel (half-even rounding).

    :param paf: (N, H, W, L) full-resolution limb maps
    :param x_ref, y_ref: (N, C, K) refined peak coordinates
    """
    fn = (cuda_peaks.limb_pair_stats_kernel if use_kernel(paf)
          else cuda_peaks.limb_pair_stats_plain)
    return PairStats(*fn(paf, x_ref, y_ref, limbs_from=limbs_from,
                         limbs_to=limbs_to, num_samples=num_samples,
                         thre2=thre2))


def limb_topk_from_stats(st: PairStats, peaks: TopKPeaks,
                         image_size: torch.Tensor, *,
                         limbs_from: Sequence[int], limbs_to: Sequence[int],
                         connect_ration: float, m_cap: int
                         ) -> LimbCandidates:
    """Acceptance (>= connect_ration of the samples above thre2, positive
    length-penalised prior) + top-M rank selection by 0.5 prior + 0.25
    (endpoint scores), over the dense pair statistics.

    :param image_size: (N,) valid decoded-map height per image (the
        length-prior scale)
    """
    dev = st.norm.device
    la = device_tensor(tuple(map(int, limbs_from)), dev)
    lb = device_tensor(tuple(map(int, limbs_to)), dev)
    n, n_limbs, k, _ = st.norm.shape
    size_f = image_size.to(device=dev, dtype=st.norm.dtype).view(n, 1, 1, 1)
    prior = st.mean_score + torch.clamp(
        0.5 * size_f / torch.clamp(st.norm, min=1e-12) - 1.0, max=0.0)
    ok = ((st.above >= connect_ration * st.num_samples)
          & (prior > 0) & (st.norm > 0)
          & peaks.valid[:, la][..., :, None] & peaks.valid[:, lb][..., None, :])
    rank = (0.5 * prior + 0.25 * peaks.score[:, la][..., :, None]
            + 0.25 * peaks.score[:, lb][..., None, :])

    key = torch.where(ok, rank, torch.full_like(rank, -torch.inf))
    m_eff = min(m_cap, k * k)
    vals, idx = cuda_peaks.select_desc(key.reshape(n, n_limbs, k * k),
                                        m_eff)
    slot_a = torch.div(idx, k, rounding_mode="floor").to(torch.int32)
    slot_b = (idx % k).to(torch.int32)
    valid = torch.isfinite(vals)
    sel_prior = torch.gather(prior.reshape(n, n_limbs, -1), 2, idx)
    sel_norm = torch.gather(st.norm.reshape(n, n_limbs, -1), 2, idx)
    if m_eff < m_cap:  # keep the (N, L, m_cap) contract for tiny K
        pad = (0, m_cap - m_eff)
        slot_a, slot_b, sel_prior, sel_norm, valid = (
            torch.nn.functional.pad(t, pad)
            for t in (slot_a, slot_b, sel_prior, sel_norm, valid))
    count = ok.sum(dim=(2, 3), dtype=torch.int32)
    return LimbCandidates(slot_a, slot_b, sel_prior, sel_norm, valid, count)


def limb_topk_candidates(paf: torch.Tensor, peaks: TopKPeaks,
                         image_size: torch.Tensor, *,
                         limbs_from: Sequence[int], limbs_to: Sequence[int],
                         num_samples: int, thre2: float,
                         connect_ration: float, m_cap: int
                         ) -> LimbCandidates:
    """Dense pair sampling (:func:`limb_pair_stats`, its kernel on a CUDA
    tensor) followed by acceptance and top-M rank selection
    (:func:`limb_topk_from_stats`): the best ``m_cap`` accepted pairs of
    each limb, in descending rank order.

    :param paf: (N, H, W, L) full-resolution limb maps
    :param image_size: (N,) valid decoded-map height per image
    """
    st = limb_pair_stats(paf, peaks.x_ref, peaks.y_ref,
                         limbs_from=limbs_from, limbs_to=limbs_to,
                         num_samples=num_samples, thre2=thre2)
    return limb_topk_from_stats(st, peaks, image_size,
                                limbs_from=limbs_from, limbs_to=limbs_to,
                                connect_ration=connect_ration, m_cap=m_cap)
