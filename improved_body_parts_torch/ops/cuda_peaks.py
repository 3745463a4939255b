"""Wrappers of the peak and limb-sampling kernels, with their plain versions.

``topk_peaks_kernel`` launches ``csrc/peaks.cu`` (the counterpart of
``improved_body_parts_tpu/ops/pallas_peaks.py`` ``topk_peaks_pallas``) and
``limb_pair_stats_kernel`` launches ``csrc/limbs.cu`` (the counterpart of
``limb_pair_stats_pallas``).  Each takes CUDA tensors only and raises on
anything else; ``ops.peaks`` routes a CPU tensor to the ``*_plain``
version beside it, which computes the same function with PyTorch ops on
any device (``chip_smoke.py`` holds each kernel against it on the card).

Layouts are the JAX package's with a leading image axis: maps NHWC
(``(N, H, W, C)``, any strides: a channel slice of the ensembled maps is
passed without a copy), peak records ``(N, C, K)``, pair statistics
``(N, L, K, K)``.  Each kernel wrapper counts its launches in a plain int
attribute (``topk_peaks_kernel.launches``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import device_tensor
from . import _build

NEG = -1e9  # the masked value of topk_peaks (the JAX package's _NEG)
MAX_K = 512  # MAX_K in csrc/peaks.cu
MAX_PEAK_CHANNELS = 64  # 2 * MAX_PAIRS in csrc/peaks.cu
INT32_MAX = 2 ** 31 - 1  # the kernels address the maps with 32-bit offsets

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_TOPK_ARGS = (_P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _P, _P, _F, _I, _I,
              _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)
_LIMBS_ARGS = (_P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _P, _P, _I, _I, _P,
               _I, _F, _P, _P, _P, _P, _P)


def _check_offsets(name: str, t: torch.Tensor) -> None:
    """Raise when the largest element offset of ``t`` does not fit a
    signed 32-bit int, the kernels' address arithmetic."""
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    if t.numel() and last > INT32_MAX:
        raise ValueError(f"{name}: a {tuple(t.shape)} view with strides "
                         f"{t.stride()} reaches element offset {last}, past "
                         "the kernel's 32-bit offsets")


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"one on {t.device}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def select_desc(values: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` entries of the last axis by (value desc, index asc)
    -- ``lax.top_k``'s order; ``torch.topk`` breaks ties differently."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# --------------------------------------------------------------------- #
# topk_peaks                                                            #
# --------------------------------------------------------------------- #


def topk_peaks_plain(heat: torch.Tensor, valid_h: torch.Tensor,
                     valid_w: torch.Tensor, *, thre: float, k: int,
                     radius: int) -> Tuple[torch.Tensor, ...]:
    """NMS + top-K + weighted-centroid refinement, plain PyTorch.

    :param heat: (N, H, W, C) float32 keypoint maps
    :param valid_h, valid_w: (N,) int valid (un-padded) extent per image
    :returns: (xs, ys, x_ref, y_ref, score, valid, count) -- (N, C, K)
        each, ``count`` (N, C); the ``ops.peaks.TopKPeaks`` fields
    """
    n, h, w, c = heat.shape
    dev = heat.device
    x = heat.permute(0, 3, 1, 2)                              # (N, C, H, W)
    vh = valid_h.to(dev).view(n, 1, 1, 1)
    vw = valid_w.to(dev).view(n, 1, 1, 1)
    region = ((torch.arange(h, device=dev).view(1, 1, h, 1) < vh)
              & (torch.arange(w, device=dev).view(1, 1, 1, w) < vw))
    masked = torch.where(region, x, torch.full_like(x, NEG))
    padded = F.pad(masked, (1, 1, 1, 1), mode="reflect")
    hmax = F.max_pool2d(padded, kernel_size=3, stride=1)
    keep = (hmax == masked) & (masked >= thre)
    count = keep.sum(dim=(2, 3), dtype=torch.int32)

    scores = torch.where(keep, masked, torch.full_like(masked, NEG))
    vals, idx = select_desc(scores.reshape(n, c, h * w), k)  # (N, C, K)
    ys = torch.div(idx, w, rounding_mode="floor")
    xs = idx % w
    valid = vals >= thre

    r = radius
    offs = torch.arange(-r, r + 1, device=dev)
    wy = (ys[..., None] + offs).clamp(0, h - 1)               # (N, C, K, R)
    wx = (xs[..., None] + offs).clamp(0, w - 1)
    flat_idx = (wy[..., :, None] * w + wx[..., None, :]).reshape(n, c, -1)
    raw = x.reshape(n, c, h * w)
    boxes = torch.gather(raw, 2, flat_idx).reshape(n, c, k, 2 * r + 1,
                                                   2 * r + 1)
    offs_f = offs.to(boxes.dtype)
    total = _sum_last(boxes.flatten(-2))
    denom = torch.where(total == 0, torch.ones_like(total), total)
    gx = _sum_last((boxes * offs_f).flatten(-2)) / denom
    gy = _sum_last((boxes * offs_f[:, None]).flatten(-2)) / denom
    vh3, vw3 = vh.view(n, 1, 1), vw.view(n, 1, 1)
    inside = ((xs - r >= 0) & (xs + r + 1 <= vw3)
              & (ys - r >= 0) & (ys + r + 1 <= vh3))
    x_ref = torch.where(inside, xs + gx, xs.to(gx.dtype))
    y_ref = torch.where(inside, ys + gy, ys.to(gy.dtype))
    # XLA takes the window mean as sum * (1/25), the reciprocal in float32
    area_inv = torch.tensor(1.0 / (2 * r + 1) ** 2, dtype=torch.float32)
    score = torch.where(inside, total * area_inv.to(dev), vals)
    return (xs.to(torch.int32), ys.to(torch.int32), x_ref, y_ref, score,
            valid, count)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one term at a time, first to last: the order
    of the kernels' loops and of XLA's reductions here, so the sums agree
    to the last bit (``Tensor.sum`` adds in another order)."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  ``torch.sqrt`` of a float32
    CPU tensor can miss the last bit; the float64 root rounded to float32
    never does."""
    return torch.sqrt(x.double()).float()


def topk_peaks_kernel(heat: torch.Tensor, valid_h: torch.Tensor,
                      valid_w: torch.Tensor, *, thre: float, k: int,
                      radius: int) -> Tuple[torch.Tensor, ...]:
    """:func:`topk_peaks_plain` on the card: ``csrc/peaks.cu``, two
    launches (banded NMS, then per-channel select + refine)."""
    if heat.dtype != torch.float32 or heat.dim() != 4:
        raise ValueError(f"topk_peaks: heat must be (N, H, W, C) float32, "
                         f"got {tuple(heat.shape)} {heat.dtype}")
    n, h, w, c = heat.shape
    if not 1 <= k <= min(MAX_K, h * w) or radius < 0:
        raise ValueError(f"topk_peaks: k={k}, radius={radius} out of range "
                         f"for a {h}x{w} map")
    if not 1 <= c <= MAX_PEAK_CHANNELS:
        raise ValueError(f"topk_peaks: {c} channels, the kernel takes 1.."
                         f"{MAX_PEAK_CHANNELS}")
    _check_offsets("topk_peaks", heat)
    _require_cuda("topk_peaks", heat, valid_h, valid_w)
    dev = heat.device
    vh = valid_h.to(device=dev, dtype=torch.int32).contiguous()
    vw = valid_w.to(device=dev, dtype=torch.int32).contiguous()
    if vh.shape != (n,) or vw.shape != (n,):
        raise ValueError("topk_peaks: valid_h/valid_w must be (N,)")
    ntiles = _build.function("peaks", "ibp_topk_peaks_tiles", (_I, _I))(h, w)
    i32 = dict(device=dev, dtype=torch.int32)
    f32 = dict(device=dev, dtype=torch.float32)
    tile_val = torch.empty((n, c, ntiles, k), **f32)
    tile_idx = torch.empty((n, c, ntiles, k), **i32)
    tile_n = torch.empty((n, c, ntiles), **i32)
    count = torch.empty((n, c), **i32)
    xs, ys = (torch.empty((n, c, k), **i32) for _ in range(2))
    x_ref, y_ref, score = (torch.empty((n, c, k), **f32) for _ in range(3))
    valid = torch.empty((n, c, k), device=dev, dtype=torch.bool)
    fn = _build.function("peaks", "ibp_topk_peaks", _TOPK_ARGS)
    err = fn(heat.data_ptr(), *heat.stride(), n, h, w, c, vh.data_ptr(),
             vw.data_ptr(), float(thre), k, radius, tile_val.data_ptr(),
             tile_idx.data_ptr(), tile_n.data_ptr(), count.data_ptr(),
             xs.data_ptr(), ys.data_ptr(), x_ref.data_ptr(),
             y_ref.data_ptr(), score.data_ptr(), valid.data_ptr(),
             _stream(dev))
    _build.check(err, "topk_peaks")
    topk_peaks_kernel.launches += 1
    return xs, ys, x_ref, y_ref, score, valid, count


topk_peaks_kernel.launches = 0


# --------------------------------------------------------------------- #
# limb_pair_stats                                                       #
# --------------------------------------------------------------------- #


def limb_pair_stats_plain(paf: torch.Tensor, x_ref: torch.Tensor,
                          y_ref: torch.Tensor, *,
                          limbs_from: Sequence[int], limbs_to: Sequence[int],
                          num_samples: int, thre2: float
                          ) -> Tuple[torch.Tensor, ...]:
    """Dense A x B segment sampling of every limb channel, plain PyTorch.

    :param paf: (N, H, W, L) float32 limb maps
    :param x_ref, y_ref: (N, C, K) float32 refined peak coordinates
    :returns: (mean_score, above, num_samples, norm), each (N, L, K, K) --
        the ``ops.peaks.PairStats`` fields
    """
    n, h, w, n_limbs = paf.shape
    dev = paf.device
    la = torch.as_tensor(limbs_from, device=dev)
    lb = torch.as_tensor(limbs_to, device=dev)
    ax, ay = x_ref[:, la], y_ref[:, la]                       # (N, L, K)
    bx, by = x_ref[:, lb], y_ref[:, lb]
    vx = bx[:, :, None, :] - ax[:, :, :, None]                # (N, L, K, K)
    vy = by[:, :, None, :] - ay[:, :, :, None]
    # XLA (the JAX package's path) fuses this into fma(vx, vx, vy*vy);
    # the kernel calls fmaf the same way.  Emulated as in px below.
    norm = _sqrt((vx.double() * vx.double() + (vy * vy).double()).float())
    m = torch.clamp(torch.round(norm + 1), max=num_samples).to(torch.int32)

    s = torch.arange(num_samples, device=dev, dtype=norm.dtype)
    denom = torch.clamp(m - 1, min=1).to(norm.dtype)
    t = torch.clamp(s / denom[..., None], max=1.0)            # (..., S)
    # a + t*v rounded once, as a fused multiply-add (what XLA computes,
    # and the kernel's fmaf): a product of two float32 is exact in
    # float64, so only the sum rounds there; the float32 cast can then
    # differ from one rounding only by the last bit, and only where the
    # float64 sum lands exactly halfway between two float32 values
    t64 = t.double()
    px = (ax.double()[:, :, :, None, None] + t64 * vx.double()[..., None]
          ).float()
    py = (ay.double()[:, :, :, None, None] + t64 * vy.double()[..., None]
          ).float()
    xi = torch.round(px).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(py).to(torch.int64).clamp(0, h - 1)

    paf_t = paf.permute(0, 3, 1, 2).reshape(n, n_limbs, h * w)
    vals = torch.gather(paf_t, 2, (yi * w + xi).reshape(n, n_limbs, -1)
                        ).reshape(px.shape)
    in_seg = s < m[..., None]
    mean = (_sum_last(torch.where(in_seg, vals, torch.zeros_like(vals)))
            / torch.clamp(m, min=1).to(vals.dtype))
    above = ((vals > thre2) & in_seg).sum(-1, dtype=torch.int32)
    return mean, above, m, norm


def limb_pair_stats_kernel(paf: torch.Tensor, x_ref: torch.Tensor,
                           y_ref: torch.Tensor, *,
                           limbs_from: Sequence[int],
                           limbs_to: Sequence[int], num_samples: int,
                           thre2: float) -> Tuple[torch.Tensor, ...]:
    """:func:`limb_pair_stats_plain` on the card: ``csrc/limbs.cu``,
    one thread per (image, limb, A slot, B slot)."""
    if paf.dtype != torch.float32 or paf.dim() != 4:
        raise ValueError(f"limb_pair_stats: paf must be (N, H, W, L) "
                         f"float32, got {tuple(paf.shape)} {paf.dtype}")
    _check_offsets("limb_pair_stats", paf)
    _require_cuda("limb_pair_stats", paf, x_ref, y_ref)
    n, h, w, n_limbs = paf.shape
    if len(limbs_from) != n_limbs or len(limbs_to) != n_limbs:
        raise ValueError("limb_pair_stats: one (from, to) pair per channel")
    if x_ref.shape != y_ref.shape or x_ref.dim() != 3 or x_ref.shape[0] != n:
        raise ValueError("limb_pair_stats: x_ref/y_ref must be (N, C, K)")
    if num_samples < 1:
        raise ValueError("limb_pair_stats: num_samples must be >= 1")
    _, c, k = x_ref.shape
    la, lb = tuple(map(int, limbs_from)), tuple(map(int, limbs_to))
    if min(la + lb) < 0 or max(la + lb) >= c:
        raise ValueError("limb_pair_stats: limb endpoint out of range")
    if n * n_limbs * k * k > INT32_MAX or n * c * k > INT32_MAX:
        raise ValueError("limb_pair_stats: too many pairs for the kernel's "
                         "32-bit indices")
    dev = paf.device
    xr = x_ref.to(torch.float32).contiguous()
    yr = y_ref.to(torch.float32).contiguous()
    limbs = device_tensor(la + lb, dev, torch.int32)
    shape = (n, n_limbs, k, k)
    mean = torch.empty(shape, device=dev, dtype=torch.float32)
    norm = torch.empty(shape, device=dev, dtype=torch.float32)
    above = torch.empty(shape, device=dev, dtype=torch.int32)
    m = torch.empty(shape, device=dev, dtype=torch.int32)
    fn = _build.function("limbs", "ibp_limb_pair_stats", _LIMBS_ARGS)
    err = fn(paf.data_ptr(), *paf.stride(), n, h, w, n_limbs,
             xr.data_ptr(), yr.data_ptr(), c, k, limbs.data_ptr(),
             num_samples, float(thre2), mean.data_ptr(), above.data_ptr(),
             m.data_ptr(), norm.data_ptr(), _stream(dev))
    _build.check(err, "limb_pair_stats")
    limb_pair_stats_kernel.launches += 1
    return mean, above, m, norm


limb_pair_stats_kernel.launches = 0
