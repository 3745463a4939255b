"""The cubic resize of the ensembled maps: the x stride upsample of every
lane, and the regrid of a scale / rotation grid's entries onto the
decode grid.

Written to ``jax.image.resize(..., method="cubic")``'s definition, which
the JAX package's programs use: the Keys cubic kernel with a = -0.5,
half-pixel sample positions, each output's weights renormalised to sum to
one (which matters at the edges), and weights of samples outside the
input zeroed; when shrinking, the kernel widens by the ratio
(antialiasing, JAX's default).  ``F.interpolate(mode="bicubic")`` is
another function (a = -0.75, clamped edges).  The resize is separable,
so it runs as two weight-matrix products, rows then columns, on the
maps' own device (a float32 product in full precision unless the caller
enabled TF32 for matmuls); a dimension whose size does not change is
skipped, as JAX skips it, so it passes through bit for bit.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch


def cubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) float32 interpolation matrix of one axis, as
    ``jax.image.resize``'s ``compute_weight_mat`` builds it (transposed)."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)  # rounded as JAX rounds it
    kernel_scale = max(inv_scale, 1.0)  # antialias: widen when shrinking
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    # Keys (1981) cubic convolution kernel, a = -0.5
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    weights = torch.where(x >= 2.0, 0.0, out)                 # (in, out)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).T.contiguous()


@functools.lru_cache(maxsize=None)
def _weights_on(in_size: int, out_size: int,
                device: torch.device) -> torch.Tensor:
    """:func:`cubic_weights` on ``device``, made once per size and device
    and copied from pinned memory without blocking: a blocking copy
    makes the host wait for the work queued before it (a grid's regrid
    meets a new size with each new image size)."""
    weights = cubic_weights(in_size, out_size)
    if device.type == "cuda":
        return weights.pin_memory().to(device, non_blocking=True)
    return weights.to(device)


def resize_cubic(maps: torch.Tensor, size: Tuple[int, int]
                 ) -> torch.Tensor:
    """(N, h, w, C) float32 maps -> (N, out_h, out_w, C), ``size`` =
    (out_h, out_w), at any ratio: rows, then columns, each skipped when
    its size does not change (``maps`` itself comes back when neither
    does)."""
    n, h, w, c = maps.shape
    out_h, out_w = int(size[0]), int(size[1])
    out = maps
    if out_h != h:
        wh = _weights_on(h, out_h, maps.device)               # (H, h)
        out = torch.matmul(wh, out.reshape(n, h, w * c)).reshape(
            n, out_h, w, c)
    if out_w != w:
        ww = _weights_on(w, out_w, maps.device)               # (W, w)
        out = torch.matmul(ww, out.reshape(n * out_h, w, c)).reshape(
            n, out_h, out_w, c)
    return out


def upsample_cubic(maps: torch.Tensor, stride: int) -> torch.Tensor:
    """(N, h, w, C) float32 maps -> (N, h*stride, w*stride, C)."""
    _, h, w, _ = maps.shape
    return resize_cubic(maps, (h * stride, w * stride))
