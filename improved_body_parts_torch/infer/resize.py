"""The x stride cubic upsample of the ensembled maps.

Written to ``jax.image.resize(..., method="cubic")``'s definition, which
the JAX package's serve program uses: the Keys cubic kernel with a = -0.5,
half-pixel sample positions, each output's weights renormalised to sum to
one (which matters at the edges), and weights of samples outside the
input zeroed.  ``F.interpolate(mode="bicubic")`` is another function
(a = -0.75, clamped edges).  The resize is separable, so it runs as two
weight-matrix products, rows then columns, on the maps' own device (a
float32 product in full precision unless the caller enabled TF32 for
matmuls).
"""
from __future__ import annotations

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


def upsample_cubic(maps: torch.Tensor, stride: int) -> torch.Tensor:
    """(N, h, w, C) float32 maps -> (N, h*stride, w*stride, C)."""
    n, h, w, c = maps.shape
    big_h, big_w = h * stride, w * stride
    wh = cubic_weights(h, big_h).to(maps.device)              # (H, h)
    ww = cubic_weights(w, big_w).to(maps.device)              # (W, w)
    rows = torch.matmul(wh, maps.reshape(n, h, w * c))        # (N, H, w*C)
    out = torch.matmul(ww, rows.reshape(n * big_h, w, c))     # (N*H, W, C)
    return out.reshape(n, big_h, big_w, c)
