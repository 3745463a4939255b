"""Port parity: the x stride cubic upsample (``infer.resize``) against
``jax.image.resize(..., method="cubic")``, within 1e-5 (the two weight-
matrix products sum in another order than XLA's einsum), on even and odd
map sizes.  ``F.interpolate(mode="bicubic")`` is not this function."""
import numpy as np
import pytest
import torch

from improved_body_parts_torch.infer.resize import upsample_cubic


@pytest.mark.parametrize("h,w,stride", [(16, 14, 4), (9, 13, 4), (7, 6, 2)])
def test_upsample_cubic_matches_jax_image_resize(h, w, stride):
    import jax

    maps = np.random.default_rng(h * w).normal(0, 1, (2, h, w, 5)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(
        maps, (2, h * stride, w * stride, 5), method="cubic"))
    got = upsample_cubic(torch.from_numpy(maps), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the library bicubic (Keys a = -0.75) is measurably another function
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(maps).permute(0, 3, 1, 2), scale_factor=stride,
        mode="bicubic").permute(0, 2, 3, 1).numpy()
    assert np.abs(bicubic - want).max() > 1e-2
