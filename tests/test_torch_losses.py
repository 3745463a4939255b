"""Port parity: the multi-scale loss (``ops/losses.py``) against the JAX
package's, on the CPU.

- ``avg_pool_to`` and ``downsample_mask`` (even and odd sizes, mask
  values straddling 0.5) within 1e-6: the port's antialiased bilinear
  resize against ``jax.image.resize``;
- ``_chan_scale`` exactly;
- ``multi_task_loss`` on canonical-layout predictions (4 stacks x 5
  scales, as tests/test_pallas_focal.py builds them), focal and L2, with
  ``normalize_by_global_batch`` on and off: rel 1e-5; its gradient with
  respect to every prediction: rtol 1e-4 / atol 1e-7 (the loss is divided
  by the batch and the scale weights, so gradients are ~1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.ops import losses as tl
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.ops import losses as jl


@pytest.mark.parametrize("h,w,th,tw", [(16, 16, 4, 4), (12, 18, 4, 6),
                                        (8, 8, 8, 8)])
def test_avg_pool_to(h, w, th, tw):
    x = np.random.default_rng(0).uniform(0, 1, (2, h, w, 5)).astype(
        np.float32)
    got = tl.avg_pool_to(torch.from_numpy(x), (th, tw)).numpy()
    want = np.asarray(jl.avg_pool_to(jnp.asarray(x), (th, tw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,th,tw", [(16, 16, 8, 8), (16, 16, 2, 2),
                                        (15, 17, 7, 5), (9, 13, 3, 6)])
def test_downsample_mask(h, w, th, tw):
    rng = np.random.default_rng(1)
    # binary miss mask, its left part unannotated, blurred into values
    # around the 0.5 cut
    mask = (rng.uniform(0, 1, (2, h, w, 1)) > 0.3).astype(np.float32)
    mask[:, :, : w // 2] = 0.0
    mask = (0.4 * mask + 0.3 + 0.05 * rng.uniform(-1, 1, mask.shape)).astype(
        np.float32)
    got = tl.downsample_mask(torch.from_numpy(mask), (th, tw)).numpy()
    want = np.asarray(jl.downsample_mask(jnp.asarray(mask), (th, tw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want == 0).any() and (want > 0).any()


def test_chan_scale_exact():
    sk = tconfig.get_config("canonical").skeleton
    args = (sk.num_layers, sk.heat_start, sk.bkg_start, 0.1, 3.0)
    got = tl._chan_scale(*args).numpy()
    want = np.asarray(jl._chan_scale(*args))
    np.testing.assert_array_equal(got, want)


def _canonical_case(seed=5, n=2, h=16):
    cfg = tconfig.get_config("canonical")
    c = cfg.skeleton.num_layers
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (n, h, h, c)).astype(np.float32)
    gt = np.where(gt < 0.4, 0.0, gt).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, h, h, 1)) > 0.2).astype(np.float32)
    preds = [[rng.uniform(-0.2, 1.2, (n, max(h >> s, 1), max(h >> s, 1), c))
              .astype(np.float32) for s in range(5)] for _ in range(4)]
    return cfg, preds, gt, mask


@pytest.mark.parametrize("use_focal", [True, False])
@pytest.mark.parametrize("by_batch", [True, False])
def test_multi_task_loss_and_gradient(use_focal, by_batch):
    cfg, preds, gt, mask = _canonical_case()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, normalize_by_global_batch=by_batch))
    jcfg = jconfig.get_config("canonical")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, normalize_by_global_batch=by_batch))

    tp = [[torch.from_numpy(p).requires_grad_(True) for p in st]
          for st in preds]
    loss = tl.multi_task_loss(tp, torch.from_numpy(gt),
                              torch.from_numpy(mask), cfg,
                              use_focal=use_focal)
    loss.backward()

    def jloss(ps):
        return jl.multi_task_loss(ps, jnp.asarray(gt), jnp.asarray(mask),
                                  jcfg, use_focal=use_focal)

    jps = [[jnp.asarray(p) for p in st] for st in preds]
    want, jgrads = jax.value_and_grad(jloss)(jps)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for i, st in enumerate(tp):
        for s, p in enumerate(st):
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(jgrads[i][s]), rtol=1e-4,
                                       atol=1e-7,
                                       err_msg=f"stack {i} scale {s}")
