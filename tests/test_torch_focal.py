"""Port parity: the focal-L2 loss and its written-out gradient.

On the CPU the port's ``focal_l2_fused`` runs the kernels' plain versions
(``ops/cuda_focal.py``).  They are held to the JAX package's Pallas kernel
in interpret mode (``focal_l2_pallas``) and to its XLA loss
(``ops.losses.focal_l2`` with the modulated mask), on the cases of
tests/test_pallas_focal.py:

- per-stack loss within rel 1e-5 (sums over ~1.5k terms in another order);
- the gradient with stack weights [1, 2] within rtol 1e-4 / atol 1e-5 of
  ``jax.grad`` of both;
- at the kink (pred exactly 1 on foreground, exactly 0 on background) the
  gradient equals JAX's abs-VJP convention (+-1) exactly, which autograd
  of ``torch.abs`` would not (it gives 0 there);
- an empty mask gives zero loss and zero gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch.ops.cuda_focal import (
    focal_bwd_plain,
    focal_fwd_plain,
    focal_l2_fused,
)
from improved_body_parts_tpu.ops.losses import focal_l2 as jfocal_l2
from improved_body_parts_tpu.ops.pallas_focal import focal_l2_pallas


def _case(seed, S=2, N=2, H=8, W=8, C=12):
    """tests/test_pallas_focal.py's ``_case``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.2, 1.2, (S, N, H, W, C)).astype(np.float32)
    gt = rng.uniform(0, 1, (N, H, W, C)).astype(np.float32)
    gt = np.where(gt < 0.3, 0.0, gt).astype(np.float32)
    mask = (rng.uniform(0, 1, (N, H, W, 1)) > 0.2).astype(np.float32)
    chan = rng.uniform(0.1, 3.0, (C,)).astype(np.float32)
    return pred, gt, mask, chan


def _kink_case(seed):
    """pred exactly 1 where gt >= 0.01 and exactly 0 elsewhere: every
    element sits on the kink |1 - st| = 0."""
    pred, gt, mask, chan = _case(seed)
    pred = np.broadcast_to(np.where(gt >= np.float32(0.01), 1.0, 0.0),
                           pred.shape).astype(np.float32)
    return pred, gt, mask, chan


def _xla(pred, gt, mask, chan):
    return jfocal_l2(pred, gt[None], (mask * chan)[None])


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_pallas_and_xla(seed):
    pred, gt, mask, chan = _case(seed)
    got = focal_l2_fused(*_torch(pred, gt, mask, chan)).numpy()
    pallas = np.asarray(focal_l2_pallas(pred, gt, mask, chan, True))
    xla = np.asarray(_xla(pred, gt, mask, chan))
    np.testing.assert_allclose(got, pallas, rtol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5)


def _grads(pred, gt, mask, chan, w):
    p = torch.from_numpy(pred).requires_grad_(True)
    g, m, c = _torch(gt, mask, chan)
    (focal_l2_fused(p, g, m, c) * torch.from_numpy(w)).sum().backward()
    wj = jnp.asarray(w)
    g_pallas = jax.grad(lambda q: (focal_l2_pallas(q, gt, mask, chan, True)
                                   * wj).sum())(pred)
    g_xla = jax.grad(lambda q: (_xla(q, gt, mask, chan) * wj).sum())(pred)
    return p.grad.numpy(), np.asarray(g_pallas), np.asarray(g_xla)


def test_gradient_matches_pallas_and_xla():
    got, g_pallas, g_xla = _grads(*_case(3), np.array([1.0, 2.0],
                                                      np.float32))
    np.testing.assert_allclose(got, g_pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, g_xla, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [5, 6])
def test_kink_gradient_follows_jax_convention(seed):
    pred, gt, mask, chan = _kink_case(seed)
    w = np.array([1.0, 2.0], np.float32)
    got, g_pallas, g_xla = _grads(pred, gt, mask, chan, w)
    # on the kink factor = 0 and diff*dfactor = -+diff: the gradient is
    # diff^2 * (+-1) * m * w, nonzero, and exactly JAX's
    np.testing.assert_array_equal(got, g_pallas)
    np.testing.assert_allclose(got, g_xla, rtol=1e-6, atol=0)
    assert np.count_nonzero(got) > got.size // 4
    # autograd of the forward formula gives 0 at the kink: the reason the
    # plain version writes its backward out
    p = torch.from_numpy(pred).requires_grad_(True)
    g, m, c = _torch(gt, mask, chan)
    st = torch.where(g >= 0.01, p, 1.0 - p)
    ((p - g) ** 2 * torch.abs(1.0 - st) * (m * c)).sum(dim=(1, 2, 3, 4)) \
        .mul(torch.from_numpy(w)).sum().backward()
    assert not np.array_equal(p.grad.numpy(), got)


def test_plain_backward_is_the_autograd_function_backward():
    pred, gt, mask, chan = _case(7)
    ct = torch.tensor([0.5, 3.0])
    p = torch.from_numpy(pred).requires_grad_(True)
    g, m, c = _torch(gt, mask, chan)
    (focal_l2_fused(p, g, m, c) * ct).sum().backward()
    want = focal_bwd_plain(torch.from_numpy(pred), g, m, c, ct)
    assert torch.equal(p.grad, want)


def test_empty_mask_gives_zero():
    pred, gt, _, chan = _case(4)
    mask = np.zeros((2, 8, 8, 1), np.float32)
    p = torch.from_numpy(pred).requires_grad_(True)
    g, m, c = _torch(gt, mask, chan)
    loss = focal_l2_fused(p, g, m, c)
    assert torch.equal(loss, torch.zeros(2))
    loss.sum().backward()
    assert not p.grad.any()
    assert torch.equal(focal_fwd_plain(p.detach(), g, m, c), torch.zeros(2))
