"""The masked focal-L2 loss: kernel wrappers, plain versions, autograd.

``focal_fwd_kernel`` and ``focal_bwd_kernel`` launch ``csrc/focal.cu``,
the counterparts of ``improved_body_parts_tpu/ops/pallas_focal.py``
``focal_l2_pallas`` (forward) and ``_focal_bwd`` (backward); the forward
is one launch a call.  Each takes CUDA tensors only, raises on anything
else (and on shapes or sizes the kernel does not take, before the device
check), and counts its launches in a plain int attribute
(``focal_fwd_kernel.launches``).

:func:`focal_l2_fused` is the entry point: a per-stack loss with its
gradient, through :class:`FocalL2Kernel` (both kernels) when ``pred`` lies
on a CUDA device and :class:`FocalL2Plain` (plain PyTorch) when it lies on
the CPU; ``chip_smoke.py`` holds the kernels against the plain versions on
the card.  Both are ``torch.autograd.Function``s with the backward written
out, because the gradient follows JAX's abs-VJP convention at the kink
``|1 - st| = 0`` (subgradient +-1), where autograd of ``torch.abs`` gives
0.  gt, mask and chan are labels and weights and get no gradient.

Layout (the JAX package's): pred (S, N, H, W, C) float32, gt (N, H, W, C),
mask (N, H, W, 1), chan (C,); the loss is (S,) float32.
"""
from __future__ import annotations

import ctypes

import torch

from .. import use_kernel
from . import _build
from .cuda_peaks import _require_cuda, _stream

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

FG_THRE = 0.01  # gt >= FG_THRE is foreground (compared in float32)
MAX_STACKS = 8  # FOCAL_MAX_S in csrc/focal.cu
MAX_CHANNELS = 1024  # FOCAL_MAX_C
INT32_MAX = 2 ** 31 - 1  # the forward's offsets are 32-bit


def _terms(pred, gt, mask, chan):
    """(m, fg, factor, diff) of the loss, op by op in the kernel's order."""
    m = mask * chan
    fg = gt >= FG_THRE
    st = torch.where(fg, pred, 1.0 - pred)
    factor = torch.abs(1.0 - st)
    diff = pred - gt
    return m, fg, factor, diff


def focal_fwd_plain(pred, gt, mask, chan) -> torch.Tensor:
    """Per-stack sums of ``diff * diff * factor * m``, plain PyTorch."""
    m, _, factor, diff = _terms(pred, gt, mask, chan)
    return (diff * diff * factor * m).sum(dim=(1, 2, 3, 4))


def focal_bwd_plain(pred, gt, mask, chan, ct) -> torch.Tensor:
    """d(sum_s ct[s] loss_s)/d pred, plain PyTorch, in the kernel's order:
    ``(2 diff factor + diff diff dfactor) * m * ct[s]``."""
    m, fg, factor, diff = _terms(pred, gt, mask, chan)
    one = torch.ones((), dtype=pred.dtype, device=pred.device)
    dfactor = torch.where(fg, -torch.where(1.0 - pred >= 0.0, one, -one),
                          torch.where(pred >= 0.0, one, -one))
    grad = (2.0 * diff * factor + diff * diff * dfactor) * m
    return grad * ct.view(-1, 1, 1, 1, 1)


def _check(name, pred, gt, mask, chan):
    if pred.dim() != 5:
        raise ValueError(f"{name}: pred must be (S, N, H, W, C), got "
                         f"{tuple(pred.shape)}")
    s, n, h, w, c = pred.shape
    if (tuple(gt.shape) != (n, h, w, c) or tuple(mask.shape) != (n, h, w, 1)
            or tuple(chan.shape) != (c,)):
        raise ValueError(f"{name}: expected gt (N,H,W,C), mask (N,H,W,1) and "
                         f"chan (C,) for pred {tuple(pred.shape)}; got "
                         f"{tuple(gt.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(chan.shape)}")
    if any(t.dtype != torch.float32 for t in (pred, gt, mask, chan)):
        raise ValueError(f"{name}: the kernel takes float32 tensors")
    return s, n * h * w * c, c


_tickets = {}


def _fwd_ticket(device: torch.device) -> torch.Tensor:
    """The forward's last-block ticket on ``device``: one int, 0 between
    calls (each call's last block sets it back)."""
    t = _tickets.get(device)
    if t is None:
        t = _tickets[device] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
    return t


def focal_fwd_kernel(pred, gt, mask, chan) -> torch.Tensor:
    """:func:`focal_fwd_plain` on the card: ``csrc/focal.cu``, one launch
    that reads gt, mask and chan once for all stacks and sums the blocks'
    partials in a fixed order (the same bits every run)."""
    s, e, c = _check("focal_fwd", pred, gt, mask, chan)
    if not 1 <= s <= MAX_STACKS or c > MAX_CHANNELS:
        raise ValueError(f"focal_fwd: {s} stacks and {c} channels, the "
                         f"kernel takes 1..{MAX_STACKS} stacks and at most "
                         f"{MAX_CHANNELS} channels")
    if s * e > INT32_MAX:
        raise ValueError(f"focal_fwd: {s} x {e} prediction elements, past "
                         "the kernel's 32-bit offsets")
    _require_cuda("focal_fwd", pred, gt, mask, chan)
    pred, gt, mask, chan = (t.contiguous() for t in (pred, gt, mask, chan))
    blocks = _build.function("focal", "ibp_focal_fwd_blocks", (_I,))(e)
    partial = torch.empty(s * max(blocks, 1), dtype=torch.float64,
                          device=pred.device)
    out = torch.empty(s, dtype=torch.float32, device=pred.device)
    fn = _build.function("focal", "ibp_focal_fwd",
                         (_P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P))
    err = fn(pred.data_ptr(), gt.data_ptr(), mask.data_ptr(),
             chan.data_ptr(), s, e, c, partial.data_ptr(),
             _fwd_ticket(pred.device).data_ptr(), out.data_ptr(),
             _stream(pred.device))
    _build.check(err, "focal_fwd")
    focal_fwd_kernel.launches += 1
    return out


def focal_bwd_kernel(pred, gt, mask, chan, ct) -> torch.Tensor:
    """:func:`focal_bwd_plain` on the card: ``csrc/focal.cu``, one fused
    elementwise pass."""
    s, e, c = _check("focal_bwd", pred, gt, mask, chan)
    _require_cuda("focal_bwd", pred, gt, mask, chan, ct)
    pred, gt, mask, chan = (t.contiguous() for t in (pred, gt, mask, chan))
    ct = ct.to(torch.float32).contiguous()
    if tuple(ct.shape) != (s,):
        raise ValueError(f"focal_bwd: ct must be ({s},), got "
                         f"{tuple(ct.shape)}")
    dpred = torch.empty_like(pred)
    fn = _build.function("focal", "ibp_focal_bwd",
                         (_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P))
    err = fn(pred.data_ptr(), gt.data_ptr(), mask.data_ptr(),
             chan.data_ptr(), ct.data_ptr(), s, e, c, dpred.data_ptr(),
             _stream(pred.device))
    _build.check(err, "focal_bwd")
    focal_bwd_kernel.launches += 1
    return dpred


focal_fwd_kernel.launches = 0
focal_bwd_kernel.launches = 0


class FocalL2Plain(torch.autograd.Function):
    """Per-stack focal L2 with its written-out gradient, plain PyTorch."""

    @staticmethod
    def forward(ctx, pred, gt, mask, chan):
        ctx.save_for_backward(pred, gt, mask, chan)
        return focal_fwd_plain(pred, gt, mask, chan)

    @staticmethod
    def backward(ctx, ct):
        return focal_bwd_plain(*ctx.saved_tensors, ct), None, None, None


class FocalL2Kernel(torch.autograd.Function):
    """Per-stack focal L2 on the card: the forward kernel, and the
    backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, pred, gt, mask, chan):
        ctx.save_for_backward(pred, gt, mask, chan)
        return focal_fwd_kernel(pred, gt, mask, chan)

    @staticmethod
    def backward(ctx, ct):
        return focal_bwd_kernel(*ctx.saved_tensors, ct), None, None, None


def focal_l2_fused(pred, gt, mask, chan) -> torch.Tensor:
    """Per-stack masked focal L2 (gamma 1, no alpha/beta) with the task
    weights ``chan`` as a (C,) vector: pred (S,N,H,W,C) -> (S,).  Launches
    the kernels for CUDA tensors, runs the plain versions for CPU ones."""
    fn = FocalL2Kernel if use_kernel(pred) else FocalL2Plain
    return fn.apply(pred, gt, mask, chan)
