"""Wrapper of the candidate-walk kernel, with its plain version.

``candidate_walk_kernel`` launches ``csrc/walk.cu``, the counterpart of
``improved_body_parts_tpu/ops/pallas_assembly.py``
``candidate_walk_pallas``: the per-limb one-to-one walk of
``greedy_assemble`` (``ops/assembly.py:266-303`` of the JAX package).  It
takes CUDA tensors only and raises on anything else; ``ops.assembly``
routes a CPU tensor to :func:`candidate_walk_plain`, which computes the
same flags with PyTorch ops on any device.  The wrapper counts its
launches in ``candidate_walk_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .cuda_peaks import _require_cuda, _stream

_P = ctypes.c_void_p
_I = ctypes.c_int


def candidate_walk_plain(slot_a: torch.Tensor, slot_b: torch.Tensor,
                         valid: torch.Tensor, limit: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Selection flags of the per-limb one-to-one walk, plain PyTorch.

    Over each row's rank-ordered candidates, take one when it is valid,
    fewer than ``limit`` are taken and neither endpoint slot is used yet;
    then mark both endpoints used.

    :param slot_a, slot_b: (..., M) int candidate endpoint slots in [0, k)
    :param valid: (..., M) bool/int acceptance flags
    :param limit: (...) int per-row selection cap
    :returns: (..., M) int32 selection flags
    """
    lead, m_cap = slot_a.shape[:-1], slot_a.shape[-1]
    dev = slot_a.device
    sa = slot_a.reshape(-1, m_cap).long().clamp(0, k - 1)
    sb = slot_b.reshape(-1, m_cap).long().clamp(0, k - 1)
    ok_in = valid.reshape(-1, m_cap).bool()
    lim = limit.reshape(-1).to(dev)
    rows = torch.arange(sa.shape[0], device=dev)
    used_a = torch.zeros((sa.shape[0], k), dtype=torch.bool, device=dev)
    used_b = torch.zeros_like(used_a)
    taken = torch.zeros_like(lim)
    sel = torch.zeros(sa.shape, dtype=torch.int32, device=dev)
    for m in range(m_cap):
        a, b = sa[:, m], sb[:, m]
        ok = ok_in[:, m] & (taken < lim) & ~used_a[rows, a] & ~used_b[rows, b]
        sel[:, m] = ok.to(torch.int32)
        used_a[rows, a] |= ok
        used_b[rows, b] |= ok
        taken += ok.to(taken.dtype)
    return sel.reshape(*lead, m_cap)


def candidate_walk_kernel(slot_a: torch.Tensor, slot_b: torch.Tensor,
                          valid: torch.Tensor, limit: torch.Tensor,
                          k: int) -> torch.Tensor:
    """:func:`candidate_walk_plain` on the card: ``csrc/walk.cu``, one
    thread per row with its used-masks in shared memory."""
    _require_cuda("candidate_walk", slot_a, slot_b, valid, limit)
    if slot_a.shape != slot_b.shape or slot_a.shape != valid.shape:
        raise ValueError("candidate_walk: slot_a, slot_b and valid must "
                         "share one (..., M) shape")
    if limit.shape != slot_a.shape[:-1]:
        raise ValueError("candidate_walk: limit must be (...) of slot_a's "
                         "leading shape")
    if not 1 <= k <= 768:
        raise ValueError(f"candidate_walk: k={k} out of the kernel's range "
                         "[1, 768] (32 rows' used-masks share 48 KB of "
                         "shared memory)")
    m_cap = slot_a.shape[-1]
    rows = limit.numel()
    sa, sb, va, li = (t.to(torch.int32).contiguous()
                      for t in (slot_a, slot_b, valid, limit))
    sel = torch.empty(sa.shape, device=sa.device, dtype=torch.int32)
    fn = _build.function("walk", "ibp_candidate_walk",
                         (_P, _P, _P, _P, _I, _I, _I, _P, _P))
    err = fn(sa.data_ptr(), sb.data_ptr(), va.data_ptr(), li.data_ptr(),
             rows, m_cap, k, sel.data_ptr(), _stream(sa.device))
    _build.check(err, "candidate_walk")
    candidate_walk_kernel.launches += 1
    return sel


candidate_walk_kernel.launches = 0
