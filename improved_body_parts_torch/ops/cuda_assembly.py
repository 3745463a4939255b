"""Wrapper of the greedy-assembly kernel, with its plain version.

``greedy_assemble_kernel`` launches ``csrc/assembly.cu``: the whole of the
JAX package's ``greedy_assemble`` (``improved_body_parts_tpu/ops/
assembly.py:89-323``) per image, one block per image -- the candidate
walk (the TPU kernel ``candidate_walk_pallas`` of
``ops/pallas_assembly.py``), the person-table rules applied to each
connection it takes, and the prune.  It takes CUDA tensors only and
raises on anything else; ``ops.assembly`` routes a CPU tensor to
:func:`greedy_assemble_plain`, which computes the same function with
PyTorch ops on any device (``chip_smoke.py`` holds the kernel to it on the
card, bit for bit).  The wrapper counts its launches in
``greedy_assemble_kernel.launches``.

The plain version splits the work in two:

1. the walk (:func:`candidate_walk_plain`) over every (image, limb) row,
   giving the (N, L, M) selection flags.  This is exact: whether a
   candidate is taken depends only on the used-masks and ``limit``, never
   on the person table;
2. the person-table rules (``process`` of the JAX package: spawn, one,
   merge; compete only when ``remove_recon > 0``) over the selected
   connections in limb order, then rank order, as branch-free PyTorch over
   the image axis: every branch is computed and ``torch.where`` keeps the
   one each image takes.  Round r of limb l handles each image's r-th
   selected connection of that limb, so the loop runs ``max over images
   of the selection count`` rounds per limb; those counts are read back to
   the host, which the kernel never does.

Both return (subset, mask, n_people, peak_overflow, cand_overflow,
person_overflow), the fields of ``ops.assembly.AssemblyResult``, in fp32
arithmetic in the JAX package's order.  Peaks are identified by the flat
slot id ``channel * K + slot``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from .. import device_tensor
from . import _build
from .cuda_peaks import _require_cuda, _stream

MAX_P = 128       # ASM_MAX_P in csrc/assembly.cu: 4 table rows a lane
MAX_PARTS = 32    # ASM_MAX_PARTS: a part a lane
MAX_K = 1024      # ASM_MAX_K
MAX_M = 1024      # ASM_MAX_M
SMEM_LIMIT = 232_448  # ASM_SMEM_LIMIT: shared memory a block can use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGS = ((_P,) * 9 + (_I,) * 7 + (_F, _F, _I, _F, _F) + (_P,) * 6
         + (_P,))


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


State = Dict[str, torch.Tensor]


def _blend(st: State, branches: List[Tuple[torch.Tensor, State]]) -> State:
    """Per image, the state of the one branch whose gate is set (the
    gates are disjoint), or the old state where none is."""
    out = {}
    for key, old in st.items():
        val = old
        for gate, new in branches:
            if key in new:
                g = gate.view(-1, *([1] * (old.dim() - 1)))
                val = torch.where(g, new[key], val)
        out[key] = val
    return out


def _process(st: State, gate: torch.Tensor, ia: int, ib: int,
             sa: torch.Tensor, sb: torch.Tensor, score: torch.Tensor,
             limb_len: torch.Tensor, pscore: torch.Tensor, k: int,
             len_rate: float, connection_tole: float,
             remove_recon: int) -> State:
    """One selected connection per gated image through the found in
    {0, 1, 2} rules (reference: evaluate.py:320-488)."""
    ids, conf, tot = st["ids"], st["conf"], st["tot"]
    npart, maxlen, active = st["npart"], st["maxlen"], st["active"]
    n, p, num_parts = ids.shape
    dev = ids.device
    rows = torch.arange(p, device=dev)[None, :]              # (1, P)
    parts = torch.arange(num_parts, device=dev)[None, None, :]
    ar = torch.arange(n, device=dev)
    n_ids = pscore.shape[1]
    aid = ia * k + sa                                        # (N,)
    bid = ib * k + sb
    psa = pscore[ar, aid]
    psb = pscore[ar, bid]
    s1, l1 = score[:, None], limb_len[:, None]

    # the first two owners in table order (creation order), capped at 2
    match = active & ((ids[:, :, ia] == aid[:, None])
                      | (ids[:, :, ib] == bid[:, None]))
    first = torch.where(match, rows, p).amin(dim=1)
    j1 = first.clamp(max=p - 1)
    later = match & (rows > j1[:, None])
    second = torch.where(later, rows, p).amin(dim=1)
    j2 = second.clamp(max=p - 1)
    found = (first < p).long() + (second < p).long()

    # spawn: no owner -- a new person at the next free row; a full table
    # sets the overflow flag instead (evaluate.py:473-488)
    cnt = st["count"]
    can = cnt < p
    rmask = (rows == cnt[:, None]) & can[:, None]
    col_a, col_b = parts == ia, parts == ib
    cell = rmask[:, :, None] & (col_a | col_b)
    spawn = dict(
        ids=torch.where(cell, torch.where(col_a, aid[:, None, None],
                                          bid[:, None, None]), ids),
        conf=torch.where(cell, s1[:, :, None], conf),
        tot=torch.where(rmask, (psa + psb + score)[:, None], tot),
        npart=torch.where(rmask, 2.0, npart),
        maxlen=torch.where(rmask, l1, maxlen),
        active=active | rmask,
        count=cnt + can.long(),
        overflow=st["overflow"] | ~can)

    # one owner: assign / replace / rescore part B on row j1
    # (evaluate.py:320-380)
    old_b = ids[ar, j1, ib]
    conf_b = conf[ar, j1, ib]
    grow_ok = len_rate * maxlen[ar, j1] > limb_len
    same = old_b == bid
    do_assign = (old_b == -1) & grow_ok
    do_update = ~do_assign & torch.where(same, conf_b <= score,
                                         (conf_b < score) & grow_ok)
    write = do_assign | do_update
    old_p = pscore[ar, old_b.clamp(0, n_ids - 1)]
    delta = torch.where(do_assign, psb + score,
                        torch.where(do_update, psb + score - old_p - conf_b,
                                    0.0))
    rj = rows == j1[:, None]
    cell = rj[:, :, None] & (parts == ib) & write[:, None, None]
    one = dict(
        ids=torch.where(cell, bid[:, None, None], ids),
        conf=torch.where(cell, s1[:, :, None], conf),
        tot=tot + torch.where(rj, delta[:, None], 0.0),
        npart=npart + torch.where(rj & do_assign[:, None], 1.0, 0.0),
        maxlen=torch.where(rj & write[:, None], torch.maximum(maxlen, l1),
                           maxlen))

    # two owners, disjoint: merge j2 into j1, gated by confidence and
    # length priors (evaluate.py:403-424)
    memb1 = ids[ar, j1] >= 0                                 # (N, parts)
    memb2 = ids[ar, j2] >= 0
    overlap = (memb1 & memb2).any(dim=1)
    conf1, conf2 = conf[ar, j1], conf[ar, j2]
    min_tol = torch.minimum(
        torch.where(memb1, conf1, torch.inf).amin(dim=1),
        torch.where(memb2, conf2, torch.inf).amin(dim=1))
    refuse = ((score < connection_tole * min_tol)
              | (len_rate * maxlen[ar, j1] <= limb_len))
    r1 = rows == j1[:, None]
    r2 = rows == j2[:, None]
    ids1 = ids[ar, j1] + ids[ar, j2] + 1
    conf1n = conf1 + conf2 + 1.0
    merge = dict(
        ids=torch.where(r2[:, :, None], -1,
                        torch.where(r1[:, :, None], ids1[:, None, :], ids)),
        conf=torch.where(r2[:, :, None], -1.0,
                         torch.where(r1[:, :, None], conf1n[:, None, :],
                                     conf)),
        tot=torch.where(r1, (tot[ar, j1] + tot[ar, j2] + score)[:, None],
                        torch.where(r2, 0.0, tot)),
        npart=torch.where(r1, (npart[ar, j1] + npart[ar, j2])[:, None],
                          torch.where(r2, 0.0, npart)),
        # the host takes max(limb_len, j1's): j2's longest limb is
        # deliberately not folded in
        maxlen=torch.where(r1, torch.maximum(maxlen, l1),
                           torch.where(r2, -1.0, maxlen)),
        active=active & ~r2)

    two = found == 2
    branches = [(gate & (found == 0), spawn), (gate & (found == 1), one),
                (gate & two & ~overlap & ~refuse, merge)]

    if remove_recon > 0:
        # two owners sharing a part compete for this limb
        # (evaluate.py:426-460); at remove_recon == 0 this is a no-op
        a_in_1 = ids[ar, j1, ia] == aid
        c1 = torch.where(a_in_1, ia, ib)
        c2 = torch.where(a_in_1, ib, ia)
        conf_11 = conf[ar, j1, c1]
        conf_22 = conf[ar, j2, c2]
        skip = (score < conf_11) & (score < conf_22)
        small_is_2 = conf_11 > conf_22
        sj = torch.where(small_is_2, j2, j1)
        rc = torch.where(small_is_2, c2, c1)
        old_id = ids[ar, sj, rc]
        old_conf = conf[ar, sj, rc]
        old_p = pscore[ar, old_id.clamp(0, n_ids - 1)]
        rs = rows == sj[:, None]
        cell = rs[:, :, None] & (parts == rc[:, None, None])
        compete = dict(
            ids=torch.where(cell, -1, ids),
            conf=torch.where(cell, -1.0, conf),
            tot=tot - torch.where(rs, (old_p + old_conf)[:, None], 0.0),
            npart=npart - torch.where(rs, 1.0, 0.0))
        branches.append((gate & two & overlap & ~skip, compete))
    return _blend(st, branches)


def greedy_assemble_plain(peaks, cands, *, limbs_from: Sequence[int],
                          limbs_to: Sequence[int], num_parts: int,
                          p_max: int, len_rate: float,
                          connection_tole: float, remove_recon: int,
                          min_parts: int, min_mean_score: float
                          ) -> Tuple[torch.Tensor, ...]:
    """Greedy person assembly over (N, C, K) peaks and (N, L, M) rank-
    ordered candidates (``ops.peaks.TopKPeaks`` / ``LimbCandidates``), plain
    PyTorch: the walk, then the rules in rounds (see the module
    docstring); ``p_max`` is the person-table capacity."""
    f32 = torch.float32
    n, c, k = peaks.valid.shape
    _, n_limbs, m_cap = cands.valid.shape
    dev = peaks.valid.device
    la = torch.as_tensor(limbs_from, device=dev)
    lb = torch.as_tensor(limbs_to, device=dev)
    n_peaks = torch.clamp(peaks.count, max=k)         # true counts, capped
    limit = torch.minimum(n_peaks[:, la], n_peaks[:, lb])     # (N, L)
    pscore = peaks.score.to(f32).reshape(n, c * k)    # flat-id score lookup

    sel = candidate_walk_plain(cands.slot_a, cands.slot_b, cands.valid,
                               limit, k).bool()                # (N, L, M)
    # each (image, limb)'s selected ranks first, in rank order
    ranks = torch.arange(m_cap, device=dev)
    order = torch.sort(torch.where(sel, ranks, m_cap), dim=-1).values
    order = order.clamp(max=m_cap - 1)
    n_sel = sel.sum(dim=-1)                                    # (N, L)
    rounds = n_sel.amax(dim=0).tolist()  # read back to the host

    st: State = dict(
        ids=torch.full((n, p_max, num_parts), -1, dtype=torch.long,
                       device=dev),
        conf=torch.full((n, p_max, num_parts), -1.0, dtype=f32, device=dev),
        tot=torch.zeros((n, p_max), dtype=f32, device=dev),
        npart=torch.zeros((n, p_max), dtype=f32, device=dev),
        maxlen=torch.full((n, p_max), -1.0, dtype=f32, device=dev),
        active=torch.zeros((n, p_max), dtype=torch.bool, device=dev),
        count=torch.zeros((n,), dtype=torch.long, device=dev),
        overflow=torch.zeros((n,), dtype=torch.bool, device=dev))
    slot_a = cands.slot_a.long().clamp(0, k - 1)
    slot_b = cands.slot_b.long().clamp(0, k - 1)
    prior = cands.prior.to(f32)
    norm = cands.norm.to(f32)
    for li in range(n_limbs):
        for r in range(rounds[li]):
            mi = order[:, li, r:r + 1]                         # (N, 1)
            st = _process(
                st, r < n_sel[:, li], int(limbs_from[li]),
                int(limbs_to[li]),
                slot_a[:, li].gather(1, mi)[:, 0],
                slot_b[:, li].gather(1, mi)[:, 0],
                prior[:, li].gather(1, mi)[:, 0],
                norm[:, li].gather(1, mi)[:, 0], pscore, k, len_rate,
                connection_tole, remove_recon)

    # prune sparse / low-confidence people (evaluate.py:491-496)
    npart_safe = torch.clamp(st["npart"], min=1.0)
    mask = (st["active"] & (st["npart"] >= min_parts)
            & (st["tot"] / npart_safe >= min_mean_score))
    part_rows = torch.stack([st["ids"].to(f32), st["conf"]], dim=-1)
    row_m2 = torch.stack([st["tot"], torch.full_like(st["tot"], -1.0)],
                         dim=-1)[:, :, None, :]
    row_m1 = torch.stack([st["npart"], st["maxlen"]], dim=-1)[:, :, None, :]
    subset = torch.cat([part_rows, row_m2, row_m1], dim=2)
    return (subset, mask, mask.sum(dim=1, dtype=torch.int32),
            (peaks.count > k).any(dim=1), (cands.count > m_cap).any(dim=1),
            st["overflow"])


def _smem_bytes(c: int, k: int, n_limbs: int, m_cap: int, p_max: int,
               num_parts: int) -> int:
    """Shared memory a block of ``csrc/assembly.cu`` takes at these sizes
    (its ``asm_layout``): the staged scores, counts, limbs and candidates,
    the table and the used-masks."""
    lm = n_limbs * m_cap
    return (4 * c * k + 8 * num_parts * (p_max + 1) + 16 * p_max + 4 * c
            + 8 * n_limbs + 16 * lm + -(-lm // 4) * 4 + -(-2 * k // 4) * 4)


def _check(peaks, cands, limbs_from, limbs_to, num_parts, p_max):
    """The shapes and sizes the kernel takes; raises ValueError past them.
    Returns (N, C, K, L, M)."""
    if peaks.score.dim() != 3:
        raise ValueError("greedy_assemble: peaks must be (N, C, K)")
    n, c, k = peaks.score.shape
    if tuple(peaks.count.shape) != (n, c):
        raise ValueError("greedy_assemble: peaks.count must be (N, C)")
    if cands.slot_a.dim() != 3 or cands.slot_a.shape[0] != n:
        raise ValueError("greedy_assemble: candidates must be (N, L, M) "
                         "over the peaks' images")
    _, n_limbs, m_cap = cands.slot_a.shape
    for name in ("slot_b", "prior", "norm", "valid"):
        if getattr(cands, name).shape != cands.slot_a.shape:
            raise ValueError(f"greedy_assemble: cands.{name} must be "
                             f"{tuple(cands.slot_a.shape)}")
    if tuple(cands.count.shape) != (n, n_limbs):
        raise ValueError("greedy_assemble: cands.count must be (N, L)")
    if len(limbs_from) != n_limbs or len(limbs_to) != n_limbs:
        raise ValueError("greedy_assemble: one (from, to) pair per limb")
    ends = tuple(map(int, limbs_from)) + tuple(map(int, limbs_to))
    if ends and (min(ends) < 0 or max(ends) >= min(c, num_parts)):
        raise ValueError("greedy_assemble: limb endpoint out of range")
    if not (1 <= p_max <= MAX_P and 1 <= num_parts <= MAX_PARTS
            and 1 <= k <= MAX_K and 1 <= m_cap <= MAX_M):
        raise ValueError(
            f"greedy_assemble: p_max={p_max}, num_parts={num_parts}, K={k}, "
            f"M={m_cap} past the kernel's limits (p_max <= {MAX_P}, parts <= "
            f"{MAX_PARTS}, K <= {MAX_K}, M <= {MAX_M})")
    need = _smem_bytes(c, k, n_limbs, m_cap, p_max, num_parts)
    if need > SMEM_LIMIT:
        raise ValueError(f"greedy_assemble: an image's inputs and table take "
                         f"{need} B of shared memory, past the {SMEM_LIMIT} B "
                         "a block can use")
    return n, c, k, n_limbs, m_cap


def greedy_assemble_kernel(peaks, cands, *, limbs_from: Sequence[int],
                           limbs_to: Sequence[int], num_parts: int,
                           p_max: int, len_rate: float,
                           connection_tole: float, remove_recon: int,
                           min_parts: int, min_mean_score: float
                           ) -> Tuple[torch.Tensor, ...]:
    """:func:`greedy_assemble_plain` on the card: ``csrc/assembly.cu``, one
    block per image with its inputs and person table in shared memory.
    Enqueues the work and returns; nothing is read back to the host."""
    n, c, k, n_limbs, m_cap = _check(peaks, cands, limbs_from, limbs_to,
                                     num_parts, p_max)
    _require_cuda("greedy_assemble", peaks.score, peaks.count, *cands)
    dev = peaks.score.device
    i32, f32 = torch.int32, torch.float32
    score = peaks.score.to(f32).contiguous()
    pcount = peaks.count.to(i32).contiguous()
    slot_a = cands.slot_a.to(i32).contiguous()
    slot_b = cands.slot_b.to(i32).contiguous()
    prior = cands.prior.to(f32).contiguous()
    norm = cands.norm.to(f32).contiguous()
    valid = cands.valid.to(torch.bool).contiguous()
    ccount = cands.count.to(i32).contiguous()
    limbs = device_tensor(tuple(map(int, limbs_from))
                          + tuple(map(int, limbs_to)), dev, torch.int32)
    subset = torch.empty((n, p_max, num_parts + 2, 2), device=dev, dtype=f32)
    mask = torch.empty((n, p_max), device=dev, dtype=torch.bool)
    n_people = torch.empty((n,), device=dev, dtype=i32)
    flags = torch.empty((3, n), device=dev, dtype=torch.bool)
    fn = _build.function("assembly", "ibp_greedy_assemble", _ARGS)
    err = fn(score.data_ptr(), pcount.data_ptr(), slot_a.data_ptr(),
             slot_b.data_ptr(), prior.data_ptr(), norm.data_ptr(),
             valid.data_ptr(), ccount.data_ptr(), limbs.data_ptr(), n, c, k,
             n_limbs, m_cap, p_max, num_parts, float(len_rate),
             float(connection_tole), int(remove_recon), float(min_parts),
             float(min_mean_score), subset.data_ptr(), mask.data_ptr(),
             n_people.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
             flags[2].data_ptr(), _stream(dev))
    _build.check(err, "greedy_assemble")
    if n:
        greedy_assemble_kernel.launches += 1
    return subset, mask, n_people, flags[0], flags[1], flags[2]


greedy_assemble_kernel.launches = 0
