"""Greedy skeleton assembly on the device -- the last decode stage.

Counterpart of ``improved_body_parts_tpu/ops/assembly.py``
``greedy_assemble``, batched over a leading image axis.  The JAX package
walks each limb's rank-ordered candidates in a ``lax.while_loop`` and
applies the person-table rules to each connection the walk takes.  Here
the work is split in two:

1. The walk runs as one kernel over every (image, limb) row
   (:func:`candidate_walk`: ``csrc/walk.cu`` on the card, its plain
   version on the CPU) and returns the (N, L, M) selection flags.  This
   is exact: whether a candidate is taken depends only on the used-masks
   and ``limit``, never on the person table.
2. The person-table rules (``process`` of the JAX package: spawn, one,
   merge; compete only when ``remove_recon > 0``) run over the selected
   connections in limb order, then rank order, as branch-free PyTorch
   over the image axis: every branch is computed and ``torch.where``
   keeps the one each image takes.  Round r of limb l handles each
   image's r-th selected connection of that limb, so the loop runs
   ``max over images of the selection count`` rounds per limb; those
   counts are the single device->host read of a call.

The arithmetic is fp32 in the JAX package's order, with the same
``AssemblyResult`` fields and overflow flags.  Peaks are identified by
the flat slot id ``channel * K + slot``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .. import use_kernel
from .cuda_assembly import candidate_walk_kernel, candidate_walk_plain
from .peaks import LimbCandidates, TopKPeaks


class AssemblyResult(NamedTuple):
    """Fixed-capacity assembled-person tables, one per image.

    ``subset`` is (N, P_max, num_parts+2, 2) float32 in ``find_people``'s
    row layout: per part [flat peak id ``c*K+slot`` or -1, confidence];
    row -2 = [total score, -1]; row -1 = [part count, longest limb].
    Only rows with ``mask`` are people."""
    subset: torch.Tensor           # (N, P, num_parts + 2, 2) float32
    mask: torch.Tensor             # (N, P) bool -- pruned-in people
    n_people: torch.Tensor         # (N,) int32
    peak_overflow: torch.Tensor    # (N,) bool -- a channel's count > K
    cand_overflow: torch.Tensor    # (N,) bool -- a limb's count > M
    person_overflow: torch.Tensor  # (N,) bool -- table hit p_max


def candidate_walk(slot_a: torch.Tensor, slot_b: torch.Tensor,
                   valid: torch.Tensor, limit: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(..., M) int32 flags of the per-limb one-to-one candidate walk:
    ``csrc/walk.cu`` on a CUDA tensor, its plain version on a CPU one."""
    fn = (candidate_walk_kernel if use_kernel(slot_a)
          else candidate_walk_plain)
    return fn(slot_a, slot_b, valid, limit, k)


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


def greedy_assemble(peaks: TopKPeaks, cands: LimbCandidates, *,
                    limbs_from: Sequence[int], limbs_to: Sequence[int],
                    num_parts: int, p_max: int, len_rate: float,
                    connection_tole: float, remove_recon: int,
                    min_parts: int, min_mean_score: float) -> AssemblyResult:
    """Greedy person assembly over (N, C, K) peaks and (N, L, M) rank-
    ordered candidates (see the module docstring); ``p_max`` is the
    person-table capacity."""
    f32 = torch.float32
    n, c, k = peaks.valid.shape
    _, n_limbs, m_cap = cands.valid.shape
    dev = peaks.valid.device
    la = torch.as_tensor(limbs_from, device=dev)
    lb = torch.as_tensor(limbs_to, device=dev)
    n_peaks = torch.clamp(peaks.count, max=k)         # true counts, capped
    limit = torch.minimum(n_peaks[:, la], n_peaks[:, lb])     # (N, L)
    pscore = peaks.score.to(f32).reshape(n, c * k)    # flat-id score lookup

    sel = candidate_walk(cands.slot_a, cands.slot_b, cands.valid, limit,
                         k).bool()                             # (N, L, M)
    # each (image, limb)'s selected ranks first, in rank order
    ranks = torch.arange(m_cap, device=dev)
    order = torch.sort(torch.where(sel, ranks, m_cap), dim=-1).values
    order = order.clamp(max=m_cap - 1)
    n_sel = sel.sum(dim=-1)                                    # (N, L)
    rounds = n_sel.amax(dim=0).tolist()  # the one device->host read

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
    return AssemblyResult(
        subset=subset, mask=mask,
        n_people=mask.sum(dim=1, dtype=torch.int32),
        peak_overflow=(peaks.count > k).any(dim=1),
        cand_overflow=(cands.count > m_cap).any(dim=1),
        person_overflow=st["overflow"])
