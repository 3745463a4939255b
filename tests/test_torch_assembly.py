"""Port parity: the candidate walk and greedy assembly (``ops.assembly``).

The walk of the plain assembly (``candidate_walk_plain``) must equal the
JAX package's host reference walk and its Pallas kernel in interpreter
mode exactly, on randomized prefix-valid candidate sets drawn as
``ops/pallas_assembly.py`` ``walk_parity_benchmark`` draws them.

``greedy_assemble`` is held to the JAX package's on the
``tests/test_assembly.py`` random-record fixtures, batched: person table,
prune mask and flags within 1e-4 (both sides accumulate in fp32 in the
same order; the tolerance is the one that suite documents).  So is
``greedy_assemble_plain`` at the serve lane's sizes (K = 64, M = 128, 30
limbs, p_max 32 and 1), the reference ``chip_smoke.py`` holds the fused
kernel (``csrc/assembly.cu``) to on the card.  The kernel's wrapper is
checked here only for what it refuses: CPU tensors, sizes past its
limits and inputs whose shapes do not match.
"""
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_tpu.ops.pallas_assembly import (
    candidate_walk_pallas,
    candidate_walk_reference,
)
from improved_body_parts_torch.ops import assembly as tasm
from improved_body_parts_torch.ops import cuda_assembly as tcasm
from improved_body_parts_torch.ops import peaks as tpeaks

sys.path.insert(0, "tests")
from test_assembly import LIMBS_FROM, LIMBS_TO, PARAMS, SK  # noqa: E402
from test_assembly import _rand_records  # noqa: E402


def _walk_fixture(rng, n_limbs, m_cap, k):
    """One randomized walk input, drawn as walk_parity_benchmark does."""
    slot_a = rng.integers(0, k, (n_limbs, m_cap)).astype(np.int32)
    slot_b = rng.integers(0, k, (n_limbs, m_cap)).astype(np.int32)
    counts = rng.integers(0, m_cap + 1, n_limbs)
    valid = np.arange(m_cap)[None, :] < counts[:, None]
    limit = rng.integers(0, k + 1, n_limbs).astype(np.int32)
    return slot_a, slot_b, valid, limit


@pytest.mark.parametrize("n_limbs,m_cap,k", [(8, 32, 16), (30, 128, 64)])
def test_candidate_walk_matches_reference_and_pallas(n_limbs, m_cap, k):
    rng = np.random.default_rng(0)
    batch = [_walk_fixture(rng, n_limbs, m_cap, k) for _ in range(3)]
    got = tcasm.candidate_walk_plain(
        *[torch.from_numpy(np.stack(f)) for f in zip(*batch)], k).numpy()
    assert got.dtype == np.int32 and got.shape == (3, n_limbs, m_cap)
    for i, fixture in enumerate(batch):
        np.testing.assert_array_equal(got[i],
                                      candidate_walk_reference(*fixture))
        if n_limbs == 8:  # the interpreter is slow; one size suffices
            np.testing.assert_array_equal(
                got[i], np.asarray(candidate_walk_pallas(
                    *fixture, k, interpret=True)))
    assert got.any()


def _jax_assemble(pk, cd, p_max, params):
    import jax.numpy as jnp

    from improved_body_parts_tpu.ops.assembly import greedy_assemble
    from improved_body_parts_tpu.ops.peaks import LimbCandidates, TopKPeaks

    res = greedy_assemble(
        TopKPeaks(*[jnp.asarray(a) for a in pk]),
        LimbCandidates(*[jnp.asarray(a) for a in cd]),
        limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO, num_parts=SK.num_parts,
        p_max=p_max, len_rate=params.len_rate,
        connection_tole=params.connection_tole,
        remove_recon=params.remove_recon, min_parts=params.min_parts,
        min_mean_score=params.min_mean_score)
    return [np.asarray(a) for a in res]


def _port_assemble(records, p_max, params):
    pk = tpeaks.TopKPeaks(*[torch.from_numpy(np.stack(f))
                            for f in zip(*[r[0] for r in records])])
    cd = tpeaks.LimbCandidates(*[torch.from_numpy(np.stack(f))
                                 for f in zip(*[r[1] for r in records])])
    res = tasm.greedy_assemble(
        pk, cd, limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO,
        num_parts=SK.num_parts, p_max=p_max, len_rate=params.len_rate,
        connection_tole=params.connection_tole,
        remove_recon=params.remove_recon, min_parts=params.min_parts,
        min_mean_score=params.min_mean_score)
    return [t.numpy() for t in res]


def _assert_same_tables(records, p_max, params):
    got = _port_assemble(records, p_max, params)
    for i, (pk, cd) in enumerate(records):
        want = _jax_assemble(pk, cd, p_max, params)
        for name, w, g in zip(tasm.AssemblyResult._fields, want, got):
            np.testing.assert_allclose(g[i].astype(np.float64),
                                       w.astype(np.float64), atol=1e-4,
                                       err_msg=f"image {i} {name}")
    return got


@pytest.mark.parametrize("remove_recon", [0, 1])
def test_greedy_assemble_matches_jax(remove_recon):
    """Crowded random records exercise spawn, assign, replace, rescore,
    merge (and compete at remove_recon=1) and the prune."""
    import dataclasses

    params = dataclasses.replace(PARAMS, remove_recon=remove_recon)
    rng = np.random.default_rng(0)
    records = [_rand_records(rng) for _ in range(6)]
    got = _assert_same_tables(records, 64, params)
    assert got[1].any()  # people were assembled


def test_greedy_assemble_overflow_flags():
    """Each capacity condition sets its flag in its own image only, and the
    person table never grows past p_max."""
    rng = np.random.default_rng(1)
    (pk, cd), other = _rand_records(rng), _rand_records(rng)
    k, m = pk.valid.shape[1], cd.valid.shape[1]
    records = [(pk._replace(count=pk.count + k), cd),
               (pk, cd._replace(count=cd.count + m)), other]
    mask, _, peak_of, cand_of, person_of = _assert_same_tables(
        records, 64, PARAMS)[1:]
    assert peak_of.tolist() == [True, False, False]
    assert cand_of.tolist() == [False, True, False]
    assert not person_of.any()
    mask, _, _, _, person_of = _assert_same_tables(records, 1, PARAMS)[1:]
    assert mask.sum(axis=1).max() <= 1 and person_of.any()


def _lane_records(rng, k=64, m=128):
    """Random records at the serve lane's sizes, drawn as ``_rand_records``
    draws them (candidates point only at valid peaks, rank-descending,
    prefix-valid) but dense: every channel keeps 40..64 of its 64 slots,
    and a limb's candidates fill all M slots in about half the limbs."""
    from improved_body_parts_tpu.ops.peaks import LimbCandidates, TopKPeaks

    c, n_limbs = SK.num_parts, len(SK.limbs_conn)
    counts = rng.integers(40, k + 1, c).astype(np.int32)
    valid = np.zeros((c, k), bool)
    for ch in range(c):
        valid[ch, rng.permutation(k)[:counts[ch]]] = True
    flat = np.stack([rng.permutation(400 * 400)[:k] for _ in range(c)])
    xs, ys = (flat % 400).astype(np.int32), (flat // 400).astype(np.int32)
    x_ref = (xs + rng.uniform(-.4, .4, (c, k))).astype(np.float32)
    y_ref = (ys + rng.uniform(-.4, .4, (c, k))).astype(np.float32)
    score = rng.uniform(0.1, 1.0, (c, k)).astype(np.float32)
    pk = TopKPeaks(xs, ys, x_ref, y_ref, score, valid, counts)
    slot_a, slot_b = (np.zeros((n_limbs, m), np.int32) for _ in range(2))
    prior, norm = (np.zeros((n_limbs, m), np.float32) for _ in range(2))
    cvalid = np.zeros((n_limbs, m), bool)
    ccount = np.zeros((n_limbs,), np.int32)
    for li, (ia, ib) in enumerate(SK.limbs_conn):
        pairs = [(a, b) for a in np.nonzero(valid[ia])[0]
                 for b in np.nonzero(valid[ib])[0]]
        rng.shuffle(pairs)
        n = m if rng.uniform() < 0.5 else int(rng.integers(0, m + 1))
        pr = np.sort(rng.uniform(0.05, 2.0, n).astype(np.float32))[::-1]
        for i, (a, b) in enumerate(pairs[:n]):
            slot_a[li, i], slot_b[li, i] = a, b
            prior[li, i] = pr[i]
            norm[li, i] = np.float32(np.hypot(
                x_ref[ia, a] - x_ref[ib, b], y_ref[ia, a] - y_ref[ib, b]))
        cvalid[li, :n] = True
        ccount[li] = len(pairs)
    return pk, LimbCandidates(slot_a, slot_b, prior, norm, cvalid, ccount)


@pytest.mark.parametrize("p_max", [32, 1])
def test_greedy_assemble_plain_matches_jax_at_lane_sizes(p_max):
    """The plain version, which the fused kernel is held to on the card,
    equals the JAX package's greedy_assemble at the serve lane's sizes;
    p_max 1 fills the table and sets person_overflow."""
    rng = np.random.default_rng(7)
    records = [_lane_records(rng) for _ in range(2)]
    assert all(cd.valid.all(axis=1).any() for _, cd in records)
    got = _assert_same_tables(records, p_max, PARAMS)
    assert got[1].any()
    if p_max == 1:
        assert got[5].all()


def test_greedy_assemble_routes_cpu_tensors_to_the_plain_version(
        monkeypatch):
    """On CPU tensors the public op runs greedy_assemble_plain and never
    reaches the kernel's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(tasm, "greedy_assemble_kernel", refuse)
    rng = np.random.default_rng(3)
    records = [_rand_records(rng) for _ in range(2)]
    got = _port_assemble(records, 16, PARAMS)
    pk = tpeaks.TopKPeaks(*[torch.from_numpy(np.stack(f))
                            for f in zip(*[r[0] for r in records])])
    cd = tpeaks.LimbCandidates(*[torch.from_numpy(np.stack(f))
                                 for f in zip(*[r[1] for r in records])])
    want = tcasm.greedy_assemble_plain(
        pk, cd, limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO,
        num_parts=SK.num_parts, p_max=16, len_rate=PARAMS.len_rate,
        connection_tole=PARAMS.connection_tole,
        remove_recon=PARAMS.remove_recon, min_parts=PARAMS.min_parts,
        min_mean_score=PARAMS.min_mean_score)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def _meta_inputs(n=2, c=18, k=64, n_limbs=30, m=128, **bad):
    """Meta-device peaks and candidates of the given sizes (no memory);
    ``bad`` replaces one field's shape."""
    def t(shape, dtype):
        return torch.empty(shape, device="meta", dtype=dtype)

    pk_shapes = dict(score=(n, c, k), count=(n, c))
    cd_shapes = dict(slot_a=(n, n_limbs, m), slot_b=(n, n_limbs, m),
                     prior=(n, n_limbs, m), norm=(n, n_limbs, m),
                     valid=(n, n_limbs, m), ccount=(n, n_limbs))
    pk_shapes.update({f: s for f, s in bad.items() if f in pk_shapes})
    cd_shapes.update({f: s for f, s in bad.items() if f in cd_shapes})
    i32, f32 = torch.int32, torch.float32
    pk = tpeaks.TopKPeaks(t((n, c, k), i32), t((n, c, k), i32),
                          t((n, c, k), f32), t((n, c, k), f32),
                          t(pk_shapes["score"], f32), t((n, c, k), torch.bool),
                          t(pk_shapes["count"], i32))
    cd = tpeaks.LimbCandidates(
        t(cd_shapes["slot_a"], i32), t(cd_shapes["slot_b"], i32),
        t(cd_shapes["prior"], f32), t(cd_shapes["norm"], f32),
        t(cd_shapes["valid"], torch.bool), t(cd_shapes["ccount"], i32))
    return pk, cd


@pytest.mark.parametrize("sizes,kw,match", [
    (dict(), dict(p_max=129), "limits"),
    (dict(), dict(num_parts=33), "limits"),
    (dict(k=1025), dict(), "limits"),
    (dict(m=1025), dict(), "limits"),
    (dict(m=1024), dict(), "shared memory"),
    (dict(slot_b=(2, 30, 64)), dict(), "slot_b"),
    (dict(ccount=(2, 29)), dict(), "count"),
    (dict(count=(2, 17)), dict(), "count"),
    (dict(n_limbs=29), dict(), "one \\(from, to\\) pair"),
])
def test_greedy_assemble_kernel_refuses_what_it_cannot_take(sizes, kw,
                                                            match):
    """The wrapper raises before any launch on sizes past the kernel's
    limits (p_max 128, 32 parts, K and M 1024, 227 KB of shared memory an
    image) and on inputs whose shapes do not match; the serve lane's own
    sizes pass these checks and stop only at the device check."""
    base = dict(limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO,
                num_parts=SK.num_parts, p_max=32, len_rate=PARAMS.len_rate,
                connection_tole=PARAMS.connection_tole,
                remove_recon=PARAMS.remove_recon, min_parts=PARAMS.min_parts,
                min_mean_score=PARAMS.min_mean_score)
    with pytest.raises(ValueError, match="CUDA"):
        tcasm.greedy_assemble_kernel(*_meta_inputs(), **base)
    with pytest.raises(ValueError, match=match):
        tcasm.greedy_assemble_kernel(*_meta_inputs(**sizes),
                                     **dict(base, **kw))
    assert tcasm.greedy_assemble_kernel.launches == 0
