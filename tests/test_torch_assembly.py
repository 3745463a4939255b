"""Port parity: the candidate walk and greedy assembly (``ops.assembly``).

The walk's plain version (what the port runs on the CPU) must equal the
JAX package's host reference walk and its Pallas kernel in interpreter
mode exactly, on randomized prefix-valid candidate sets drawn as
``ops/pallas_assembly.py`` ``walk_parity_benchmark`` draws them.

``greedy_assemble`` is held to the JAX package's on the
``tests/test_assembly.py`` random-record fixtures, batched: person table,
prune mask and flags within 1e-4 (both sides accumulate in fp32 in the
same order; the tolerance is the one that suite documents).
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
    got = tasm.candidate_walk(
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
