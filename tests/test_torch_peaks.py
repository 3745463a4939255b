"""Port parity: peak top-K and dense limb sampling (``ops.peaks``).

The same seeded numpy inputs go through the JAX package's XLA functions
(``ops.peaks``), its Pallas twins in interpreter mode
(``ops.pallas_peaks``) and the port's functions on CPU tensors, which run
the plain PyTorch versions of the port's CUDA kernels.  The port is
batched over a leading image axis, the JAX functions are per image.

Tolerances: integer fields (xs, ys, valid, count, above, num_samples and
the candidate slots) exactly; the refinement's 25-term sums run in
another order, so x_ref / y_ref / score within 1e-5; norm and mean within
1e-6 relative.
"""
import numpy as np
import pytest
import torch

from improved_body_parts_tpu.config import get_config
from improved_body_parts_tpu.ops import peaks as jpeaks
from improved_body_parts_tpu.ops.pallas_peaks import (
    _rand_peaks_fixture,
    limb_pair_stats_pallas,
    topk_peaks_pallas,
)
from improved_body_parts_torch.ops import nms as tnms
from improved_body_parts_torch.ops import peaks as tpeaks

SK = get_config("canonical").skeleton
LIMBS_FROM = tuple(a for a, _ in SK.limbs_conn)
LIMBS_TO = tuple(b for _, b in SK.limbs_conn)
INT_FIELDS = {"xs", "ys", "valid", "count", "above", "num_samples",
              "slot_a", "slot_b"}


def _assert_close(want, got, float_tol, rtol=0.0):
    """``want``: a per-image JAX record; ``got``: the port's record of the
    same image (torch tensors)."""
    for name, a, b in zip(want._fields, want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=float_tol, rtol=rtol,
                                       err_msg=name)


def _image(rec, i):
    return type(rec)(*[t[i] for t in rec])


def _heat_batch(seed, h, w, c, n=2):
    rng = np.random.default_rng(seed)
    heat = np.stack([_rand_peaks_fixture(rng, h, w, c) for _ in range(n)])
    vh = rng.integers(h // 2, h + 1, n)
    vw = rng.integers(w // 2, w + 1, n)
    vh[0], vw[0] = h, w  # one image fills its bucket
    return heat, vh, vw


@pytest.mark.parametrize("seed,h,w,k", [(7, 64, 56, 16), (8, 48, 72, 8)])
def test_topk_peaks_matches_xla_and_pallas(seed, h, w, k):
    heat, vh, vw = _heat_batch(seed, h, w, SK.num_parts)
    got = tpeaks.topk_peaks(torch.from_numpy(heat), torch.from_numpy(vh),
                            torch.from_numpy(vw), thre=0.1, k=k, radius=2)
    for i in range(len(heat)):
        want = jpeaks.topk_peaks(heat[i], int(vh[i]), int(vw[i]), thre=0.1,
                                 k=k, radius=2)
        _assert_close(want, _image(got, i), 1e-5)
        pallas = topk_peaks_pallas(heat[i], int(vh[i]), int(vw[i]),
                                   thre=0.1, k=k, radius=2, interpret=True)
        _assert_close(pallas, _image(got, i), 1e-5)


def test_topk_peaks_exact_ties_order_by_index():
    """Equal-valued isolated peaks: top-K must order them by ascending
    flat index (lax.top_k), which torch.topk does not guarantee."""
    h, w, c, k = 32, 32, 3, 8
    heat = np.zeros((1, h, w, c), np.float32)
    for ci in range(c):
        for i, (y, x) in enumerate([(4, 4), (4, 20), (20, 4), (20, 20),
                                    (12, 12)]):
            heat[0, y, x, ci] = 0.5 if i < 4 else 0.9
    full = torch.tensor([h])
    got = tpeaks.topk_peaks(torch.from_numpy(heat), full, torch.tensor([w]),
                            thre=0.1, k=k, radius=2)
    want = jpeaks.topk_peaks(heat[0], h, w, thre=0.1, k=k, radius=2)
    _assert_close(want, _image(got, 0), 1e-5)
    assert got.xs[0, 0].tolist()[:5] == [12, 4, 20, 4, 20]


SERVE_K, SERVE_R, SERVE_S = 64, 2, 20  # the kernels' compile-time sizes


@pytest.mark.parametrize("dense", [False, True])
def test_topk_peaks_at_kernel_sizes_matches_xla_and_pallas(dense):
    """The plain version at the serve lane's C = 18, K = 64, r = 2 on
    small maps.  Dense uniform noise keeps about a ninth of the pixels, so
    every channel keeps more than K (the kernel's in-band sort); sparse
    spikes above the noise keep fewer than K (the -1e9 fill)."""
    n, h, w = 2, 96, 128
    rng = np.random.default_rng(21 + dense)
    if dense:
        heat = rng.random((n, h, w, SK.num_parts), dtype=np.float32)
    else:
        heat = np.stack([_rand_peaks_fixture(rng, h, w, SK.num_parts,
                                             peaky=0.002) for _ in range(n)])
    vh, vw = np.array([h, 80]), np.array([w, 101])
    kw = dict(thre=0.1 if dense else 0.25, k=SERVE_K, radius=SERVE_R)
    got = tpeaks.topk_peaks(torch.from_numpy(heat), torch.from_numpy(vh),
                            torch.from_numpy(vw), **kw)
    if dense:
        assert int(got.count.min()) > SERVE_K
    else:
        assert int(got.count.max()) < SERVE_K  # the -1e9 fill runs
    for i in range(n):
        want = jpeaks.topk_peaks(heat[i], int(vh[i]), int(vw[i]), **kw)
        _assert_close(want, _image(got, i), 1e-5)
        pallas = topk_peaks_pallas(heat[i], int(vh[i]), int(vw[i]),
                                   interpret=True, **kw)
        _assert_close(pallas, _image(got, i), 1e-5)


def test_limb_pair_stats_full_samples_matches_xla_and_pallas():
    """K = 64 endpoints spread over a 96x128 map: almost every segment
    takes all S = 20 samples, the kernel's fully unrolled case."""
    paf, x_ref, y_ref = _limb_inputs(23, 96, 128, SERVE_K)
    kw = dict(limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO,
              num_samples=SERVE_S, thre2=0.05)
    got = tpeaks.limb_pair_stats(torch.from_numpy(paf),
                                 torch.from_numpy(x_ref),
                                 torch.from_numpy(y_ref), **kw)
    assert float((got.num_samples == SERVE_S).float().mean()) > 0.9
    for i in range(len(paf)):
        for want in (jpeaks.limb_pair_stats(paf[i], x_ref[i], y_ref[i], **kw),
                     limb_pair_stats_pallas(paf[i], x_ref[i], y_ref[i],
                                            interpret=True, **kw)):
            _assert_close(want, _image(got, i), 1e-6, rtol=1e-6)


def _limb_inputs(seed, h, w, k, n=2):
    rng = np.random.default_rng(seed)
    paf = rng.normal(0.0, 0.2, (n, h, w, SK.paf_layers)).astype(np.float32)
    x_ref = rng.uniform(0, w - 1, (n, SK.num_parts, k)).astype(np.float32)
    y_ref = rng.uniform(0, h - 1, (n, SK.num_parts, k)).astype(np.float32)
    return paf, x_ref, y_ref


def test_limb_pair_stats_matches_xla_and_pallas():
    paf, x_ref, y_ref = _limb_inputs(11, 64, 56, 16)
    kw = dict(limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO, num_samples=20,
              thre2=0.05)
    got = tpeaks.limb_pair_stats(torch.from_numpy(paf),
                                 torch.from_numpy(x_ref),
                                 torch.from_numpy(y_ref), **kw)
    for i in range(len(paf)):
        for want in (jpeaks.limb_pair_stats(paf[i], x_ref[i], y_ref[i], **kw),
                     limb_pair_stats_pallas(paf[i], x_ref[i], y_ref[i],
                                            interpret=True, **kw)):
            _assert_close(want, _image(got, i), 1e-6, rtol=1e-6)


@pytest.mark.parametrize("m_cap", [32, 400])
def test_limb_topk_from_stats_matches_xla(m_cap):
    """Acceptance + top-M ranking on the same stats; m_cap = 400 > K*K
    exercises the padded tail."""
    heat, vh, vw = _heat_batch(5, 64, 56, SK.num_parts)
    rng = np.random.default_rng(6)
    paf = np.abs(rng.normal(0.3, 0.2, (2, 64, 56, SK.paf_layers))
                 ).astype(np.float32)
    k = 16
    kw = dict(limbs_from=LIMBS_FROM, limbs_to=LIMBS_TO)
    pk = tpeaks.topk_peaks(torch.from_numpy(heat), torch.from_numpy(vh),
                           torch.from_numpy(vw), thre=0.1, k=k, radius=2)
    st = tpeaks.limb_pair_stats(torch.from_numpy(paf), pk.x_ref, pk.y_ref,
                                num_samples=20, thre2=0.1, **kw)
    got = tpeaks.limb_topk_from_stats(st, pk, torch.from_numpy(vh),
                                      connect_ration=0.8, m_cap=m_cap, **kw)
    assert int(got.valid.sum()) > 0
    for i in range(len(heat)):
        want = jpeaks.limb_topk_from_stats(
            jpeaks.PairStats(*[t[i].numpy() for t in st]),
            jpeaks.TopKPeaks(*[t[i].numpy() for t in pk]), int(vh[i]),
            connect_ration=0.8, m_cap=m_cap, **kw)
        _assert_close(want, _image(got, i), 0.0)


def test_host_nms_copies_match():
    """The port's NumPy copies of peak_mask_np / refine_peaks."""
    from improved_body_parts_tpu.ops import nms as jnms

    rng = np.random.default_rng(2)
    heat = _rand_peaks_fixture(rng, 40, 36, 4)
    mask = tnms.peak_mask_np(heat, thre=0.1)
    np.testing.assert_array_equal(mask, jnms.peak_mask_np(heat, thre=0.1))
    ys, xs = np.nonzero(mask[:, :, 0])
    for a, b in zip(tnms.refine_peaks(heat[:, :, 0], xs, ys, 2),
                    jnms.refine_peaks(heat[:, :, 0], xs, ys, 2)):
        np.testing.assert_array_equal(a, b)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the public ops run the plain versions; the kernel
    wrappers themselves take CUDA tensors only (no silent fallback)."""
    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks

    heat = torch.zeros((1, 8, 8, 2))
    one = torch.tensor([8])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_peaks.topk_peaks_kernel(heat, one, one, thre=0.1, k=2,
                                     radius=1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_peaks.limb_pair_stats_kernel(
            heat, torch.zeros((1, 2, 2)), torch.zeros((1, 2, 2)),
            limbs_from=(0, 1), limbs_to=(1, 0), num_samples=4, thre2=0.1)
    n, c, k, n_limbs, m = 1, 2, 4, 1, 8
    pk = tpeaks.TopKPeaks(*[torch.zeros((n, c, k), dtype=dt) for dt in (
        torch.int32, torch.int32, torch.float32, torch.float32,
        torch.float32, torch.bool)], torch.zeros((n, c), dtype=torch.int32))
    cd = tpeaks.LimbCandidates(
        *[torch.zeros((n, n_limbs, m), dtype=dt) for dt in (
            torch.int32, torch.int32, torch.float32, torch.float32,
            torch.bool)], torch.zeros((n, n_limbs), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_assembly.greedy_assemble_kernel(
            pk, cd, limbs_from=(0,), limbs_to=(1,), num_parts=c, p_max=4,
            len_rate=16.0, connection_tole=0.7, remove_recon=0, min_parts=2,
            min_mean_score=0.2)
    assert cuda_peaks.topk_peaks_kernel.launches == 0
    assert cuda_assembly.greedy_assemble_kernel.launches == 0


@pytest.mark.parametrize("shape", [(8, 640, 896, 50), (1, 2, 3, 4)])
def test_kernel_wrappers_check_32bit_offsets(shape):
    """The kernels address the maps with 32-bit offsets: a view past 2^31
    elements is refused before any launch (meta tensors, no memory); the
    serve lane's (8, 640, 896, 50) maps and their slices fit."""
    from improved_body_parts_torch.ops import cuda_peaks

    maps = torch.empty(shape, device="meta")
    cuda_peaks._check_offsets("maps", maps[..., :2])
    per_image = maps[0].numel()
    big = torch.empty((2 ** 31 // per_image + 2,) + shape[1:],
                      device="meta")[..., :2]
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_peaks.topk_peaks_kernel(big, one, one, thre=0.1, k=2, radius=1)
    xy = torch.zeros((1, 2, 2))
    with pytest.raises(ValueError, match="32-bit"):
        cuda_peaks.limb_pair_stats_kernel(
            big, xy, xy, limbs_from=(0, 1), limbs_to=(1, 0), num_samples=4,
            thre2=0.1)
    assert cuda_peaks.topk_peaks_kernel.launches == 0
    assert cuda_peaks.limb_pair_stats_kernel.launches == 0
