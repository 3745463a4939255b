"""Port parity of the host decoder: ``improved_body_parts_torch.infer.decode``
and ``infer.native`` against the JAX package's.

Both sides are NumPy (or the same C++ source, ``native/decoder.cpp``,
built by each package into its own library), so every result must be
EQUAL: peak lists, connections, person tables, decoded people, compact
re-decodes (NumPy and native assembly), the escalation signals, and the
exceptions on over-capacity and corrupt compact records.  Inputs are the
JAX package's own fixtures: planted people from ``tests/test_decode.py``
(full-resolution maps) and compact / fused records fetched from the JAX
``Predictor`` on the stub network of ``tests/test_serve.py``.
"""
import dataclasses
import importlib
import sys
import warnings

import numpy as np
import pytest

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.infer import native as tnative
from improved_body_parts_torch.ops.peaks import LimbCandidates, TopKPeaks

# the modules, not the packages' ``decode`` functions of the same name
tdec = importlib.import_module("improved_body_parts_torch.infer.decode")
jdec = importlib.import_module("improved_body_parts_tpu.infer.decode")

sys.path.insert(0, "tests")
from test_decode import PARAMS as JPARAMS  # noqa: E402
from test_decode import SK as JSK  # noqa: E402
from test_decode import synth_maps, synth_person_joints  # noqa: E402

TSK = tconfig.get_config("canonical").skeleton
TPARAMS, _ = tconfig.default_inference_params()


def _scene(seed, n_people):
    """(heat, paf) full-resolution maps of ``n_people`` planted people
    (the crowd sweep of ``tests/test_native_decoder.py``)."""
    rng = np.random.default_rng(seed)
    people = [synth_person_joints(rng.uniform(20, JSK.width - 180),
                                  rng.uniform(20, JSK.height - 280),
                                  rng.uniform(200, 320))
              for _ in range(n_people)]
    return synth_maps(people)


SCENES = [(0, 1), (1, 2), (2, 3), (3, 4), (9, 5)]


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _assert_people_equal(got, want):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(got, want):
        assert gs == ws
        assert gk == wk


@pytest.fixture(scope="module")
def native_built():
    reason = tnative.ensure_built()
    if reason or not tnative.native_available():
        pytest.skip(f"the port's native decoder is not available: {reason}")
    from improved_body_parts_tpu.infer.native import (
        ensure_built,
        native_available,
    )

    reason = ensure_built()
    if reason or not native_available():
        pytest.skip(f"the JAX package's native decoder: {reason}")


@pytest.mark.parametrize("seed,n_people", SCENES)
def test_find_peaks_connections_people_equal(seed, n_people):
    heat, paf = _scene(seed, n_people)
    jpeaks = jdec.find_peaks(heat, JPARAMS, JSK.num_parts)
    tpeaks = tdec.find_peaks(heat, TPARAMS, TSK.num_parts)
    _assert_arrays_equal(tpeaks, jpeaks)
    assert sum(len(p) for p in tpeaks) >= 18

    size = heat.shape[0]
    jconn, jspecial = jdec.find_connections(jpeaks, paf, size, JPARAMS,
                                            JSK.limbs_conn)
    tconn, tspecial = tdec.find_connections(tpeaks, paf, size, TPARAMS,
                                            TSK.limbs_conn)
    _assert_arrays_equal(tconn, jconn)
    assert tspecial == jspecial

    jsub, jcand = jdec.find_people(jconn, jspecial, jpeaks, JPARAMS,
                                   JSK.limbs_conn, JSK.num_parts)
    tsub, tcand = tdec.find_people(tconn, tspecial, tpeaks, TPARAMS,
                                   TSK.limbs_conn, TSK.num_parts)
    np.testing.assert_array_equal(tsub, jsub)
    np.testing.assert_array_equal(tcand, jcand)
    assert len(tsub) >= 1


def test_find_peaks_with_precomputed_mask():
    heat, _ = _scene(4, 2)
    mask = jdec.peak_mask_np(heat[..., :JSK.num_parts].astype(np.float32),
                             thre=0.3)
    _assert_arrays_equal(
        tdec.find_peaks(heat, TPARAMS, TSK.num_parts, peak_mask=mask),
        jdec.find_peaks(heat, JPARAMS, JSK.num_parts, peak_mask=mask))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("seed,n_people", SCENES[:3])
def test_decode_equal(seed, n_people, use_native, request):
    if use_native:
        request.getfixturevalue("native_built")
    heat, paf = _scene(seed, n_people)
    scale = (1.25, 0.75)
    want = jdec.decode(heat, paf, JPARAMS, JSK, use_native=use_native,
                       coord_scale=scale)
    got = tdec.decode(heat, paf, TPARAMS, TSK, use_native=use_native,
                      coord_scale=scale)
    assert len(got) >= 1
    _assert_people_equal(got, want)


@pytest.mark.parametrize("seed,n_people", SCENES)
def test_port_native_matches_port_numpy(seed, n_people, native_built):
    """The port's two host paths agree (tolerances of
    tests/test_native_decoder.py: the C++ samples the paf in float32)."""
    heat, paf = _scene(seed, n_people)
    peaks = tdec.find_peaks(heat, TPARAMS, TSK.num_parts)
    conns, special = tdec.find_connections(peaks, paf, heat.shape[0],
                                           TPARAMS, TSK.limbs_conn)
    sub_np, cand_np = tdec.find_people(conns, special, peaks, TPARAMS,
                                       TSK.limbs_conn, TSK.num_parts)
    sub_cc, cand_cc = tnative.native_find_connections_people(
        peaks, paf.astype(np.float32), heat.shape[0], TPARAMS,
        TSK.limbs_conn, TSK.num_parts)
    np.testing.assert_array_equal(cand_np, cand_cc)
    np.testing.assert_array_equal(sub_np[:, :TSK.num_parts, 0],
                                  sub_cc[:, :TSK.num_parts, 0])
    np.testing.assert_allclose(sub_np[:, :TSK.num_parts, 1],
                               sub_cc[:, :TSK.num_parts, 1], atol=1e-5)
    np.testing.assert_allclose(sub_np[:, TSK.num_parts:, :],
                               sub_cc[:, TSK.num_parts:, :], atol=1e-4)


def test_native_build_failure_falls_back_to_numpy(monkeypatch, tmp_path):
    """A failed build warns and leaves decoding on the NumPy path."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_TRIED", False)
    monkeypatch.setenv("CXX", "false")
    with pytest.warns(RuntimeWarning, match="build failed"):
        assert not tnative.native_available()
    assert not list((tmp_path / "_build").glob("*"))
    heat, paf = _scene(1, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tdec.decode(heat, paf, TPARAMS, TSK, use_native=True)
    _assert_people_equal(got, jdec.decode(heat, paf, JPARAMS, JSK,
                                          use_native=False))


# ------------------------------------------------------------------ #
# compact and fused records from the JAX predictor                    #
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def jax_records():
    """{name: (JAX CompactResult, JAX DeviceDecoded)} on the planted
    person of tests/test_serve.py, at two input sizes (two coordinate
    scales), and at top-K 1 (peak overflow)."""
    from test_serve import SIZE_A, SIZE_B, _make_pred, _person_maps

    maps = _person_maps()
    out = {}
    for name, size, kw in (("a", SIZE_A, {}), ("b", SIZE_B, {}),
                           ("topk1", SIZE_A, dict(compact_topk=1))):
        pred = _make_pred(maps, **kw)
        img = np.zeros((*size, 3), np.uint8)
        out[name] = (pred.predict_compact(img), pred.predict_decoded(img))
    return out


def _port_compact(res):
    """The JAX CompactResult's arrays in the port's record types."""
    return tdec.CompactResult(
        peaks=TopKPeaks(*(np.array(a) for a in res.peaks)),
        stats=LimbCandidates(*(np.array(a) for a in res.stats)),
        image_size=res.image_size, coord_scale=res.coord_scale)


def _port_decoded(dev):
    return tdec.DeviceDecoded(
        subset=np.array(dev.subset), mask=np.array(dev.mask),
        n_people=dev.n_people, peak_overflow=dev.peak_overflow,
        cand_overflow=dev.cand_overflow,
        person_overflow=dev.person_overflow,
        compact=_port_compact(dev.compact))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("name", ["a", "b"])
def test_decode_compact_equal(jax_records, name, use_native, request):
    if use_native:
        request.getfixturevalue("native_built")
    res, _ = jax_records[name]
    want = jdec.decode_compact(res, JPARAMS, JSK, use_native=use_native)
    got = tdec.decode_compact(_port_compact(res), TPARAMS, TSK,
                              use_native=use_native)
    assert len(got) >= 1
    _assert_people_equal(got, want)


@pytest.mark.parametrize("name", ["a", "b"])
def test_decode_device_and_signals_equal(jax_records, name):
    _, dev = jax_records[name]
    tdev = _port_decoded(dev)
    _assert_people_equal(tdec.decode_device(tdev, TSK),
                         jdec.decode_device(dev, JSK))
    want = jdec.device_signals(dev)
    got = tdec.device_signals(tdev)
    assert tuple(got) == tuple(want)
    assert got.fused and got.n_people >= 1


def test_device_signals_overflow_and_empty(jax_records):
    _, dev = jax_records["topk1"]
    tdev = _port_decoded(dev)
    assert tuple(tdec.device_signals(tdev)) == tuple(jdec.device_signals(dev))
    assert not tdec.device_signals(tdev).fused
    empty = dev._replace(mask=np.zeros_like(np.array(dev.mask)))
    tempty = tdev._replace(mask=np.zeros_like(tdev.mask))
    got, want = tdec.device_signals(tempty), jdec.device_signals(empty)
    assert tuple(got) == tuple(want)
    assert got.min_mean_score == float("inf")


def _raises_alike(jres, jexc, texc, match):
    """The JAX package raises ``jexc`` on ``jres`` and the port ``texc``
    on the same records, with the same message."""
    with pytest.raises(jexc, match=match) as jinfo:
        jdec.decode_compact(jres, JPARAMS, JSK, use_native=False)
    with pytest.raises(texc, match=match) as tinfo:
        tdec.decode_compact(_port_compact(jres), TPARAMS, TSK,
                            use_native=False)
    assert str(tinfo.value) == str(jinfo.value)


def test_compact_overflow_raised_alike(jax_records):
    res, _ = jax_records["topk1"]
    assert (np.array(res.peaks.count) > 1).any()
    _raises_alike(res, jdec.CompactOverflow, tdec.CompactOverflow,
                  "top-K capacity")

    res, _ = jax_records["a"]
    count = np.array(res.stats.count)
    count[3] = res.stats.valid.shape[1] + 1
    over = res._replace(stats=res.stats._replace(count=count))
    _raises_alike(over, jdec.CompactOverflow, tdec.CompactOverflow,
                  "candidate capacity")


def test_corrupt_slot_raised_alike(jax_records):
    res, _ = jax_records["a"]
    cd, pk = res.stats, res.peaks
    valid = np.array(pk.valid)
    for k, (ia, _ib) in enumerate(JSK.limbs_conn):
        slots = np.nonzero(np.array(cd.valid)[k])[0]
        free = np.nonzero(~valid[ia])[0]
        if slots.size and free.size:
            break
    else:
        pytest.fail("no corruptible limb candidate in the fixture")
    for value, match in ((free[0], "invalid peak"), (-1, "out of range")):
        slot_a = np.array(cd.slot_a)
        slot_a[k, slots[0]] = value
        bad = res._replace(stats=cd._replace(slot_a=slot_a))
        _raises_alike(bad, RuntimeError, RuntimeError, match)


def test_escalation_signals_fields_match():
    assert tdec.EscalationSignals._fields == jdec.EscalationSignals._fields
    assert [f.name for f in dataclasses.fields(TPARAMS)] == [
        f.name for f in dataclasses.fields(JPARAMS)]
