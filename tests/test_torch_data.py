"""Port parity: the host input pipeline (``improved_body_parts_torch.data``)
gives the JAX package's arrays bit for bit on the same seed.

- ``build_fixture`` writes the same HDF5 records (record JSON, metadata,
  images, masks) in both packages;
- ``Transformer.transform`` (augmented draws, f32 and uint8 wires) and
  ``Heatmapper.create_heatmaps`` are equal;
- ``CocoPoseDataset.sample`` on both wires and ``batches(pipeline=
  "sync")`` over two epochs are equal.
"""
import h5py
import numpy as np
import pytest

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data import fixture as tfix
from improved_body_parts_torch.data.heatmapper import Heatmapper as THeat
from improved_body_parts_torch.data.transformer import Transformer as TTrans
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.data import dataset as jds
from improved_body_parts_tpu.data import fixture as jfix
from improved_body_parts_tpu.data.heatmapper import Heatmapper as JHeat
from improved_body_parts_tpu.data.transformer import Transformer as JTrans

KW = dict(num_images=3, img_size=(120, 160), people_per_image=2,
          image_size=128, seed=3, drawn=True, crowd=True)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixtures")
    tpath, jpath = str(d / "torch.h5"), str(d / "jax.h5")
    n_t = tfix.build_fixture(tpath, **KW)
    n_j = jfix.build_fixture(jpath, **KW)
    assert n_t == n_j >= 4
    return tpath, jpath


def _walk(f):
    out = {}
    f.visititems(lambda name, obj: out.setdefault(name, obj)
                 if isinstance(obj, h5py.Dataset) else None)
    return out


def test_build_fixture_writes_the_same_records(fixtures):
    tpath, jpath = fixtures
    with h5py.File(tpath, "r") as ft, h5py.File(jpath, "r") as fj:
        t, j = _walk(ft), _walk(fj)
        assert sorted(t) == sorted(j)
        for name in t:
            a, b = t[name][()], j[name][()]
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
            assert dict(t[name].attrs) == dict(j[name].attrs), name


def _configs():
    return tconfig.get_config("tiny"), jconfig.get_config("tiny")


@pytest.mark.parametrize("wire", ["f32", "uint8"])
def test_transform_and_heatmaps_equal(fixtures, wire):
    tcfg, jcfg = _configs()
    raw = jds.CocoPoseDataset(fixtures[1], jcfg).read_raw(0)
    tt, jt = TTrans(tcfg.skeleton), JTrans(jcfg.skeleton)
    for seed in range(4):
        got = tt.transform(*raw, rng=np.random.default_rng(seed), wire=wire)
        want = jt.transform(*raw, rng=np.random.default_rng(seed), wire=wire)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        heat_t = THeat(tcfg.skeleton).create_heatmaps(got[3], got[2])
        heat_j = JHeat(jcfg.skeleton).create_heatmaps(want[3], want[2])
        np.testing.assert_array_equal(heat_t, heat_j)
        assert heat_t.max() > 0.5


@pytest.mark.parametrize("wire", ["f32", "uint8"])
def test_dataset_sample_equal(fixtures, wire):
    tcfg, jcfg = _configs()
    tset = tds.CocoPoseDataset(fixtures[0], tcfg, seed=7)
    jset = jds.CocoPoseDataset(fixtures[1], jcfg, seed=7)
    assert len(tset) == len(jset)
    for i in range(len(tset)):
        for a, b in zip(tset.sample(i, 1, wire=wire),
                        jset.sample(i, 1, wire=wire)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    tset.close()
    jset.close()


def test_sync_batches_equal_over_two_epochs(fixtures):
    tcfg, jcfg = _configs()
    tset = tds.CocoPoseDataset(fixtures[0], tcfg, seed=1)
    jset = jds.CocoPoseDataset(fixtures[1], jcfg, seed=1)
    for epoch in (0, 1):
        got = list(tds.batches(tset, 2, epoch, pipeline="sync",
                               wire="uint8"))
        want = list(jds.batches(jset, 2, epoch, pipeline="sync",
                                wire="uint8"))
        assert len(got) == len(want) >= 2
        for gb, wb in zip(got, want):
            for a, b in zip(gb, wb):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(tds.batches(tset, 2, 0, pipeline="pool"))
