"""Port parity of the whole slice: the fused serve lane.

(a) The tiny IMHN on weights converted from a seeded Flax tree: the
    port's ensembled maps (2N-lane flip forward, merge, x4 cubic
    upsample) within 1e-4 of the JAX package's ensemble program.
(b) The JAX package's ensembled maps fed to the port's extraction and
    assembly give the JAX packed payload: integer fields exactly, floats
    within 1e-5.
(c) A stub network returning planted stride-4 people maps (as
    tests/test_assembly.py plants them): ``predict_decoded_batch`` over
    images of three sizes decodes the same people as the JAX
    ``Predictor``, at ``_assert_same_people``'s tolerances (coords 1e-3,
    score 1e-4).

Everything runs on the CPU, where the port's ops run their kernels'
plain versions.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.infer import Predictor, decode_device
from improved_body_parts_torch.models import build_model, load_flax_variables

sys.path.insert(0, "tests")
from test_assembly import SK, _assert_same_people  # noqa: E402
from test_decode import synth_person_joints  # noqa: E402
from test_torch_models import _seeded_flax  # noqa: E402

INT_FIELDS = {"xs", "ys", "valid", "count", "slot_a", "slot_b"}


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX predictor, port predictor) on the same seeded tiny weights."""
    from improved_body_parts_tpu.config import InferenceModelParams
    from improved_body_parts_tpu.infer import Predictor as JPredictor

    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, 128, 128, seed=3)
    mp = InferenceModelParams(boxsize=128, max_downsample=64)
    jpred = JPredictor(jmodel, variables, SK, model_params=mp, bucket=64,
                       compact_topk=16, assembly_pmax=16)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    tmp = tconfig.InferenceModelParams(boxsize=128, max_downsample=64)
    tpred = Predictor(model, SK, model_params=tmp, bucket=64,
                      compact_topk=16, assembly_pmax=16, device="cpu")
    img = np.random.default_rng(4).integers(0, 255, (128, 128, 3),
                                            dtype=np.uint8)
    return jpred, tpred, img.astype(np.float32) / 255.0


def test_ensembled_maps_match_on_converted_weights(tiny_pair):
    jpred, tpred, img = tiny_pair
    want = np.asarray(jpred._ensemble_fn(img.shape[:2])(jpred.variables,
                                                        img))
    got = tpred.ensemble_maps(torch.from_numpy(img[None]))[0].numpy()
    assert got.shape == want.shape == (128, 128, SK.num_layers)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _payload(pred, buf, spec, image_size):
    dev = pred._unpack_decoded(np.asarray(buf, np.float32), spec,
                               image_size, (1.0, 1.0))
    fields = dict(zip(dev.compact.peaks._fields, dev.compact.peaks))
    fields.update({f"cand_{k}" if k != "slot_a" and k != "slot_b" else k: v
                   for k, v in zip(dev.compact.stats._fields,
                                   dev.compact.stats)})
    fields.update(subset=dev.subset, mask=dev.mask,
                  flags=np.array([dev.n_people, dev.peak_overflow,
                                  dev.cand_overflow, dev.person_overflow]))
    return fields


@pytest.mark.parametrize("valid", [(128, 128), (100, 90)])
def test_port_decode_of_jax_maps_gives_the_jax_payload(tiny_pair, valid):
    jpred, tpred, img = tiny_pair
    maps = np.array(jpred._ensemble_fn(img.shape[:2])(jpred.variables,
                                                      img))
    # lift the keypoint channels so the random network's maps hold peaks
    maps[..., SK.paf_layers:] += 0.2
    maps[..., :SK.paf_layers] = np.abs(maps[..., :SK.paf_layers])
    thre1 = jpred.params.thre1
    jspec = jpred._decode_spec(jpred.params)
    want_buf = np.asarray(jpred._decode_extract_fn(thre1, jspec)(
        maps, *valid))
    tspec = tpred._decode_spec(tpred.params)
    got_buf = tpred.decode_maps(torch.from_numpy(maps[None]),
                                torch.tensor([valid[0]]),
                                torch.tensor([valid[1]]), thre1,
                                tspec)[0].numpy()
    assert got_buf.shape == want_buf.shape
    want = _payload(tpred, want_buf, tspec, valid[0])
    got = _payload(tpred, got_buf, tspec, valid[0])
    assert want["valid"].any() and want["cand_valid"].any()
    for name in want:
        if name in INT_FIELDS or want[name].dtype == bool:
            np.testing.assert_array_equal(got[name], want[name], name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=0, err_msg=name)


def _perm(sk):
    """Channel permutation of the mirror lane (paf, then heat + bkg)."""
    return list(sk.flip_paf_ord) + [sk.paf_layers + i
                                    for i in sk.flip_heat_ord]


def _planted_maps(people, h, w, seed=7):
    """Stride-4 GT maps of ``people`` (the JAX package's Heatmapper), with
    1e-3 of noise: the two upsamples agree within 1e-5, not bit for bit,
    so the smooth plateaus of exact GT maps would let an NMS or ranking
    near-tie fall either way."""
    from improved_body_parts_tpu.data.heatmapper import Heatmapper

    small = dataclasses.replace(SK, width=w, height=h)
    joints = np.concatenate(people, axis=0).astype(np.float32)
    maps = Heatmapper(small).create_heatmaps(
        joints, np.ones(small.grid_shape, np.float32))
    noise = np.random.default_rng(seed).uniform(0, 1e-3, maps.shape)
    return (maps + noise).astype(np.float32)


class _JaxMirrorStub:
    """Ignores the image; returns fixed stride-4 maps cropped to the input
    size on the image lanes and their exact mirror (width flip + channel
    permutation) on the mirror lanes, so the flip merge returns the maps
    unchanged: no mirror ghosts, whose exactly tied scores the two
    upsamples (equal within 1e-5, not bit for bit) may order apart."""

    def __init__(self, maps):
        self.maps = maps

    def apply(self, variables, imgs, train=False):
        import jax.numpy as jnp

        n, h, w, _ = imgs.shape
        m = self.maps[:h // 4, :w // 4]
        mirror = m[:, ::-1][..., _perm(SK)]
        lanes = [m] * (n // 2) + [mirror] * (n // 2)
        return [[jnp.asarray(np.stack(lanes))]]


class _TorchMirrorStub(torch.nn.Module):
    """The port's twin of :class:`_JaxMirrorStub`."""

    def __init__(self, maps):
        super().__init__()
        self.maps = torch.from_numpy(maps)

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        m = self.maps[:h // 4, :w // 4]
        mirror = m.flip(1)[..., _perm(SK)]
        return [[torch.stack([m] * (n // 2) + [mirror] * (n // 2))]]


def test_planted_people_batch_decodes_like_jax():
    """Three image sizes, four images: two shape groups, chunks 1 + 2 + 1
    through the pow2 chunking; each image decodes the JAX package's
    people (the 200 px crop cuts the second person in two)."""
    from improved_body_parts_tpu.config import InferenceModelParams
    from improved_body_parts_tpu.infer import Predictor as JPredictor
    from improved_body_parts_tpu.infer import decode_device as jdecode

    maps = _planted_maps([synth_person_joints(40, 40, 180),
                          synth_person_joints(150, 60, 150)], h=256, w=320)
    jpred = JPredictor(_JaxMirrorStub(maps), {}, SK, model_params=(
        InferenceModelParams(boxsize=256, max_downsample=64)), bucket=64)
    tpred = Predictor(_TorchMirrorStub(maps), SK, model_params=(
        tconfig.InferenceModelParams(boxsize=256, max_downsample=64)),
        bucket=64, device="cpu")
    images = [np.zeros((256, w, 3), np.uint8) for w in (320, 256, 200, 256)]
    want = jpred.predict_decoded_batch(images)
    got = tpred.predict_decoded_batch(images)
    assert len(got) == len(want) == len(images)
    for w, g in zip(want, got):
        assert g.ok and w.ok and g.n_people == w.n_people >= 2
        _assert_same_people(decode_device(g, SK), jdecode(w, SK))
