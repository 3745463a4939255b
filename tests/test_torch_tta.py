"""The accuracy tiers of the port's inference against the JAX package, on
the CPU (where the port's ops run their kernels' plain versions):

- ``resize_cubic`` against ``jax.image.resize(..., "cubic")`` at
  non-integer ratios, up and down, within 2e-6 (the two sum in other
  orders); an unchanged size passes through as the same tensor;
- ``_warp_rotate`` against the JAX package's within 1e-5 (XLA fuses
  multiply-adds into the coordinates and the sum), and against
  ``cv2.warpAffine`` at the JAX test's tolerance (cv2 quantizes its
  coordinates to 5 bits); ``center_pad`` equal;
- the scale, rotation and product grids on the image-following stub of
  ``tests/test_fused_tta.py`` (plus 1e-3 of fixed noise, so no two
  channels tie): the compact and decode payloads equal the JAX
  package's (its looped grid), integer fields exactly, floats within
  1e-5; the fused and
  looped dispatches equal each other bit for bit, with 1 and entries + 1
  dispatches; a one-entry grid equals the compact lane; the compact,
  decoded and batched lanes route a grid to the grid dispatch;
- ``Predictor.predict`` (the host full-map protocol) within 1e-5 of the
  JAX package's maps; ``process_image`` and ``pipelined_inference`` on
  grids, and a forced overflow down to ``Predictor.predict``, give the
  JAX package's people;
- on the tiny IMHN with converted weights, every grid entry's regridded
  maps within 1e-4 of the JAX package's;
- ``limb_topk_candidates`` equals the JAX function on planted maps.
"""
import sys

import cv2
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.infer import Predictor as TPredictor
from improved_body_parts_torch.infer import (
    center_pad,
    decode_compact,
    pipelined_inference,
    resize_cubic,
)
from improved_body_parts_torch.infer import evaluate as teval
from improved_body_parts_torch.infer.predict import _warp_rotate
from improved_body_parts_tpu.config import (
    InferenceModelParams,
    InferenceParams,
    get_config,
)
from improved_body_parts_tpu.infer import Predictor as JPredictor

sys.path.insert(0, "tests")
from test_torch_slice import INT_FIELDS, _planted_maps  # noqa: E402
from test_decode import synth_person_joints  # noqa: E402

SK = get_config("canonical").skeleton
# fixed noise on the stride-4 grid of inputs up to 256 px
NOISE = np.random.default_rng(11).uniform(
    0, 1e-3, (64, 64, SK.num_layers)).astype(np.float32)
GRIDS = {"multi_scale": ((0.8, 1.0), (0.0,)),
         "rotation": ((1.0,), (0.0, 30.0, -30.0)),
         "ms_rot": ((0.8, 1.0), (0.0, 30.0, -30.0))}


class JaxFollowStub:
    """``tests/test_fused_tta.py``'s ``ImageFollowingStub`` (the maps
    track the stride-4 mean of the image, so the rotation lanes are
    exercised), on green minus red, which is 0 in the gray pad and the
    rotations' border (a pad plateau's edge would ring into rows of
    nearly equal peaks), plus :data:`NOISE`."""

    def apply(self, variables, imgs, train=False):
        import jax.numpy as jnp

        n, h, w, _ = imgs.shape
        g = imgs[..., 1] - imgs[..., 0]
        g4 = g.reshape(n, h // 4, 4, w // 4, 4).mean(axis=(2, 4))
        return [[g4[..., None] + jnp.asarray(NOISE[:h // 4, :w // 4])]]


class TorchFollowStub(torch.nn.Module):
    """The port's twin of :class:`JaxFollowStub`."""

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        g = imgs[..., 1] - imgs[..., 0]
        g4 = g.reshape(n, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
        return [[g4[..., None] + torch.from_numpy(NOISE[:h // 4, :w // 4])]]


def _blob_image(h, w, blobs):
    yy, xx = np.mgrid[:h, :w]
    g = sum(np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 6.0 ** 2))
            for x0, y0 in blobs)
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 1] = np.clip(255 * g, 0, 255).astype(np.uint8)
    return img


# blob centres off the pixel grid: a blob centred on a pixel can put two
# neighbours within float noise of each other at its maximum
IMAGE = _blob_image(112, 128, [(79.3, 47.6), (30.7, 80.2)])
IMAGE_2 = _blob_image(112, 128, [(51.4, 37.7), (95.6, 70.3)])


def _pair(scales=(1.0,), angles=(0.0,), topk=64, fused=True):
    """(JAX predictor, port predictor, JAX params, port params) on the
    image-following stubs at boxsize 112, bucket 64.  The JAX predictor
    runs its looped grid: on this input its fused XLA program (jax 0.9.0,
    CPU) drops a peak that its looped programs, and its own ``topk_peaks``
    on their mean maps, keep (ROADMAP.md, Queue 3)."""
    jp = InferenceParams(scale_search=scales, rotation_search=angles)
    tp = tconfig.InferenceParams(scale_search=scales, rotation_search=angles)
    jpred = JPredictor(JaxFollowStub(), {}, SK, jp,
                       InferenceModelParams(boxsize=112, max_downsample=64),
                       bucket=64, compact_topk=topk, fused_tta=False)
    tpred = TPredictor(TorchFollowStub(), SK, tp,
                       tconfig.InferenceModelParams(boxsize=112,
                                                    max_downsample=64),
                       bucket=64, compact_topk=topk, fused_tta=fused,
                       device="cpu")
    return jpred, tpred, jp, tp


def _fields(res):
    """{name: array} of a CompactResult or DeviceDecoded."""
    compact = getattr(res, "compact", res)
    out = dict(zip(compact.peaks._fields, compact.peaks))
    out.update({f"cand_{k}" if k not in INT_FIELDS else k: v
                for k, v in zip(compact.stats._fields, compact.stats)})
    out["cand_count"] = compact.stats.count
    if res is not compact:
        # the person table: the parts' peak ids, then the floats (the
        # parts' scores and the two summary rows)
        parts = SK.num_parts
        out.update(subset=res.subset[:, :parts, 0],
                   subset_score=np.concatenate(
                       [res.subset[:, :parts, 1].ravel(),
                        res.subset[:, parts:].ravel()]), mask=res.mask,
                   flags=np.array([res.n_people, res.peak_overflow,
                                   res.cand_overflow, res.person_overflow]))
    return out


def _assert_same_payload(got, want, atol=1e-5):
    g, w = _fields(got), _fields(want)
    assert set(g) == set(w)
    for name in w:
        a, b = np.asarray(g[name]), np.asarray(w[name])
        if name in INT_FIELDS or b.dtype == bool or name in (
                "subset", "flags", "cand_count"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                       err_msg=name)


def _same_people(got, want, tol=1e-3, score_tol=1e-4):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(sorted(got, key=lambda r: -r[1]),
                                  sorted(want, key=lambda r: -r[1])):
        assert gs == pytest.approx(ws, abs=score_tol)
        for pg, pw in zip(gk, wk):
            assert (pg is None) == (pw is None)
            if pg is not None:
                np.testing.assert_allclose(pg, pw, rtol=0, atol=tol)


# ------------------------------------------------------------ resize


@pytest.mark.parametrize("shape,size", [
    ((1, 37, 53, 5), (50, 41)),      # up rows, down columns
    ((1, 64, 48, 3), (23, 97)),      # down rows, up columns
    ((2, 30, 30, 4), (30, 71)),      # rows unchanged
    ((1, 29, 45, 2), (77, 45)),      # columns unchanged
    ((1, 16, 24, 6), (64, 96)),      # the x4 upsample
])
def test_resize_cubic_matches_jax(shape, size):
    import jax

    x = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (shape[0], *size, shape[3]),
                                       method="cubic"))
    got = resize_cubic(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_resize_cubic_skips_unchanged_sizes():
    x = torch.rand(1, 20, 30, 3)
    assert resize_cubic(x, (20, 30)) is x


# ------------------------------------------------------------ rotation


@pytest.mark.parametrize("shape,angle", [((96, 96), 25.0), ((64, 96), -40.0),
                                         ((96, 64), 33.0), ((50, 70), 30.0)])
def test_warp_rotate_matches_jax_and_cv2(shape, angle):
    """The JAX package's rotation within 1e-5, and cv2's warpAffine at
    ``tests/test_predictor.py``'s tolerance (cv2 rounds its coordinates
    to 5 bits): at most 2e-2 anywhere, below 5e-4 on average."""
    import jax.numpy as jnp

    from improved_body_parts_tpu.infer.predict import (
        _warp_rotate as jwarp_rotate,
    )

    h, w = shape
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    field = np.stack([
        np.sin(xx / 9.0) * np.cos(yy / 7.0),
        np.exp(-((xx - w * 0.6) ** 2 + (yy - h * 0.4) ** 2) / (2 * 8.0 ** 2)),
    ], axis=-1).astype(np.float32)
    center = (h / 2, w / 2)  # the reference's quirk: (h/2, w/2) as (x, y)
    got = _warp_rotate(torch.from_numpy(field[None]), angle, center)[0]
    got = got.numpy()
    want = np.asarray(jwarp_rotate(jnp.asarray(field), angle, center))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    cv = cv2.warpAffine(field, cv2.getRotationMatrix2D(center, angle, 1),
                        (w, h))
    np.testing.assert_allclose(got, cv, atol=2e-2)
    assert np.abs(got - cv).mean() < 5e-4


@pytest.mark.parametrize("shape", [(100, 130), (64, 64), (65, 1)])
def test_center_pad_equals_jax(shape):
    from improved_body_parts_tpu.infer.predict import (
        center_pad as jcenter_pad,
    )

    img = np.random.default_rng(2).integers(0, 255, (*shape, 3),
                                            dtype=np.uint8)
    got, gpad = center_pad(img, 64, 128)
    want, wpad = jcenter_pad(img, 64, 128)
    assert gpad == wpad
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- the grid


@pytest.mark.parametrize("mode", ["compact", "decode"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_payload_matches_jax_and_fused_equals_looped(grid, mode):
    scales, angles = GRIDS[grid]
    jpred, tpred, jp, tp = _pair(scales, angles)
    n_entries = len(scales) * len(angles)
    packed_j, rh_j, cs_j = jpred._compact_ms_dispatch(IMAGE, None, jp,
                                                      mode=mode)
    tpred.dispatch_count = 0
    fused, rh, cs = tpred._compact_ms_dispatch(IMAGE, None, tp, mode=mode,
                                               fused=True)
    assert tpred.dispatch_count == 1
    looped, rh_l, cs_l = tpred._compact_ms_dispatch(IMAGE, None, tp,
                                                    mode=mode, fused=False)
    assert tpred.dispatch_count == 1 + n_entries + 1
    assert (rh, cs) == (rh_l, cs_l) == (rh_j, cs_j)
    a, b = fused.numpy(), looped.numpy()
    assert a.shape == b.shape == np.asarray(packed_j).shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))

    if mode == "decode":
        spec = tpred._decode_spec(tp)
        got = tpred._unpack_decoded(a, spec, rh, cs)
        want = tpred._unpack_decoded(np.asarray(packed_j), spec, rh, cs)
        assert got.ok and want.ok
    else:
        got = tpred._unpack_compact(a, tpred.compact_topk, rh, cs)
        want = tpred._unpack_compact(np.asarray(packed_j),
                                     tpred.compact_topk, rh, cs)
    assert want.compact.peaks.valid.any() if mode == "decode" \
        else want.peaks.valid.any()
    _assert_same_payload(got, want)


def test_grid_dispatch_counts_and_lane_routing():
    """``predict_compact_ms`` defaults to the fused grid (1 dispatch); a
    looped predictor pays entries + 1; the compact, decoded and batched
    lanes route a grid through the same dispatch and give its payload."""
    scales, angles = GRIDS["ms_rot"]
    _, tpred, _, tp = _pair(scales, angles)
    _, looped, _, _ = _pair(scales, angles, fused=False)
    assert tpred.fused_tta and not looped.fused_tta
    res = tpred.predict_compact_ms(IMAGE, params=tp)
    assert tpred.dispatch_count == 1
    res_l = looped.predict_compact_ms(IMAGE, params=tp)
    assert looped.dispatch_count == len(scales) * len(angles) + 1
    _assert_same_payload(res_l, res, atol=0)
    _assert_same_payload(tpred.predict_compact(IMAGE, params=tp), res,
                         atol=0)
    for got in tpred.predict_compact_batch([IMAGE, IMAGE], params=tp):
        _assert_same_payload(got, res, atol=0)
    dec = tpred.predict_decoded(IMAGE, params=tp)
    _assert_same_payload(dec.compact, res, atol=0)
    (dec_b,) = tpred.predict_decoded_batch([IMAGE], params=tp)
    _assert_same_payload(dec_b, dec, atol=0)
    with pytest.raises(ValueError, match="single-scale"):
        tpred.precompile_compact([(128, 128)], params=tp)
    with pytest.raises(ValueError, match="single-entry"):
        tpred.predict_fast(IMAGE, params=tp)


def test_single_scale_ms_equals_compact_lane():
    """A one-entry grid through the grid dispatch decodes the compact
    lane's people (JAX: tests/test_compact.py
    ``test_compact_ms_single_scale_equals_compact``)."""
    _, tpred, _, tp = _pair()
    a = decode_compact(tpred.predict_compact(IMAGE), tp, SK,
                       use_native=False)
    ms = tpred.predict_compact_ms(IMAGE)
    b = decode_compact(ms, tp, SK, use_native=False)
    assert len(a) == len(b)
    _same_people(b, a, tol=1e-4, score_tol=1e-6)
    np.testing.assert_array_equal(ms.peaks.xs,
                                  tpred.predict_compact(IMAGE).peaks.xs)


# ------------------------------------------------- host protocol


@pytest.mark.parametrize("grid", ["rotation", "ms_rot"])
def test_predict_maps_match_jax(grid):
    jpred, tpred, jp, tp = _pair(*GRIDS[grid])
    heat_j, paf_j = jpred.predict(IMAGE, params=jp)
    heat, paf = tpred.predict(IMAGE, params=tp)
    assert heat.shape == heat_j.shape == (112, 128, SK.heat_layers + 2)
    assert paf.shape == paf_j.shape == (112, 128, SK.paf_layers)
    np.testing.assert_allclose(heat, heat_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(paf, paf_j, atol=1e-5, rtol=0)
    assert heat[..., 0].max() > 0.5


def test_process_image_and_pipeline_on_grids_match_jax():
    """``process_image`` with neither flag (the host protocol) and on the
    compact lane of a grid, and ``pipelined_inference`` over the compact
    and decode lanes of a grid, give the JAX package's people."""
    from improved_body_parts_tpu.infer import (
        pipelined_inference as jpipelined,
    )
    from improved_body_parts_tpu.infer.evaluate import (
        process_image as jprocess_image,
    )

    jpred, tpred, jp, tp = _pair(*GRIDS["ms_rot"])
    for kw in ({}, {"compact": True}):
        _same_people(
            teval.process_image(tpred, IMAGE, tp, use_native=False, **kw),
            jprocess_image(jpred, IMAGE, jp, use_native=False, **kw))
    images = [IMAGE, IMAGE_2]
    for kw in ({"compact": True}, {"device_decode": True},
               {"compact_batch": 2}):
        got = list(pipelined_inference(tpred, images, tp, use_native=False,
                                       **kw))
        want = list(jpipelined(jpred, images, jp, use_native=False, **kw))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_people(g, w)


def test_grid_overflow_falls_back_to_the_host_protocol():
    """Top-K 1 overflows the compact records (two blobs a channel): the
    grid's fallback is ``Predictor.predict``, in ``process_image`` and in
    ``pipelined_inference``, with the JAX package's people."""
    from improved_body_parts_tpu.infer import (
        pipelined_inference as jpipelined,
    )
    from improved_body_parts_tpu.infer.evaluate import (
        process_image as jprocess_image,
    )

    jpred, tpred, jp, tp = _pair(*GRIDS["multi_scale"], topk=1)
    calls = []
    predict = tpred.predict

    def counted(*args, **kwargs):
        calls.append(1)
        return predict(*args, **kwargs)

    tpred.predict = counted
    got = teval.process_image(tpred, IMAGE, tp, use_native=False,
                              compact=True)
    assert len(calls) == 1
    _same_people(got, jprocess_image(jpred, IMAGE, jp, use_native=False,
                                     compact=True))
    (streamed,) = pipelined_inference(tpred, [IMAGE], tp, use_native=False,
                                      compact=True)
    assert len(calls) == 2
    (want,) = jpipelined(jpred, [IMAGE], jp, use_native=False, compact=True)
    _same_people(streamed, want)


# ---------------------------------------------------- the tiny IMHN


def test_grid_entries_match_jax_on_the_tiny_imhn():
    """Every (scale, rotation) entry of a product grid, through the
    tiny IMHN with converted weights: the regridded maps within 1e-4 of
    the JAX package's per-entry program."""
    from improved_body_parts_torch.models import (
        build_model,
        load_flax_variables,
    )
    from test_torch_models import _seeded_flax

    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, 64, 64, seed=5)
    jpred = JPredictor(jmodel, variables, SK, model_params=(
        InferenceModelParams(boxsize=64, max_downsample=64)), bucket=64)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    tpred = TPredictor(model, SK, model_params=tconfig.InferenceModelParams(
        boxsize=64, max_downsample=64), bucket=64, device="cpu")
    image = np.random.default_rng(6).integers(0, 255, (64, 80, 3),
                                              dtype=np.uint8)
    prepared = [tpred._prepare_input(image, s * 64 / 64)
                for s in (1.0, 0.75)]
    grid = prepared[0][1]
    for img, valid in prepared:
        for angle in (0.0, 30.0):
            want = np.asarray(jpred._scale_to_grid_fn(
                img.shape[:2], valid, grid, angle)(variables, img))
            got = tpred._grid_entry(torch.from_numpy(img[None]), valid,
                                    grid, angle)[0].detach().numpy()
            assert got.shape == want.shape == (*grid, SK.num_layers)
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                       err_msg=f"{valid} {angle}")


def test_limb_topk_candidates_matches_jax():
    from improved_body_parts_torch.ops.peaks import (
        limb_topk_candidates,
        topk_peaks,
    )
    from improved_body_parts_tpu.ops.peaks import (
        limb_topk_candidates as jlimb_topk_candidates,
    )
    from improved_body_parts_tpu.ops.peaks import topk_peaks as jtopk_peaks

    maps = _planted_maps([synth_person_joints(40, 30, 150),
                          synth_person_joints(130, 50, 130)], h=192, w=224)
    maps = np.asarray(torch.from_numpy(maps[None]).repeat_interleave(
        4, 1).repeat_interleave(4, 2)[0])          # nearest x4: exact
    kp = maps[..., SK.heat_start:SK.heat_start + SK.num_parts]
    paf = maps[..., :SK.paf_layers]
    limbs = dict(limbs_from=tuple(a for a, _ in SK.limbs_conn),
                 limbs_to=tuple(b for _, b in SK.limbs_conn))
    kw = dict(limbs, num_samples=20, thre2=0.1, connect_ration=0.8,
              m_cap=32)
    jpk = jtopk_peaks(kp, 190, 220, thre=0.1, k=16, radius=2)
    want = jlimb_topk_candidates(paf, jpk, 190, **kw)
    vh, vw = torch.tensor([190]), torch.tensor([220])
    tpk = topk_peaks(torch.from_numpy(kp[None]), vh, vw, thre=0.1, k=16,
                     radius=2)
    got = limb_topk_candidates(torch.from_numpy(paf[None]), tpk, vh, **kw)
    assert np.asarray(want.valid).any()
    for name, g, w in zip(want._fields, got, want):
        g, w = g[0].numpy(), np.asarray(w)
        if name in ("prior", "norm"):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
