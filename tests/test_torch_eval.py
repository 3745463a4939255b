"""Host evaluation of the port (``improved_body_parts_torch.infer.{oks,
evaluate,demo}``, ``data.{coco_masks,fixture}``) against the JAX package,
on the CPU.

- ``evaluate_oks`` equals the JAX function exactly, all 10 stats (NaN
  where JAX gives NaN), on the analytic cases of
  ``tests/test_oks_and_variants.py``: a perfect match, a false positive,
  imperfect detections, crowd absorption, an ignored GT, the maxDets cap
  and the area splits; ``oks`` equals it on the crowd fallback;
- the COCO mask codecs equal the JAX ones on seeded masks;
- ``build_val_set`` / ``build_coco_train_set`` write the same annotation
  JSON and pixel-identical images for the same seed;
- ``validation_oks`` on the planted stub maps of
  ``tests/test_evaluate_proxy.py`` gives the same metrics dict and the
  same detections as the JAX package, through the compact and the fused
  lanes; ``process_image`` on both host lanes finds the planted person,
  and its host full-map protocol and a scale grid on the compact lane
  give the JAX package's people;
- ``draw_skeletons`` / ``limb_flow_bgr`` equal the JAX ones bit for bit,
  and ``run_demo`` draws the planted person on both lanes.
"""
import dataclasses
import importlib
import json
import math
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.data import coco_masks as tmasks
from improved_body_parts_torch.data import fixture as tfix
from improved_body_parts_torch.infer import Predictor as TPredictor
from improved_body_parts_torch.infer import demo as tdemo
from improved_body_parts_torch.infer import evaluate as teval
from improved_body_parts_tpu.config import (
    InferenceModelParams,
    InferenceParams,
    get_config,
)
from improved_body_parts_tpu.data import coco_masks as jmasks
from improved_body_parts_tpu.data import fixture as jfix
from improved_body_parts_tpu.data.heatmapper import Heatmapper
from improved_body_parts_tpu.infer import demo as jdemo
from improved_body_parts_tpu.infer import validation_oks as jvalidation_oks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_evaluate_proxy import _coco_keypoints, _symmetric_person  # noqa
from test_predictor import StubModel as JaxStub  # noqa: E402

# the modules, not the ``oks`` functions the packages re-export
toks = importlib.import_module("improved_body_parts_torch.infer.oks")
joks = importlib.import_module("improved_body_parts_tpu.infer.oks")
SK = get_config("canonical").skeleton
STATS = ("AP", "AP50", "AP75", "AP_M", "AP_L",
         "AR", "AR50", "AR75", "AR_M", "AR_L")


# ---------------------------------------------------------------- OKS


def _nose_gt(x, y, area=1000.0):
    gt = np.zeros((17, 3))
    gt[0] = [x, y, 2]
    return {"keypoints": gt, "area": area}


def _nose_det(x, y, score, target_oks=None, area=1000.0):
    if target_oks is not None:
        x = x + np.sqrt(-2.0 * area * (2 * joks.COCO_SIGMAS[0]) ** 2
                        * np.log(target_oks))
    coords = [None] * 17
    coords[0] = (float(x), float(y))
    return (coords, score)


def _person(x0, y0, spread):
    gt = np.zeros((17, 3))
    gt[:, 0] = x0 + np.linspace(0, spread, 17)
    gt[:, 1] = y0 + (np.arange(17) % 4) * spread / 4
    gt[:, 2] = 2
    return gt


def _det(g, score):
    return ([tuple(p) for p in g[:, :2]], score)


def _oks_cases():
    line = np.zeros((17, 3))
    line[:, 0] = np.arange(17) * 5 + 20
    line[:, 1] = 60
    line[:, 2] = 2
    fp = [(float(x), 500.0) for x in range(17)]
    crowd = {"keypoints": np.zeros((17, 3)), "area": 4000.0, "iscrowd": 1,
             "bbox": (500.0, 500.0, 100.0, 100.0)}
    gt_m, gt_l = _person(100, 100, 40), _person(400, 100, 90)
    return {
        "perfect": ({1: [{"keypoints": line, "area": 3000.0}]},
                    {1: [_det(line, 0.9)]}),
        "false_positive": ({1: [{"keypoints": line, "area": 3000.0}]},
                           {1: [_det(line, 0.5), (fp, 0.9)]}),
        "imperfect": ({1: [_nose_gt(100, 100), _nose_gt(4000, 4000)]},
                      {1: [_nose_det(100, 100, 0.9, 0.72),
                           _nose_det(4000, 4000, 0.8, 0.92),
                           _nose_det(9000, 9000, 0.7)]}),
        "crowd_absorbs": ({1: [_nose_gt(100, 100), crowd]},
                          {1: [([(550.0, 550.0)] * 17, 0.95),
                               ([(540.0, 560.0)] * 17, 0.9),
                               _nose_det(100, 100, 0.8)]}),
        "ignored_gt": ({1: [_nose_gt(100, 100),
                            dict(_nose_gt(4000, 4000), ignore=True)]},
                       {1: [_nose_det(100, 100, 0.9)]}),
        "max_dets": ({1: [_nose_gt(100, 100)]},
                     {1: [_nose_det(5000 + 100 * i, 5000, 0.9 - 0.001 * i)
                          for i in range(20)]
                      + [_nose_det(100, 100, 0.1)]}),
        "area_splits": ({1: [{"keypoints": gt_m, "area": 2500.0},
                             {"keypoints": gt_l, "area": 10000.0}]},
                        {1: [_det(_person(800, 600, 40), 0.95),
                             _det(gt_m, 0.90), _det(gt_l, 0.80)]}),
        "empty_range_nan": ({1: [{"keypoints": gt_m, "area": 2500.0}]},
                            {1: [_det(gt_m, 0.9)]}),
    }


def _same_stats(got, want):
    assert list(got) == list(want) and set(want) == set(STATS)
    for k in STATS:
        if math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("case", sorted(_oks_cases()))
def test_evaluate_oks_equals_jax(case):
    gts, dts = _oks_cases()[case]
    want = joks.evaluate_oks(gts, dts)
    _same_stats(toks.evaluate_oks(gts, dts), want)
    # the cases reach what their names say
    if case == "empty_range_nan":
        assert math.isnan(want["AP_L"])
    if case == "max_dets":
        assert want["AP"] == 0.0
    if case == "perfect":
        assert want["AP"] == pytest.approx(1.0, abs=0.01)


def test_oks_crowd_fallback_equals_jax():
    crowd = np.zeros((17, 3))
    bbox = (0.0, 0.0, 100.0, 100.0)
    for det in (np.full((17, 2), 150.0), np.full((17, 2), 250.0)):
        assert toks.oks(det, crowd, 4000.0, bbox=bbox) == \
            joks.oks(det, crowd, 4000.0, bbox=bbox)
    gt = np.random.default_rng(0).uniform(0, 200, (17, 3))
    gt[:, 2] = 2
    det = gt[:, :2] + 3.0
    assert toks.oks(det, gt, 1500.0) == joks.oks(det, gt, 1500.0)


# -------------------------------------------------------- mask codecs


def test_coco_mask_codecs_equal_jax():
    rng = np.random.default_rng(5)
    for h, w in ((17, 23), (64, 48)):
        mask = (rng.uniform(size=(h, w)) > 0.6).astype(np.uint8)
        counts = tmasks.rle_encode(mask)
        assert counts == jmasks.rle_encode(mask)
        s = tmasks.rle_to_string(counts)
        assert s == jmasks.rle_to_string(counts)
        assert tmasks.rle_from_string(s) == jmasks.rle_from_string(s)
        np.testing.assert_array_equal(tmasks.rle_decode(counts, h, w),
                                      jmasks.rle_decode(counts, h, w))
        np.testing.assert_array_equal(tmasks.rle_decode(counts, h, w), mask)
        poly = [list(rng.uniform(0, min(h, w), 8))]
        np.testing.assert_array_equal(tmasks.polygons_to_mask(poly, h, w),
                                      jmasks.polygons_to_mask(poly, h, w))
        for seg in (poly, {"size": [h, w], "counts": counts},
                    {"size": [h, w], "counts": s}):
            np.testing.assert_array_equal(
                tmasks.ann_to_mask({"segmentation": seg}, h, w),
                jmasks.ann_to_mask({"segmentation": seg}, h, w))


# ------------------------------------------------------ fixture sets


@pytest.mark.parametrize("writer", ["build_val_set", "build_coco_train_set"])
def test_coco_set_writers_equal_jax(tmp_path, writer):
    kw = dict(num_images=3, img_size=(96, 128), people_per_image=2,
              image_size=64, seed=7, crowd=True)
    sets = {}
    for name, mod in (("torch", tfix), ("jax", jfix)):
        images, anno = tmp_path / name, tmp_path / f"{name}.json"
        n = getattr(mod, writer)(str(images), str(anno), **kw)
        sets[name] = (n, images, anno.read_text())
    assert sets["torch"][0] == sets["jax"][0] > 0
    assert sets["torch"][2] == sets["jax"][2]
    doc = json.loads(sets["torch"][2])
    assert len(doc["images"]) == 3
    if writer == "build_coco_train_set":
        assert all("segmentation" in a for a in doc["annotations"])
    for im in doc["images"]:
        a = cv2.imread(str(sets["torch"][1] / im["file_name"]))
        b = cv2.imread(str(sets["jax"][1] / im["file_name"]))
        assert a is not None and a.shape == (96, 128, 3)
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------- validation_oks


class TorchStub(torch.nn.Module):
    """Ignores the input; returns fixed stride-4 maps for whatever size it
    is given, as ``tests/test_predictor.py``'s ``StubModel`` does."""

    def __init__(self, maps):
        super().__init__()
        self.register_buffer("maps", torch.from_numpy(maps))

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        m = self.maps[:h // SK.stride, :w // SK.stride]
        return [[m.expand(n, *m.shape)]]


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """``tests/test_evaluate_proxy.py``'s planted person: its maps, two
    blank 256 px images and their COCO annotations on disk."""
    tmp = tmp_path_factory.mktemp("planted")
    h = w = 256
    joints = _symmetric_person(w)
    small = dataclasses.replace(SK, width=w, height=h)
    maps = Heatmapper(small).create_heatmaps(
        joints, np.ones(small.grid_shape, np.float32))
    rng = np.random.default_rng(0)
    maps = (maps + rng.uniform(0, 1e-6, maps.shape)).astype(np.float32)
    images_dir = tmp / "imgs"
    images_dir.mkdir()
    entries, annotations = [], []
    xs, ys = joints[0, :, 0], joints[0, :, 1]
    bbox = [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min()), float(ys.max() - ys.min())]
    for image_id in (1, 2):
        name = f"{image_id:012d}.jpg"
        cv2.imwrite(str(images_dir / name), np.zeros((h, w, 3), np.uint8))
        entries.append({"id": image_id, "file_name": name, "height": h,
                        "width": w})
        annotations.append({
            "id": image_id * 10, "image_id": image_id, "category_id": 1,
            "keypoints": _coco_keypoints(joints[0]), "num_keypoints": 17,
            "area": bbox[2] * bbox[3], "bbox": bbox, "iscrowd": 0})
    anno = tmp / "person_keypoints.json"
    anno.write_text(json.dumps({"images": entries,
                                "annotations": annotations,
                                "categories": [{"id": 1, "name": "person"}]},
                               allow_nan=False))
    return dict(maps=maps, images=str(images_dir), anno=str(anno), tmp=tmp,
                joints=joints)


def _predictors(maps):
    from improved_body_parts_tpu.infer import Predictor as JPredictor

    params = InferenceParams(scale_search=(1.0,))
    mp = InferenceModelParams(boxsize=256, max_downsample=64)
    tparams = tconfig.InferenceParams(scale_search=(1.0,))
    tmp = tconfig.InferenceModelParams(boxsize=256, max_downsample=64)
    return (TPredictor(TorchStub(maps), SK, tparams, tmp, bucket=64,
                       device="cpu"), tparams,
            JPredictor(JaxStub(maps), {}, SK, params, mp, bucket=64), params)


@pytest.mark.parametrize("lane", ["compact", "device_decode"])
def test_validation_oks_equals_jax(planted, lane):
    tpred, tparams, jpred, jparams = _predictors(planted["maps"])
    out = planted["tmp"] / lane
    kw = {lane: True}
    got = teval.validation_oks(tpred, planted["anno"], planted["images"],
                               params=tparams, use_native=False,
                               dump_name="port", results_dir=str(out), **kw)
    want = jvalidation_oks(jpred, planted["anno"], planted["images"],
                           params=jparams, use_native=False,
                           dump_name="jax", results_dir=str(out), **kw)
    _same_stats(got, want)
    assert want["AP50"] == pytest.approx(1.0)
    dets = {name: json.loads((out / f"person_keypoints_{name}.json")
                             .read_text()) for name in ("port", "jax")}
    assert len(dets["port"]) == len(dets["jax"]) >= 2
    for a, b in zip(dets["port"], dets["jax"]):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_allclose(a["keypoints"], b["keypoints"],
                                   rtol=0, atol=1e-4)
        assert a["score"] == pytest.approx(b["score"], rel=1e-5)


def test_process_image_lanes_find_the_planted_person(planted):
    tpred, tparams, jpred, jparams = _predictors(planted["maps"])
    image = cv2.imread(os.path.join(planted["images"], "000000000001.jpg"))
    got = {lane: teval.process_image(tpred, image, tparams,
                                     use_native=False, **{lane: True})
           for lane in ("fast", "compact")}
    whole = {}
    for lane, people in got.items():
        # the planted person, whole, beside fragments of the noise
        kps = max((kp for kp, _ in people),
                  key=lambda kp: sum(p is not None for p in kp))
        assert sum(p is not None for p in kps) == 17, lane
        whole[lane] = np.array(kps)
    assert np.abs(whole["fast"] - whole["compact"]).max() < 2.0
    # the host full-map protocol (neither flag), and a scale grid on the
    # compact lane (predict_compact_ms), give the JAX package's people:
    # keypoints within 1e-3 px, scores within 1e-4
    from improved_body_parts_tpu.infer.evaluate import (
        process_image as jprocess_image,
    )

    host = teval.process_image(tpred, image, tparams, use_native=False)
    assert len(host) >= 1
    _same_people(host, jprocess_image(jpred, image, jparams,
                                      use_native=False))
    grid = tconfig.InferenceParams(scale_search=(0.5, 1.0))
    jgrid = InferenceParams(scale_search=(0.5, 1.0))
    _same_people(
        teval.process_image(tpred, image, grid, compact=True,
                            use_native=False),
        jprocess_image(jpred, image, jgrid, compact=True, use_native=False))


def _same_people(got, want, tol=1e-3, score_tol=1e-4):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(sorted(got, key=lambda r: -r[1]),
                                  sorted(want, key=lambda r: -r[1])):
        assert gs == pytest.approx(ws, abs=score_tol)
        for pg, pw in zip(gk, wk):
            assert (pg is None) == (pw is None)
            if pg is not None:
                np.testing.assert_allclose(pg, pw, rtol=0, atol=tol)


def test_validation_needs_pycocotools(planted, monkeypatch):
    """``validation`` keeps the JAX file's import guard: without
    pycocotools it raises ImportError."""
    monkeypatch.setitem(sys.modules, "pycocotools", None)
    monkeypatch.setitem(sys.modules, "pycocotools.coco", None)
    tpred, tparams, _, _ = _predictors(planted["maps"])
    with pytest.raises(ImportError):
        teval.validation(tpred, planted["anno"], planted["images"],
                         params=tparams, compact=True)


# ---------------------------------------------------------------- demo


def test_draw_skeletons_and_limb_flow_equal_jax():
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    candidate = np.concatenate(
        [rng.uniform(5, 150, (40, 2)), rng.uniform(0, 1, (40, 1)),
         np.arange(40, dtype=np.float64)[:, None]], axis=1)
    subset = np.full((3, SK.num_parts + 2, 2), -1.0)
    subset[..., 0] = rng.integers(-1, 40, (3, SK.num_parts + 2))
    np.testing.assert_array_equal(
        tdemo.draw_skeletons(image, subset, candidate, SK),
        jdemo.draw_skeletons(image, subset, candidate, SK))
    limb = rng.normal(size=(48, 64)).astype(np.float32)
    np.testing.assert_array_equal(tdemo.limb_flow_bgr(limb),
                                  jdemo.limb_flow_bgr(limb))


@pytest.mark.parametrize("device_decode", [False, True])
def test_run_demo_draws_the_planted_person(planted, tmp_path, device_decode):
    tpred, _, _, _ = _predictors(planted["maps"])
    out = tmp_path / "demo.jpg"
    canvas, (subset, candidate) = tdemo.run_demo(
        tpred, os.path.join(planted["images"], "000000000001.jpg"),
        str(out), use_native=False, device_decode=device_decode)
    assert out.exists() and canvas.shape == (256, 256, 3)
    assert len(subset) >= 1 and canvas.any()
    # the most complete person drawn is the planted one
    ids = subset[:, :SK.num_parts, 0].astype(int)
    ids = ids[np.argmax((ids >= 0).sum(axis=1))]
    assert (ids >= 0).sum() >= SK.num_parts - 4
    xy = candidate[ids[ids >= 0], :2]
    planted_xy = planted["joints"][0, ids >= 0, :2]
    assert np.abs(xy - planted_xy).max() < 2.0
