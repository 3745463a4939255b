"""Port parity: GT made on the device (``ops.gt_device``).

- ``make_gt_synthesizer`` over a batch of random people (visibility 0,
  1 and 2, joints off the image) against the JAX package's
  ``make_gt_synthesizer`` sample by sample: max abs 2e-6.  The bound is
  measured, not 1e-6: XLA's CPU ``exp`` differs from torch's by a few
  ulp near 1 (1.07e-6 at worst here), where the port and the host
  ``Heatmapper`` agree to 2.4e-7;
- against the port's host ``Heatmapper``: max abs 1e-4 over every
  channel and pixel (the JAX test's bound; the port's 3x3 erosion
  replicates the border as ``cv2.erode`` does, so no border is excepted);
- no people: zero keypoint and limb maps, a full mask kept;
- ``batches(raw_gt=N)`` gives the JAX package's joints and masks bit for
  bit, and its GT made on the device equals the host labels of
  ``batches()`` on the same draws within 1e-4;
- one ``make_train_step(device_gt=True)`` step against the host-label
  step on the same batch: loss within rel 1e-6, parameters within
  atol 1e-7.
"""
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data import fixture as tfix
from improved_body_parts_torch.data.heatmapper import Heatmapper
from improved_body_parts_torch.models import build_model
from improved_body_parts_torch.ops.gt_device import make_gt_synthesizer
from improved_body_parts_torch.train import schedule as tsched
from improved_body_parts_torch.train import state as tstate
from improved_body_parts_torch.train import step as tstep
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.data import dataset as jds
from improved_body_parts_tpu.data import fixture as jfix
from improved_body_parts_tpu.ops.gt_device import (
    make_gt_synthesizer as jmake_gt_synthesizer,
)

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

SK = tconfig.get_config("canonical").skeleton
KW = dict(num_images=3, img_size=(120, 160), people_per_image=3,
          image_size=128, seed=5, drawn=True, crowd=True)


def _random_batch(seed, people=(1, 3, 5), max_people=8):
    rng = np.random.default_rng(seed)
    n = len(people)
    joints = np.zeros((n, max_people, SK.num_parts, 3), np.float32)
    joints[..., 2] = 2
    for i, k in enumerate(people):
        joints[i, :k, :, :2] = rng.uniform(-40, 552, (k, SK.num_parts, 2))
        joints[i, :k, :, 2] = rng.choice([0, 1, 2], (k, SK.num_parts))
    mask_all = (rng.uniform(size=(n, *SK.grid_shape)) > 0.3).astype(
        np.float32)
    return joints, mask_all


@pytest.fixture(scope="module")
def synth():
    return make_gt_synthesizer(SK)


def test_matches_jax_and_host(synth):
    joints, mask_all = _random_batch(0)
    got = synth(torch.from_numpy(joints), torch.from_numpy(mask_all))
    assert got.shape == (3, *SK.grid_shape, SK.num_layers)
    assert got.dtype == torch.float32
    got = got.numpy()
    jsynth = jmake_gt_synthesizer(jconfig.get_config("canonical").skeleton)
    hm = Heatmapper(SK)
    for i in range(len(joints)):
        want = np.asarray(jsynth(joints[i], mask_all[i]))
        assert np.abs(got[i] - want).max() <= 2e-6
        host = hm.create_heatmaps(joints[i].copy(), mask_all[i].copy())
        assert np.abs(got[i] - host).max() <= 1e-4


def test_no_people(synth):
    joints = np.zeros((2, 4, SK.num_parts, 3), np.float32)
    joints[..., 2] = 2
    out = synth(torch.from_numpy(joints),
                torch.ones((2, *SK.grid_shape, 1))).numpy()
    assert out[..., :SK.bkg_start].max() == 0.0
    assert out[..., SK.bkg_start].min() == 1.0


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("gt_fixtures")
    tpath, jpath = str(d / "torch.h5"), str(d / "jax.h5")
    assert tfix.build_fixture(tpath, **KW) == jfix.build_fixture(jpath, **KW)
    return tpath, jpath


def test_raw_gt_batches_match_jax_and_host_labels(fixtures):
    tcfg, jcfg = tconfig.get_config("tiny"), jconfig.get_config("tiny")
    tset = tds.CocoPoseDataset(fixtures[0], tcfg, seed=2)
    jset = jds.CocoPoseDataset(fixtures[1], jcfg, seed=2)
    synth = make_gt_synthesizer(tcfg.skeleton)
    raw = list(tds.batches(tset, 2, 1, wire="uint8", raw_gt=6))
    want = list(jds.batches(jset, 2, 1, pipeline="sync", wire="uint8",
                            raw_gt=6))
    host = list(tds.batches(tset, 2, 1, wire="uint8"))
    assert len(raw) == len(want) == len(host) >= 2
    for r, w, h in zip(raw, want, host):
        assert len(r) == 4 and r[2].shape == (2, 6, tcfg.skeleton.num_parts,
                                              3)
        for a, b in zip(r, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r[0], h[0])
        np.testing.assert_array_equal(r[1], h[1])
        labels = synth(torch.from_numpy(r[2]), torch.from_numpy(r[3]))
        assert np.abs(labels.numpy() - h[2]).max() <= 1e-4
    tset.close()
    jset.close()


def test_device_gt_step_matches_host_label_step(fixtures):
    cfg = tconfig.get_config("tiny")
    tset = tds.CocoPoseDataset(fixtures[0], cfg, seed=2)
    raw = next(tds.batches(tset, 2, 0, wire="uint8", raw_gt=6))
    host = next(tds.batches(tset, 2, 0, wire="uint8"))
    tset.close()
    out = []
    for device_gt, batch in ((False, host), (True, raw)):
        model = build_model(cfg, device="cpu", seed=3, train=True)
        opt = tstate.make_optimizer(model, cfg,
                                    tsched.step_decay_schedule(cfg.train, 4))
        state = tstate.create_train_state(model, cfg, opt)
        step = tstep.make_train_step(model, cfg, opt, device_gt=device_gt)
        state, loss = step(state, *batch)
        out.append((float(loss), [p.detach().clone()
                                  for p in model.parameters()]))
    (loss_h, params_h), (loss_d, params_d) = out
    assert loss_d == pytest.approx(loss_h, rel=1e-6)
    for a, b in zip(params_h, params_d):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)
