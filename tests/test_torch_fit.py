"""``fit``, ``remat`` and the CLIs of the port, on the CPU.

- ``remat=True`` in train mode: predictions, loss, every gradient and the
  BN running stats equal ``remat=False`` bit for bit (the recomputed
  forward leaves the stats alone; without that guard they drift);
- ``fit`` in float64 on the tiny net over 2 epochs with eval, from the
  JAX package's initial state (its own init) carried across with
  ``models/convert.py``: the epoch-log lines, the commit markers' fields
  and the final parameters, BN stats and momentum match JAX's ``fit``
  within the tolerance ``tests/test_torch_train.py`` uses for float64
  trajectories (rel 1e-5 on losses, atol/rtol 1e-5 on the state).  JAX
  sums its loss in float32 even in x64 mode, and the tiny net's
  few-sample train-mode BN amplifies that rounding step by step (1.4e-5
  relative after 4 steps at lr 2e-4, 1.2e-5 after 2 at lr 2e-3), so the
  comparison takes one step an epoch at lr 2e-4.  At that lr a step
  moves a parameter by about the atol, so each leaf's change over the
  run is also held to JAX's change within 1e-5 of its norm (taken in
  float64 on both sides; the worst leaf is at 5.2e-7);
- ``fit`` for 2 epochs equals 1 epoch + ``restore_latest`` into a fresh
  state + 1 epoch, bit for bit;
- ``MemoryDataset`` over ``fixture_records`` gives the samples of the
  HDF5 corpus ``build_fixture`` writes;
- ``cli.synth_ap`` runs end to end (``--config synth --train-images 6
  --val-images 2 --epochs 2 --device cpu``, the fused lane), then the
  train CLI resumes (``--resume auto``) and the demo CLI draws.
"""
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data.fixture import (
    build_fixture,
    fixture_records,
)
from improved_body_parts_torch.models import (
    build_model,
    flax_train_state_to_torch,
)
from improved_body_parts_torch.models import posenet as tposenet
from improved_body_parts_torch.ops.losses import multi_task_loss
from improved_body_parts_torch.train import (
    create_train_state,
    fit,
    load_carried_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    read_commit_meta,
    restore_latest,
    step_decay_schedule,
)
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.train import loop as jloop
from improved_body_parts_tpu.train import schedule as jsched
from improved_body_parts_tpu.train import state as jstate
from improved_body_parts_tpu.train import step as jstep

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import _seeded_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH, SPE = 64, 2, 2  # image side, batch, steps per epoch
NUMBER = r"-?[0-9][0-9.eE+-]*"


def _config(mod, **train):
    cfg = mod.get_config("tiny")
    return dataclasses.replace(
        cfg, skeleton=dataclasses.replace(cfg.skeleton, width=HW, height=HW),
        train=dataclasses.replace(cfg.train, **{
            "bf16_compute": False, "learning_rate_per_device": 2e-3,
            "print_freq": 1, **train}))


# --------------------------------------------------------------- remat


def _remat_step(remat: bool):
    """One train-mode forward, loss and backward of the tiny net."""
    cfg = _config(tconfig)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))
    model = build_model(cfg, device="cpu", seed=0, train=True)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HW, HW, 3))
                           .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(
        0, 1, (BATCH, HW // 4, HW // 4, cfg.skeleton.num_layers))
        .astype(np.float32))
    preds = model(img)
    loss = multi_task_loss(preds, gt, torch.ones(BATCH, HW // 4, HW // 4, 1),
                           cfg)
    loss.backward()
    return (loss.detach(), [p.detach() for s in preds for p in s],
            {n: p.grad for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


def test_remat_equals_no_remat_bit_for_bit(monkeypatch):
    loss, preds, grads, sd = _remat_step(False)
    r_loss, r_preds, r_grads, r_sd = _remat_step(True)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(a, b) for a, b in zip(preds, r_preds))
    assert grads.keys() == r_grads.keys()
    for k in grads:
        assert torch.equal(grads[k], r_grads[k]), k
    for k in sd:
        assert torch.equal(sd[k], r_sd[k]), k
    # the guard matters: a recompute that updates the stats again drifts
    monkeypatch.setattr(tposenet, "frozen_bn_stats",
                        lambda module: contextlib.nullcontext())
    drift_sd = _remat_step(True)[3]
    assert any(not torch.equal(sd[k], drift_sd[k]) for k in sd
               if k.startswith("hourglasses.") and k.endswith("running_var"))


# ----------------------------------------------------- fit against JAX


def _corpus(tmp_path_factory, steps_per_epoch):
    path = str(tmp_path_factory.mktemp("fit") / "fixture.h5")
    n = build_fixture(path, num_images=steps_per_epoch, img_size=(120, 160),
                      people_per_image=2, image_size=HW, seed=0, drawn=True)
    assert n == BATCH * steps_per_epoch
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory, SPE)


@pytest.fixture(scope="module")
def corpus1(tmp_path_factory):
    return _corpus(tmp_path_factory, 1)


def _read_log(d):
    with open(os.path.join(d, "log")) as f:
        return f.read()


def _markers(d, epochs):
    return [read_commit_meta(os.path.join(d, f"epoch_{e}")) for e in epochs]


FIT_LR = 2e-4
UPDATE_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_fit(corpus1, tmp_path_factory):
    """JAX's ``fit`` in float64 from its own initial state: 2 epochs of one
    step, eval every epoch; its initial state, final state, log and
    markers."""
    from improved_body_parts_tpu.data import dataset as jds
    from improved_body_parts_tpu.models import build_model as jbuild

    corpus = corpus1
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jcfg = _config(jconfig, checkpoint_dir=d,
                   learning_rate_per_device=FIT_LR)
    jopt = jstate.make_optimizer(jcfg,
                                 jsched.step_decay_schedule(jcfg.train, 1))
    state0 = jstate.create_train_state(
        jbuild(jcfg, dtype=jnp.float32), jcfg, jopt, jax.random.PRNGKey(0),
        jnp.zeros((1, HW, HW, 3), jnp.float32))
    with jax.enable_x64(True):
        jmodel = jbuild(jcfg, dtype=jnp.float64)
        start = jax.tree.map(
            lambda x: (jnp.asarray(x, jnp.float64)
                       if jnp.issubdtype(x.dtype, jnp.floating) else x),
            state0)
        train_set = jds.CocoPoseDataset(corpus, jcfg)
        val_set = jds.CocoPoseDataset(corpus, jcfg, augment=False)
        final = jloop.fit(
            start, jstep.make_train_step(jmodel, jcfg, jopt, donate=False),
            jcfg, lambda e: jds.batches(train_set, BATCH, e,
                                        pipeline="sync", wire="uint8"),
            epochs=2, eval_step=jstep.make_eval_step(jmodel, jcfg),
            make_eval_batches=lambda e: jds.batches(
                val_set, BATCH, 0, pipeline="sync", wire="uint8"),
            log_fn=lambda s: None)
        final = jax.tree.map(np.asarray, final)
        # each leaf's change over the run, taken in float64 before the
        # conversion rounds it to float32
        moved = jax.tree.map(
            lambda f, s: (f - np.asarray(s, np.float64)
                          if np.issubdtype(f.dtype, np.floating) else f),
            final, state0)
        train_set.close()
        val_set.close()
    return dict(state0=state0, final=final, moved=moved, log=_read_log(d),
                markers=_markers(d, (0, 1)))


def _port_fit(corpus, d, carried, dtype, epochs, start_epoch=0,
              resume=False, spe=SPE, **train):
    """The port's ``fit`` from a carried state (or, with ``resume``, from
    the latest checkpoint of ``d``); returns the state."""
    cfg = _config(tconfig, checkpoint_dir=d, **train)
    model = build_model(cfg, device="cpu", train=True).to(dtype)
    opt = make_optimizer(model, cfg, step_decay_schedule(cfg.train, spe))
    state = create_train_state(model, cfg, opt)
    best = float("inf")
    if resume:
        state, meta = restore_latest(d, state)
        best = meta["best_loss"]
    else:
        load_carried_state(state, carried)
    train_set = tds.CocoPoseDataset(corpus, cfg)
    val_set = tds.CocoPoseDataset(corpus, cfg, augment=False)
    try:
        return fit(state, make_train_step(model, cfg, opt), cfg,
                   lambda e: tds.batches(train_set, BATCH, e, wire="uint8"),
                   epochs, start_epoch=start_epoch,
                   eval_step=make_eval_step(model, cfg),
                   make_eval_batches=lambda e: tds.batches(
                       val_set, BATCH, 0, wire="uint8"),
                   best_loss=best, log_fn=lambda s: None)
    finally:
        train_set.close()
        val_set.close()


def _snapshot(state):
    sd = {k: v.detach().to(torch.float32 if v.is_floating_point()
                           else v.dtype).clone().numpy()
          for k, v in state.model.state_dict().items()}
    names = {p: n for n, p in state.model.named_parameters()}
    mom = {names[p]: b.to(torch.float32).clone().numpy()
           for p, b in zip(state.optimizer.params, state.optimizer.momentum)}
    return {"state_dict": sd, "momentum": mom,
            "count": int(state.optimizer.count), "step": state.step}


def test_fit_float64_matches_jax(corpus1, jax_fit, tmp_path):
    d = str(tmp_path)
    model = build_model(_config(tconfig), device="cpu", train=True)
    carried = flax_train_state_to_torch(jax_fit["state0"], model)
    state = _port_fit(corpus1, d, carried, torch.float64, epochs=2, spe=1,
                      learning_rate_per_device=FIT_LR)
    # the epoch log: the same lines, the numbers within rel 1e-5
    log, want_log = _read_log(d), jax_fit["log"]
    assert re.sub(NUMBER, "#", log) == re.sub(NUMBER, "#", want_log) == \
        "\nEpoch #\ttrain_loss: #\tval_loss: #" * 2
    got_v = [float(v) for v in re.findall(r": (" + NUMBER + ")", log)]
    want_v = [float(v) for v in re.findall(r": (" + NUMBER + ")", want_log)]
    assert got_v == pytest.approx(want_v, rel=1e-5)
    # the commit markers
    for got, want in zip(_markers(d, (0, 1)), jax_fit["markers"]):
        for k in ("format", "epoch", "metric"):
            assert got[k] == want[k], k
        for k in ("train_loss", "best_loss", "metric_value"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert _markers(d, (1,))[0]["metric"] == "val_loss"
    # the final state
    got = _snapshot(state)
    want = flax_train_state_to_torch(jax_fit["final"], state.model)
    assert got["step"] == want["step"] == 2
    assert got["count"] == want["count"] == 2
    for part in ("state_dict", "momentum"):
        for k, w in want[part].items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[part][k], w, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{part} {k}")
    # at this lr a parameter moves ~2e-4 |g| a step, close to the atol
    # above: hold each leaf's change over the run (float64 on both sides)
    # to the norm of JAX's change as well
    names = {p: n for n, p in state.model.named_parameters()}
    final = {"state_dict": dict(state.model.state_dict()),
             "momentum": {names[p]: b for p, b in zip(
                 state.optimizer.params, state.optimizer.momentum)}}
    want_moved = flax_train_state_to_torch(jax_fit["moved"], state.model)
    for part in ("state_dict", "momentum"):
        for k, w in want_moved[part].items():
            if k.endswith("num_batches_tracked"):
                continue
            norm = np.linalg.norm(w)
            assert norm > 0, f"{part} {k} did not move"
            moved = (final[part][k].detach().numpy()
                     - np.asarray(carried[part][k], np.float64))
            err = np.linalg.norm(moved - w) / norm
            assert err <= UPDATE_RTOL, f"{part} {k}: {err:.3g}"


def test_fit_resume_equals_uninterrupted(corpus, tmp_path):
    """2 epochs in one run, and 1 epoch + ``restore_latest`` into a fresh
    state + 1 epoch: the same state, log and markers, bit for bit."""
    model = build_model(_config(tconfig), device="cpu", train=True)
    cfg = _config(jconfig)
    _, variables = _seeded_flax(cfg, HW, HW, seed=2)
    jopt = jstate.make_optimizer(cfg,
                                 jsched.step_decay_schedule(cfg.train, SPE))
    carried = flax_train_state_to_torch(jstate.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jopt.init(variables["params"]),
        step=jnp.zeros((), jnp.int32)), model)
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    a = _port_fit(corpus, whole, carried, torch.float32, epochs=2)
    _port_fit(corpus, split, carried, torch.float32, epochs=1)
    b = _port_fit(corpus, split, None, torch.float32, epochs=1,
                  start_epoch=1, resume=True)
    sa, sb = _snapshot(a), _snapshot(b)
    assert sa["step"] == sb["step"] and sa["count"] == sb["count"]
    for part in ("state_dict", "momentum"):
        for k, v in sa[part].items():
            np.testing.assert_array_equal(sb[part][k], v, err_msg=k)
    assert _read_log(whole) == _read_log(split)
    for ma, mb in zip(_markers(whole, (0, 1)), _markers(split, (0, 1))):
        ma.pop("time_unix")
        mb.pop("time_unix")
        assert ma == mb


def test_memory_dataset_equals_the_hdf5_corpus(tmp_path):
    cfg = tconfig.get_config("synth")
    kw = dict(num_images=3, img_size=(96, 128), people_per_image=2,
              image_size=128, seed=3, drawn=True, crowd=True)
    path = str(tmp_path / "f.h5")
    n = build_fixture(path, **kw)
    records = fixture_records(**kw)
    assert n == len(records) > 0
    h5_set = tds.CocoPoseDataset(path, cfg, seed=1)
    mem_set = tds.MemoryDataset(records, cfg, seed=1)
    try:
        for i in range(n):
            for x, y in zip(h5_set.read_raw(i), mem_set.read_raw(i)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(tds.batches(h5_set, 2, 1, wire="uint8"),
                        tds.batches(mem_set, 2, 1, wire="uint8")):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    finally:
        h5_set.close()


# ------------------------------------------------------------- the CLIs


def _cli(module, *args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", f"improved_body_parts_torch.cli.{module}",
         *args], capture_output=True, text=True, env=env, timeout=600,
        cwd=cwd)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout


def test_synth_ap_cli_end_to_end(tmp_path):
    out, work = tmp_path / "ap.json", tmp_path / "work"
    _cli("synth_ap", "--config", "synth", "--train-images", "6",
         "--val-images", "2", "--epochs", "2", "--device", "cpu",
         "--decode-path", "device", "--workdir", str(work),
         "--out", str(out), cwd=str(tmp_path))
    result = json.loads(out.read_text())
    assert result["epochs"] == 2 and result["decode_path"] == "device"
    assert result["train_records"] > 0 and result["val_persons"] > 0
    for key in ("ap_trained", "ap_untrained"):
        assert 0.0 <= result[key] <= 1.0, (key, result[key])
    assert len(result["train_loss_curve"]) == 2
    assert result["train_loss_first"] == result["train_loss_curve"][0]
    reports = result["cli_reports"]
    for name in ("train", "evaluate_trained", "evaluate_untrained"):
        (rep,) = reports[name]
        assert rep["device"] == "cpu"
        # the plain versions run on the CPU: no kernel launches
        assert set(rep["launches"].values()) == {0}
    train = reports["train"][0]
    batch = tconfig.get_config("synth").train.batch_size_per_device
    assert train["steps"] == 2 * (result["train_records"] // batch) > 0
    assert train["images"] == batch * train["steps"]
    assert len(train["save_blocked_ms"]) == len(train["save_write_ms"]) == 2
    assert not (tmp_path / "results").exists()
    assert (work / "results" / "person_keypoints_synth_trained.json").exists()

    # the train CLI resumes from the last committed epoch
    ckpt = str(work / "ckpt")
    stdout = _cli("train", "--config", "synth", "--epochs", "1",
                  "--train-h5", str(work / "train_drawn.h5"),
                  "--checkpoint-dir", ckpt, "--resume", "auto",
                  "--device", "cpu")
    assert "resumed from" in stdout and "(epoch 1)" in stdout
    assert _read_log(ckpt).count("train_loss: ") == 3
    assert read_commit_meta(os.path.join(ckpt, "epoch_2"))["epoch"] == 2

    # the demo CLI draws over a val image with the trained checkpoint
    image = str(work / "val" / "000000000001.jpg")
    drawn = str(tmp_path / "demo.jpg")
    stdout = _cli("demo", "--config", "synth", "--checkpoint",
                  result["checkpoint"], "--image", image, "--output", drawn,
                  "--boxsize", "128", "--device-decode", "--device", "cpu")
    assert os.path.exists(drawn) and "people ->" in stdout
