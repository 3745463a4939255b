"""Port parity: heatmap distillation (``train.distill``).

- ``distill_alpha`` equals the JAX package's over a warm-up ramp and
  after it (float32 arithmetic on both sides: exact);
- the trajectory: a ``tiny_student`` (1 stack, 8 channels) distilled from
  a ``tiny`` teacher (2 stacks, 16 channels) at 64x64, both from seeded
  Flax trees, 3 steps on fixture batches through the alpha ramp, against
  JAX's ``make_distill_train_step``.  Compared in float64 on both sides,
  as ``test_torch_train.py`` compares the supervised step (train-mode BN
  over few samples amplifies float32 rounding): losses within rel 1e-5,
  the student's params, BN running stats and momentum within rtol 1e-5
  and an atol of 1e-5 times the tensor's largest magnitude (rounded to
  float32; both steps compute the loss in float32 from float32
  predictions, as the JAX model casts them, so an element of a
  momentum buffer whose entries reach 50 can move by 3e-5);
- the teacher is in no optimizer and is not written (its ``state_dict``
  SHA-256 is unchanged), and a teacher of another skeleton is refused by
  ``cli.train`` before any work.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.cli.train import state_digest
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data.fixture import build_fixture
from improved_body_parts_torch.models import (
    build_model,
    flax_train_state_to_torch,
    load_flax_variables,
)
from improved_body_parts_torch.train import distill as tdistill
from improved_body_parts_torch.train import schedule as tsched
from improved_body_parts_torch.train import state as tstate
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.train import distill as jdistill
from improved_body_parts_tpu.train import schedule as jsched
from improved_body_parts_tpu.train import state as jstate

sys.path.insert(0, "tests")
from test_torch_models import _seeded_flax, one_torch_thread  # noqa: E402,F401
from test_torch_train import _snapshot  # noqa: E402

HW, BATCH, SPE, WARM = 64, 2, 2, 2


def _config(mod, name):
    cfg = mod.get_config(name)
    return dataclasses.replace(
        cfg, skeleton=dataclasses.replace(cfg.skeleton, width=HW, height=HW),
        train=dataclasses.replace(cfg.train, bf16_compute=False,
                                  learning_rate_per_device=2e-3,
                                  distill_alpha_warmup_steps=WARM))


def test_alpha_schedule_matches_jax():
    tcfg, jcfg = (_config(tconfig, "tiny_student"),
                  _config(jconfig, "tiny_student"))
    for step in range(6):
        assert tdistill.distill_alpha(tcfg, step) == float(
            jdistill.distill_alpha(jcfg, jnp.asarray(step, jnp.int32)))
    assert tdistill.distill_alpha(tcfg, 0) == 1.0
    assert tdistill.distill_alpha(tcfg, 5) == pytest.approx(0.5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("distill") / "fixture.h5")
    build_fixture(path, num_images=2, img_size=(120, 160),
                  people_per_image=2, image_size=HW, seed=0, drawn=True)
    tcfg = _config(tconfig, "tiny_student")
    dset = tds.CocoPoseDataset(path, tcfg)
    batches = [b for epoch in range(2)
               for b in tds.batches(dset, BATCH, epoch, wire="uint8")]
    dset.close()
    _, student_vars = _seeded_flax(_config(jconfig, "tiny_student"), HW, HW,
                                   seed=4)
    _, teacher_vars = _seeded_flax(_config(jconfig, "tiny"), HW, HW, seed=5)
    return dict(batches=batches[:3], student=student_vars,
                teacher=teacher_vars)


def _jax64(setup):
    from improved_body_parts_tpu.models import build_model as jbuild

    jcfg = _config(jconfig, "tiny_student")
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        student = jbuild(jcfg, dtype=jnp.float64)
        teacher = jbuild(_config(jconfig, "tiny"), dtype=jnp.float64)
        opt = jstate.make_optimizer(
            jcfg, jsched.step_decay_schedule(jcfg.train, SPE))
        params = f64(setup["student"]["params"])
        st = jstate.TrainState(
            params=params, batch_stats=f64(setup["student"]["batch_stats"]),
            opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))
        step = jdistill.bind_teacher(
            jdistill.make_distill_train_step(student, teacher, jcfg, opt,
                                             donate=False),
            f64(setup["teacher"]))
        losses = []
        for batch in setup["batches"]:
            st, loss = step(st, *batch)
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, st)


def test_trajectory_matches_jax_in_float64(setup):
    want_losses, want_state = _jax64(setup)
    cfg = _config(tconfig, "tiny_student")
    student = build_model(cfg, device="cpu", train=True)
    load_flax_variables(student, setup["student"])
    student.double()
    teacher = build_model(_config(tconfig, "tiny"), device="cpu")
    load_flax_variables(teacher, setup["teacher"])
    teacher.double()
    teacher_sha = state_digest(teacher.state_dict())
    opt = tstate.make_optimizer(student, cfg,
                                tsched.step_decay_schedule(cfg.train, SPE))
    state = tstate.create_train_state(student, cfg, opt)
    step = tdistill.bind_teacher(
        tdistill.make_distill_train_step(student, teacher, cfg, opt),
        teacher)
    for batch, want in zip(setup["batches"], want_losses):
        state, loss = step(state, *batch)
        assert float(loss) == pytest.approx(want, rel=1e-5)
    got = _snapshot(state)
    want = flax_train_state_to_torch(want_state, student)
    assert got["step"] == want["step"] == 3
    for part in ("state_dict", "momentum"):
        for k, w in want[part].items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(
                    got[part][k], w, rtol=1e-5,
                    atol=1e-5 * max(float(np.abs(w).max()), 1.0),
                    err_msg=f"{part} {k}")
    assert state_digest(teacher.state_dict()) == teacher_sha
    in_opt = {id(p) for p in opt.params}
    assert not any(id(p) in in_opt for p in teacher.parameters())
    assert not teacher.training
    assert all(p.grad is None for p in teacher.parameters())


def test_cli_refuses_a_teacher_of_another_skeleton(tmp_path):
    from improved_body_parts_torch.cli import train as cli_train

    with pytest.raises(SystemExit, match="skeleton"):
        cli_train.main(["--config", "tiny", "--distill-from",
                        str(tmp_path), "--teacher-config", "dense_384",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="require --distill-from"):
        cli_train.main(["--config", "tiny", "--teacher-config", "tiny",
                        "--device", "cpu"])
