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
  ``cli.train`` before any work;
- the multi-rank step (``make_distill_train_step(mesh=)``): 2 gloo ranks
  (``torch_dist_ranks.distill_two_ranks``) of the same student and
  teacher, each on its 2 rows of 2 global batches of 4, against the
  one-process step on the same batches: the first step's BN running
  stats and gradient norm within rel 1e-10, the state after two steps
  within rel 1e-8, the losses within rel 1e-6 (the bounds of
  ``test_torch_dist.py``: predictions and the loss are float32 by
  design); against JAX's one-process ``make_distill_train_step`` within
  the trajectory tolerances above; both ranks in one state, the teacher
  unchanged on each;
- ``cli.train --distill-from --num-processes 2`` trains on two ranks:
  per-rank event sinks, one checkpoint written by rank 0 and stamped with
  2 processes, equal final states.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.cli import parse_reports
from improved_body_parts_torch.cli.dist_drive import launch_ranks
from improved_body_parts_torch.cli.train import state_digest
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data.fixture import build_fixture
from improved_body_parts_torch.models import (
    build_model,
    flax_to_state_dict,
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
import torch_dist_ranks  # noqa: E402
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


# ------------------------------------------------------ two ranks (mesh)
def _float64_sd(cfg, variables):
    model = build_model(cfg, device="cpu", train=True)
    return {k: (v.numpy().astype(np.float64) if v.is_floating_point()
                else v.numpy())
            for k, v in flax_to_state_dict(variables, model).items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, one_torch_thread):  # noqa: F811
    """2 global batches of 4 drawn rows; the one-process float64 distill
    step and the 2-rank one on them, from the same seeded weights."""
    path = str(tmp_path_factory.mktemp("distill2") / "fixture.h5")
    build_fixture(path, num_images=4, img_size=(120, 160),
                  people_per_image=2, image_size=HW, seed=1, drawn=True)
    cfg = _config(tconfig, "tiny_student")
    teacher_cfg = _config(tconfig, "tiny")
    dset = tds.CocoPoseDataset(path, cfg)
    batches = [b for epoch in range(2)
               for b in tds.batches(dset, 4, epoch, wire="uint8")]
    dset.close()
    _, student_vars = _seeded_flax(_config(jconfig, "tiny_student"), HW, HW,
                                   seed=4)
    _, teacher_vars = _seeded_flax(_config(jconfig, "tiny"), HW, HW, seed=5)
    payload = dict(cfg=cfg, teacher_cfg=teacher_cfg, batches=batches,
                   student=_float64_sd(cfg, student_vars),
                   teacher=_float64_sd(teacher_cfg, teacher_vars))
    state, teacher = torch_dist_ranks.distill_states(
        cfg, teacher_cfg, payload["student"], payload["teacher"])
    step = tdistill.bind_teacher(tdistill.make_distill_train_step(
        state.model, teacher, cfg, state.optimizer, health=True), teacher)
    steps, first = [], None
    for batch in batches:
        state, loss, gnorm = step(state, *batch)
        steps.append((float(loss), float(gnorm)))
        if first is None:
            first = torch_dist_ranks._full(state)
    ranks = torch_dist_ranks.spawn_group(torch_dist_ranks.distill_two_ranks,
                                         2, payload)
    return dict(steps=steps, first=first,
                single=torch_dist_ranks._full(state), ranks=ranks,
                jax=_jax64(dict(batches=batches, student=student_vars,
                                teacher=teacher_vars)),
                student=state.model)


def test_two_rank_distill_equals_the_one_process_step(two_ranks):
    r0 = two_ranks["ranks"][0]
    (_, g1), (_, g2) = r0["steps"]
    (_, w1), (_, w2) = two_ranks["steps"]
    assert g1 == pytest.approx(w1, rel=1e-10)
    assert g2 == pytest.approx(w2, rel=1e-8)
    for (loss, _), (want, _) in zip(r0["steps"], two_ranks["steps"]):
        assert loss == pytest.approx(want, rel=1e-6)
    stats = [k for k in two_ranks["first"]
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert _rel(r0["first"][k], two_ranks["first"][k]) <= 1e-10, k
    for k, w in two_ranks["single"].items():
        if k.startswith(("model/", "momentum/")) and w.dtype.kind == "f":
            assert _rel(r0["state"][k], w) <= 1e-8, k


def test_two_rank_distill_ranks_agree_and_leave_the_teacher(two_ranks):
    r0, r1 = two_ranks["ranks"][0], two_ranks["ranks"][1]
    assert r0["steps"] == r1["steps"]
    assert r0["state_sha"] == r1["state_sha"]
    assert r0["teacher_unchanged"] and r1["teacher_unchanged"]


def test_two_rank_distill_matches_jax_in_float64(two_ranks):
    want_losses, want_state = two_ranks["jax"]
    for (loss, _), want in zip(two_ranks["ranks"][0]["steps"], want_losses):
        assert loss == pytest.approx(want, rel=1e-5)
    want = flax_train_state_to_torch(want_state, two_ranks["student"])
    got = two_ranks["ranks"][0]["state"]
    for part, prefix in (("state_dict", "model/"), ("momentum",
                                                     "momentum/")):
        for k, w in want[part].items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(
                    got[prefix + k], w, rtol=1e-5,
                    atol=1e-5 * max(float(np.abs(w).max()), 1.0),
                    err_msg=f"{part} {k}")


def test_cli_distills_on_two_processes(tmp_path):
    """A ``tiny`` teacher trained by the CLI, then ``tiny_student``
    distilled from it by two ranks of the CLI."""
    import json
    import os

    from improved_body_parts_torch.cli import train as cli_train

    h5 = str(tmp_path / "c.h5")
    assert build_fixture(h5, num_images=4, img_size=(96, 128),
                         people_per_image=2, image_size=128, seed=0,
                         drawn=True) == 4
    teacher_dir = str(tmp_path / "teacher")
    cli_train.main(["--config", "tiny", "--epochs", "1", "--train-h5", h5,
                    "--checkpoint-dir", teacher_dir, "--workers", "0",
                    "--device", "cpu"])
    ckpt = str(tmp_path / "student")
    logs = [str(tmp_path / f"rank{r}.log") for r in range(2)]
    rcs = launch_ranks(2, ["--config", "tiny_student", "--train-h5", h5,
                           "--val-h5", h5, "--checkpoint-dir", ckpt,
                           "--epochs", "1", "--workers", "0", "--device",
                           "cpu", "--telemetry-sink", "auto",
                           "--distill-from", teacher_dir,
                           "--teacher-config", "tiny"],
                       lambda r: logs[r], timeout_s=240)
    out = [open(p).read() for p in logs]
    assert rcs == [0, 0], out[0][-2000:] + out[1][-2000:]
    assert all("distilling from" in o for o in out)
    reports = [parse_reports(o)[0] for o in out]
    assert [r["process_id"] for r in reports] == [0, 1]
    assert all(r["num_processes"] == 2 and r["steps"] == 2
               for r in reports)
    assert reports[0]["state_sha256"] == reports[1]["state_sha256"]
    assert os.path.isfile(os.path.join(ckpt, "events.jsonl"))
    assert os.path.isfile(os.path.join(ckpt, "events.jsonl.p1"))
    assert sorted(d for d in os.listdir(ckpt)
                  if d.startswith("epoch_")) == ["epoch_0"]
    meta = json.load(open(os.path.join(ckpt, "epoch_0", "COMMIT.json")))
    assert meta["topology"]["process_count"] == 2
