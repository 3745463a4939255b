"""Port parity of the training slice, on the CPU in fp32.

The tiny IMHN (2 stacks, 16 channels, depth 2, 3 scales) at 64x64 on
batches of 2 from a drawn fixture, unit-scale seeded weights, fp32
compute in both packages:

- the lr schedules equal the JAX ones within rel 1e-7 over steps 0-400
  (warmup, a decay step, the large-batch ramp, the SWA sawtooth);
- one train-mode forward on converted weights: predictions and the
  updated BN running stats within rtol 1e-4 / atol 1e-5 of
  ``model.apply(train=True, mutable=["batch_stats"])`` (the running
  variance is updated with the biased batch variance, as Flax does);
- the step: a JAX ``TrainState`` after one ``make_train_step`` step
  (momentum non-zero) carried across, then 3 more steps on the same
  batches in both packages give the same losses, params, BN running stats
  and momentum (atol/rtol 1e-5), step and update count; compared in
  float64, for the reason the test's docstring gives, and the float32
  port's next loss within rel 1e-4;
- an abnormal batch (labels + 1e6) leaves params, BN buffers and
  momentum bitwise unchanged, keeps the update count, and counts the step;
- ``apply_guarded_update`` on given gradients against the JAX one through
  warmup, a clip and two dropped steps: rtol 1e-6;
- ``make_eval_step`` within rel 1e-5 of the JAX one;
- ``train_epoch`` over ``batches`` of a 4-record fixture: mean loss within
  rel 1e-4 of the JAX ``train_epoch(mesh=None)``;
- SWA averaging; the options not ported yet raise naming ROADMAP, and a
  mesh that is not a ``parallel.make_mesh`` mesh is refused.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.data import dataset as tds
from improved_body_parts_torch.data.fixture import build_fixture
from improved_body_parts_torch.models import (
    build_model,
    flax_to_state_dict,
    flax_train_state_to_torch,
    load_flax_variables,
)
from improved_body_parts_torch.train import loop as tloop
from improved_body_parts_torch.train import schedule as tsched
from improved_body_parts_torch.train import state as tstate
from improved_body_parts_torch.train import step as tstep
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.train import loop as jloop
from improved_body_parts_tpu.train import schedule as jsched
from improved_body_parts_tpu.train import state as jstate
from improved_body_parts_tpu.train import step as jstep

sys.path.insert(0, "tests")
from test_torch_models import _seeded_flax  # noqa: E402

HW, BATCH, SPE = 64, 2, 2  # image side, batch, steps per epoch


def _config(mod):
    cfg = mod.get_config("tiny")
    return dataclasses.replace(
        cfg, skeleton=dataclasses.replace(cfg.skeleton, width=HW, height=HW),
        train=dataclasses.replace(cfg.train, bf16_compute=False,
                                  learning_rate_per_device=2e-3,
                                  print_freq=1))


# ------------------------------------------------------------ schedules


def _sched_pairs():
    tcfg, jcfg = _config(tconfig).train, _config(jconfig).train
    big = dict(lr_batch_ref=4, large_batch_warmup_epochs=2)
    tbig = dataclasses.replace(tcfg, **big)
    jbig = dataclasses.replace(jcfg, **big)
    return {
        "step_decay": (tsched.step_decay_schedule(tcfg, 20, world_size=2),
                       jsched.step_decay_schedule(jcfg, 20, world_size=2)),
        "no_warmup": (tsched.step_decay_schedule(tcfg, 20, use_warmup=False),
                      jsched.step_decay_schedule(jcfg, 20, use_warmup=False)),
        "large_batch": (tsched.large_batch_schedule(tbig, 20, 16),
                        jsched.large_batch_schedule(jbig, 20, 16)),
        "large_batch_small": (tsched.large_batch_schedule(tbig, 20, 4),
                              jsched.large_batch_schedule(jbig, 20, 4)),
        "cyclic": (tsched.cyclic_swa_schedule(20, 5, start_step=30),
                   jsched.cyclic_swa_schedule(20, 5, start_step=30)),
        "cyclic_flat": (tsched.cyclic_swa_schedule(20, 1),
                        jsched.cyclic_swa_schedule(20, 1)),
    }


@pytest.mark.parametrize("name", sorted(_sched_pairs()))
def test_schedules_match_jax(name):
    got_fn, want_fn = _sched_pairs()[name]
    steps = np.arange(401)
    want = np.array([float(want_fn(int(s))) for s in steps], np.float32)
    got = np.array([got_fn(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got_fn(steps), got)  # the table form
    assert len(np.unique(want)) > 1 or name == "cyclic_flat"


# ----------------------------------------------------------- the model


def _tiny_variables(seed=0):
    cfg = _config(jconfig)
    jmodel, variables = _seeded_flax(cfg, HW, HW, seed=seed)
    return cfg, jmodel, variables


def test_train_mode_forward_and_bn_update_match_flax():
    cfg, jmodel, variables = _tiny_variables(seed=2)
    img = np.random.default_rng(3).uniform(0, 1, (BATCH, HW, HW, 3)).astype(
        np.float32)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, img)
    model = build_model(_config(tconfig), device="cpu", train=True)
    load_flax_variables(model, variables)
    got = model(torch.from_numpy(img))
    for i, (ws, gs) in enumerate(zip(want, got)):
        for j, (a, b) in enumerate(zip(ws, gs)):
            assert b.requires_grad
            a = np.asarray(a)
            np.testing.assert_allclose(b.detach().numpy(), a, rtol=1e-4,
                                       atol=1e-4 * np.abs(a).max(),
                                       err_msg=f"stack {i} scale {j}")
    want_sd = flax_to_state_dict({"params": variables["params"],
                                  "batch_stats": mutated["batch_stats"]},
                                 model)
    sd = model.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 50
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the unbiased update of nn.BatchNorm2d would move the variances away
    moved = [k for k in keys if k.endswith("running_var")
             and not np.allclose(sd[k].numpy(),
                                 flax_to_state_dict(variables, model)[k]
                                 .numpy())]
    assert moved


# ------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Fixture batches, the JAX fp32 step, and the JAX state after one
    step (the state every port test starts from)."""
    path = str(tmp_path_factory.mktemp("train") / "fixture.h5")
    n = build_fixture(path, num_images=2, img_size=(120, 160),
                      people_per_image=2, image_size=HW, seed=0, drawn=True)
    assert n == 2 * SPE
    tcfg = _config(tconfig)
    jcfg, jmodel, variables = _tiny_variables()
    dset = tds.CocoPoseDataset(path, tcfg)
    batches = [b for epoch in range(3)
               for b in tds.batches(dset, BATCH, epoch, wire="uint8")]
    dset.close()

    jopt = jstate.make_optimizer(jcfg,
                                 jsched.step_decay_schedule(jcfg.train, SPE))
    params = variables["params"]
    state0 = jstate.TrainState(params=params,
                               batch_stats=variables["batch_stats"],
                               opt_state=jopt.init(params),
                               step=jnp.zeros((), jnp.int32))
    jtrain = jstep.make_train_step(jmodel, jcfg, jopt, donate=False)
    state1, _ = jtrain(state0, *batches[0])
    return dict(tcfg=tcfg, jcfg=jcfg, jmodel=jmodel, jopt=jopt,
                jtrain=jtrain, state1=state1, batches=batches, path=path)


def _port_state(setup, dtype=torch.float32):
    """A fresh port state (parameters in ``dtype``) carried across from
    the JAX state after one step, with its train step."""
    cfg = setup["tcfg"]
    model = build_model(cfg, device="cpu", train=True).to(dtype)
    opt = tstate.make_optimizer(model, cfg,
                                tsched.step_decay_schedule(cfg.train, SPE))
    state = tstate.create_train_state(model, cfg, opt)
    tstate.load_carried_state(
        state, flax_train_state_to_torch(setup["state1"], model))
    return state, tstep.make_train_step(model, cfg, opt)


def _snapshot(state):
    """The port state as the converter lays out a JAX one (float32)."""
    sd = {k: v.detach().to(torch.float32 if v.is_floating_point()
                           else v.dtype).clone().numpy()
          for k, v in state.model.state_dict().items()}
    names = {p: n for n, p in state.model.named_parameters()}
    mom = {names[p]: b.to(torch.float32).clone().numpy()
           for p, b in zip(state.optimizer.params, state.optimizer.momentum)}
    return {"state_dict": sd, "momentum": mom,
            "count": int(state.optimizer.count), "step": state.step}


@pytest.fixture(scope="module")
def jax64(setup):
    """The JAX side in float64 from the carried state: the losses of 3
    more steps and the state after them, and train_epoch's mean loss."""
    from improved_body_parts_tpu.data import dataset as jds
    from improved_body_parts_tpu.models import build_model as jbuild

    with jax.enable_x64(True):
        jmodel = jbuild(setup["jcfg"], dtype=jnp.float64)
        jtrain = jstep.make_train_step(jmodel, setup["jcfg"], setup["jopt"],
                                       donate=False)

        def f64(x):
            return (jnp.asarray(x, jnp.float64)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x)

        start = jax.tree.map(f64, setup["state1"])
        st, losses = start, []
        for batch in setup["batches"][1:4]:
            st, loss = jtrain(st, *batch)
            losses.append(float(loss))
        jset = jds.CocoPoseDataset(setup["path"], setup["jcfg"])
        _, epoch_loss = jloop.train_epoch(
            start, jtrain,
            jds.batches(jset, BATCH, 1, pipeline="sync", wire="uint8"),
            setup["jcfg"], 1, log_fn=lambda s: None)
        jset.close()
        final = jax.tree.map(np.asarray, st)
    return dict(losses=losses, final=final, epoch_loss=epoch_loss)


def test_carried_state_takes_the_same_three_steps(setup, jax64):
    """Compared in float64 on both sides: in float32 JAX's own gradient
    is 2e-2 (relative, at the backbone) away from its float64 value on
    this net, where the port's is 7e-4 away and the two float64
    gradients agree to 6e-7 (measured on the tiny net's train-mode
    gradient).  Train-mode BatchNorm over 32 samples a channel amplifies
    float32 rounding (Flax's fast variance cancels), so a float32
    comparison could only pin the trajectory to a few percent; in
    float64 it holds params, BN running stats and momentum to atol 1e-5,
    rtol 1e-5 (compared after rounding to float32), losses (summed in
    float32 from the float32 predictions) to rel 1e-5."""
    state, train_step = _port_state(setup, torch.float64)
    assert state.step == 1 and int(state.optimizer.count) == 1
    assert any(b.abs().max() > 0 for b in state.optimizer.momentum)
    start = _snapshot(state)
    for batch, want in zip(setup["batches"][1:4], jax64["losses"]):
        state, loss = train_step(state, *batch)
        assert float(loss) == pytest.approx(want, rel=1e-5)
    got = _snapshot(state)
    want = flax_train_state_to_torch(jax64["final"], state.model)
    assert got["step"] == want["step"] == 4
    assert got["count"] == want["count"] == 4
    for part in ("state_dict", "momentum"):
        for k, w in want[part].items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[part][k], w, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{part} {k}")
    # the three steps moved every kind of state
    moved = {part: max(float(np.abs(got[part][k] - start[part][k]).max())
                       for k in start[part]
                       if not k.endswith("num_batches_tracked"))
             for part in ("state_dict", "momentum")}
    assert moved["state_dict"] > 1e-3 and moved["momentum"] > 1e-2


def test_first_step_loss_matches_in_float32(setup):
    """The float32 port from the carried state: the next step's loss
    (computed before its update) within rel 1e-4 of JAX's."""
    state, train_step = _port_state(setup)
    batch = setup["batches"][1]
    _, loss = train_step(state, *batch)
    _, want = setup["jtrain"](setup["state1"], *batch)
    assert float(loss) == pytest.approx(float(want), rel=1e-4)


def test_abnormal_batch_leaves_the_state_bitwise_and_counts_the_step(setup):
    state, train_step = _port_state(setup)
    images, mask, labels = setup["batches"][1]
    before = _snapshot(state)
    state, loss = train_step(state, images, mask, labels + 1e6)
    assert float(loss) > setup["tcfg"].train.abnormal_loss_thre
    after = _snapshot(state)
    assert after["step"] == before["step"] + 1
    assert after["count"] == before["count"]
    for part in ("state_dict", "momentum"):
        for k, v in before[part].items():
            np.testing.assert_array_equal(after[part][k], v, err_msg=k)
    # and a normal batch after it still trains
    state, loss = train_step(state, images, mask, labels)
    assert np.isfinite(float(loss)) and int(state.optimizer.count) == 2


def test_eval_step_matches_jax(setup):
    state, _ = _port_state(setup)
    got = tstep.make_eval_step(state.model, setup["tcfg"])(
        state, *setup["batches"][2])
    want = jstep.make_eval_step(setup["jmodel"], setup["jcfg"])(
        setup["state1"], *setup["batches"][2])
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_train_epoch_matches_jax(setup, jax64):
    """``train_epoch`` over ``batches`` of the 4-record fixture, float64
    on both sides as in the step test: mean loss within rel 1e-4."""
    state, train_step = _port_state(setup, torch.float64)
    tset = tds.CocoPoseDataset(setup["path"], setup["tcfg"])
    logs = []
    state, got = tloop.train_epoch(
        state, train_step, tds.batches(tset, BATCH, 1, wire="uint8"),
        setup["tcfg"], 1, log_fn=logs.append)
    tset.close()
    assert got == pytest.approx(jax64["epoch_loss"], rel=1e-4)
    assert len(logs) == SPE and state.step == 1 + SPE
    with pytest.raises(TypeError, match="DeviceMesh"):
        tloop.train_epoch(state, train_step, [], setup["tcfg"], 1,
                          mesh=object())


def test_swa_running_average_and_swap():
    """``start_swa`` / ``update_swa`` / ``swap_swa_params`` follow the JAX
    package's (tests/test_training.py's values: the average of 2, 4, 6)."""
    lin = torch.nn.Linear(1, 1, bias=False)
    state = tstate.TrainState(model=lin, optimizer=None, step=7)
    with torch.no_grad():
        lin.weight.fill_(2.0)
    tstate.start_swa(state)
    assert state.swa_start_step == 7 and state.swa_count == 1
    for value, avg in ((4.0, 3.0), (6.0, 4.0)):
        with torch.no_grad():
            lin.weight.fill_(value)
        tstate.update_swa(state)
        assert float(state.swa_params["weight"]) == avg
    tstate.swap_swa_params(state)
    assert float(lin.weight.detach()) == 4.0
    assert float(state.swa_params["weight"]) == 6.0


@pytest.mark.parametrize("max_norm", [0.0, 0.5])
def test_guarded_update_matches_jax(max_norm):
    """``apply_guarded_update`` on given gradients against the JAX one
    (optax chain): clip (when ``max_grad_norm > 0``), weight decay,
    momentum, the lr of the update count through warmup, and the guard
    over a non-finite and an abnormal loss, which keep params, momentum
    and count while the step counts.  rtol 1e-6: the same float32 ops,
    some fused or reordered."""
    tcfg, jcfg = (dataclasses.replace(c, train=dataclasses.replace(
        c.train, max_grad_norm=max_norm, on_divergence="skip_step"))
        for c in (_config(tconfig), _config(jconfig)))
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    b0 = rng.normal(size=(3,)).astype(np.float32)
    losses = [1.0, float("inf"), 2.0, 1e9, 3.0]
    grads = [(rng.normal(size=w0.shape).astype(np.float32),
              rng.normal(size=b0.shape).astype(np.float32))
             for _ in losses]

    jopt = jstate.make_optimizer(jcfg,
                                 jsched.step_decay_schedule(jcfg.train, SPE))
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    jst = jstate.TrainState(params=params, batch_stats={},
                            opt_state=jopt.init(params),
                            step=jnp.zeros((), jnp.int32))
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
        lin.bias.copy_(torch.from_numpy(b0))
    opt = tstate.make_optimizer(lin, tcfg,
                                tsched.step_decay_schedule(tcfg.train, SPE))
    state = tstate.create_train_state(lin, tcfg, opt)
    for loss, (gw, gb) in zip(losses, grads):
        jst, _, jnorm = jstep.apply_guarded_update(
            jst, jnp.float32(loss), {"w": gw, "b": gb}, {}, jcfg, jopt,
            health=True)
        lin.weight.grad = torch.from_numpy(gw.copy())
        lin.bias.grad = torch.from_numpy(gb.copy())
        state, _, norm = tstep.apply_guarded_update(
            state, torch.tensor(loss), [], tcfg, health=True)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
        got = _snapshot(state)
        want = _jax_linear_state(jst)
        np.testing.assert_allclose(got["state_dict"]["weight"], want["w"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["state_dict"]["bias"], want["b"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["momentum"]["weight"], want["tw"],
                                   rtol=1e-6, atol=1e-7)
        assert got["count"] == want["count"] and got["step"] == want["step"]
    assert state.step == len(losses) and got["count"] == 3


def _jax_linear_state(jst):
    """The JAX state of the one-layer test as numpy: params, the
    momentum trace of the weight, the update count and the step."""
    def record(field):
        return next(s for s in jax.tree.leaves(
            jst.opt_state,
            is_leaf=lambda x: field in getattr(x, "_fields", ()))
            if field in getattr(s, "_fields", ()))

    trace, count = record("trace"), record("count")
    return {"w": np.asarray(jst.params["w"]), "b": np.asarray(jst.params["b"]),
            "tw": np.asarray(trace.trace["w"]), "count": int(count.count),
            "step": int(jst.step)}


def test_unported_training_options_name_the_roadmap():
    cfg = _config(tconfig)
    model = build_model(cfg, device="cpu", train=True)
    opt = tstate.make_optimizer(model, cfg,
                                tsched.step_decay_schedule(cfg.train, SPE))
    # mesh / rules are ported (tests/test_torch_dist.py); a mesh that is
    # not a parallel.make_mesh DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(model, cfg, opt, mesh=object(),
                              rules=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(tds.batches(None, BATCH, 0, pipeline="pool"))
