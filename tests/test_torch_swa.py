"""The port's SWA stage (``cli.train --swa``) and its checkpoint fields.

- The stage's arithmetic against the JAX package's in float64: from the
  JAX package's own init after one train-mode step (the unit-scale
  weights ``test_torch_train.py`` carries make the frozen-BN forward's
  loss 5e6, past ``abnormal_loss_thre``, so every SWA step would be
  dropped),
  ``start_swa``, the cyclic schedule anchored at the step SWA began, two
  epochs of frozen-BN steps, ``update_swa`` at the cycle's end and the
  swap, in both packages: losses within rel 1e-4 (each is summed in
  float32 from float32 predictions, over 3e4 terms, in another order
  in each package: 9e-6 apart on the very first, update-free step);
  the live parameters,
  the average and the momentum within rtol 1e-5 and an atol of 1e-5 of
  each tensor's largest magnitude; BN running stats unchanged bit for
  bit; ``swa_count`` 2 and ``swa_start_step`` 1 in both.
- The checkpoint: ``swa_params``, ``swa_count`` and ``swa_start_step``
  survive ``save_checkpoint`` / ``restore_checkpoint`` (and the async
  manager), and a checkpoint without them restores ``None``.
- ``cli.train.train(swa=True)`` end to end on the CPU over a resumed
  plain checkpoint: BN running stats bit for bit the checkpoint's, the
  saved checkpoints carry the average (model) and the trained weights
  (``swa_params``), ``swa_count`` as the schedule says (one update per
  ``swa_freq`` epochs plus the trailing one), a resume of the SWA
  checkpoint continues in phase; ``--swa`` with ``--lr`` is refused.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch.cli.train import state_digest, train
from improved_body_parts_torch.data import MemoryDataset
from improved_body_parts_torch.data.fixture import fixture_records
from improved_body_parts_torch.models import (
    build_model,
    flax_train_state_to_torch,
    flax_to_state_dict,
)
from improved_body_parts_torch.train import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from improved_body_parts_torch.train import schedule as tsched
from improved_body_parts_torch.train import state as tstate
from improved_body_parts_torch.train import step as tstep
from improved_body_parts_tpu.train import schedule as jsched
from improved_body_parts_tpu.train import state as jstate
from improved_body_parts_tpu.train import step as jstep

sys.path.insert(0, "tests")
from test_torch_train import SPE, _snapshot, setup  # noqa: E402,F401
from test_torch_models import one_torch_thread  # noqa: E402,F401
from improved_body_parts_torch import config as tconfig  # noqa: E402

LR_MAX, LR_MIN, FREQ = 2e-3, 2e-4, 2


def _bn_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_swa_stage_matches_jax_in_float64(setup):
    from improved_body_parts_tpu.models import build_model as jbuild

    batches = setup["batches"][1:1 + 2 * SPE]
    with jax.enable_x64(True):
        jcfg = setup["jcfg"]
        jmodel = jbuild(jcfg, dtype=jnp.float64)
        sched = jsched.cyclic_swa_schedule(SPE, FREQ, lr_max=LR_MAX,
                                           lr_min=LR_MIN, start_step=1)
        jopt = jstate.make_optimizer(jcfg, sched)
        variables = jax.jit(lambda k: setup["jmodel"].init(
            k, jnp.zeros((1, 64, 64, 3), jnp.float32)))(
                jax.random.PRNGKey(0))
        params = variables["params"]
        jst = jstate.TrainState(params=params,
                                batch_stats=variables["batch_stats"],
                                opt_state=setup["jopt"].init(params),
                                step=jnp.zeros((), jnp.int32))
        jst, _ = setup["jtrain"](jst, *setup["batches"][0])  # float32
        jst = jax.tree.map(
            lambda a: (jnp.asarray(a, jnp.float64)
                       if jnp.issubdtype(a.dtype, jnp.floating) else a),
            jst)
        start = jax.tree.map(np.asarray, jst)
        jst = jstate.start_swa(jst)
        jtrain = jstep.make_train_step(jmodel, jcfg, jopt, freeze_bn=True,
                                       donate=False)
        want_losses = []
        for batch in batches:
            jst, loss = jtrain(jst, *batch)
            want_losses.append(float(loss))
        jst = jstate.update_swa(jst)
        live = jax.tree.map(np.asarray, jst)
        swapped = jax.tree.map(np.asarray, jstate.swap_swa_params(jst))

    cfg = setup["tcfg"]
    model = build_model(cfg, device="cpu", train=True).to(torch.float64)
    opt = tstate.make_optimizer(model, cfg,
                                tsched.step_decay_schedule(cfg.train, SPE))
    state = tstate.create_train_state(model, cfg, opt)
    tstate.load_carried_state(state, flax_train_state_to_torch(start, model))
    state.optimizer.schedule = tsched.cyclic_swa_schedule(
        SPE, FREQ, lr_max=LR_MAX, lr_min=LR_MIN, start_step=1)
    state.optimizer._lrs = state.optimizer._lrs[:0]
    tstate.start_swa(state)
    bn = _bn_stats(state.model)
    step = tstep.make_train_step(state.model, cfg, state.optimizer,
                                 freeze_bn=True)
    for batch, want in zip(batches, want_losses):
        state, loss = step(state, *batch)
        assert float(loss) == pytest.approx(want, rel=1e-4)
    assert int(state.optimizer.count) == 5  # no step was dropped
    tstate.update_swa(state)
    assert state.swa_count == int(live.swa_count) == 2
    assert state.swa_start_step == int(live.swa_start_step) == 1
    for k, v in _bn_stats(state.model).items():
        assert torch.equal(v, bn[k]), k

    def close(got, want, what):
        np.testing.assert_allclose(
            got, want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(want).max()), 1.0), err_msg=what)

    got = _snapshot(state)
    want = flax_train_state_to_torch(live, state.model)
    for part in ("state_dict", "momentum"):
        for k, w in want[part].items():
            if not k.endswith("num_batches_tracked"):
                close(got[part][k], w, f"{part} {k}")
    avg = flax_to_state_dict({"params": swapped.params,
                              "batch_stats": swapped.batch_stats},
                             state.model)
    for name, t in state.swa_params.items():
        close(t.to(torch.float32).numpy(), avg[name].numpy(), f"swa {name}")


def _tiny_state(swa: bool):
    cfg = tconfig.get_config("tiny")
    model = build_model(cfg, device="cpu", seed=3, train=True)
    opt = tstate.make_optimizer(model, cfg,
                                tsched.step_decay_schedule(cfg.train, 4))
    state = tstate.create_train_state(model, cfg, opt)
    state.step = 7
    if swa:
        tstate.start_swa(state)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        tstate.update_swa(state)
    return cfg, state


@pytest.mark.parametrize("swa", [True, False])
def test_checkpoint_round_trip_of_the_swa_fields(tmp_path, swa):
    cfg, state = _tiny_state(swa)
    path = save_checkpoint(str(tmp_path / "sync"), state, 0, 1.0, 1.0)
    with CheckpointManager(str(tmp_path / "async")) as manager:
        apath = manager.save(state, 0, 1.0, 1.0)
    for p in (path, apath):
        payload = restore_checkpoint(p)
        _, fresh = _tiny_state(False)
        fresh, _ = restore_checkpoint(p, fresh)
        if not swa:
            assert payload["swa_params"] is None
            assert fresh.swa_params is None and fresh.swa_count is None
            assert fresh.swa_start_step is None
            continue
        assert payload["swa_count"] == fresh.swa_count == 2
        assert payload["swa_start_step"] == fresh.swa_start_step == 7
        assert state_digest(fresh.swa_params) == state_digest(
            state.swa_params)
        assert state_digest(fresh.model.state_dict()) == state_digest(
            state.model.state_dict())


def test_swa_stage_through_the_cli_train_function(tmp_path):
    cfg = tconfig.get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path), print_freq=2))
    records = fixture_records(num_images=4, people_per_image=2,
                              image_size=128, seed=1, drawn=True)
    ds = MemoryDataset(records, cfg, seed=1)
    spe = len(ds) // cfg.train.batch_size_per_device
    base, _ = train(cfg, ds, 1, device=torch.device("cpu"), seed=1,
                    log_fn=lambda s: None)
    bn = _bn_stats(base.model)
    kw = dict(device=torch.device("cpu"), seed=1, resume="auto", swa=True,
              swa_freq=2, swa_lr_max=1e-4, swa_lr_min=1e-5,
              log_fn=lambda s: None)
    state, report = train(cfg, ds, 3, **kw)
    assert report["steps"] == 3 * spe
    # one update at the cycle's end (epoch 2), one for the trailing epoch
    assert state.swa_count == 3 and state.swa_start_step == spe
    for k, v in _bn_stats(state.model).items():
        assert torch.equal(v, bn[k]), k
    saved = restore_checkpoint(str(tmp_path / "epoch_3"))
    assert saved["swa_count"] == 3 and saved["swa_start_step"] == spe
    live = {n: p for n, p in state.model.named_parameters()}
    for name, t in saved["swa_params"].items():
        assert torch.equal(t, live[name].detach())  # the trained weights
        assert torch.equal(saved["model"][name], state.swa_params[name])
    assert str(tmp_path / "epoch_2") in str(
        list((tmp_path).glob("epoch_2"))[0])
    # a resumed SWA run continues from the trained weights, in phase
    again, _ = train(cfg, ds, 1, **kw)
    assert again.swa_count == 4 and again.swa_start_step == spe
    assert again.step == 5 * spe


def test_cli_refuses_lr_with_swa():
    from improved_body_parts_torch.cli import train as cli_train

    with pytest.raises(SystemExit, match="--swa-lr-max"):
        cli_train.main(["--config", "tiny", "--swa", "--lr", "0.1",
                        "--device", "cpu"])
