"""The port's multi-rank training on spawned gloo ranks (the CPU), in
float64: train-mode parity is a float64 question (train-mode BN over few
samples amplifies float32 rounding; ROADMAP.md standing facts).

One 2-rank group (``torch_dist_ranks.two_rank_checks``) runs, from the
same seeded weights and on the same two global batches of 4 rows, the
``replicated`` step (DDP) on a (2, 1) mesh, ``imhn_fsdp`` on (2, 1) and
``imhn`` on (1, 2), then the eval step, a 2-rank checkpoint, and the
resume of a 1-process checkpoint.  Against the 1-process step on the same
global batches:

- the BN running stats and the first step's gradient norm within rel
  1e-10 (so the gradient is not twice the single-process one), the
  update (parameters, momentum) after two steps within rel 1e-8 and the
  loss within rel 1e-6: the model's predictions, and the loss read from
  them, are float32 by design, and where the batch split moves a float64
  activation by its last bits a prediction's float32 rounding can flip
  (measured on this net: parameters 1.9e-9, momentum 6.9e-9, running
  stats 1.3e-11, first gradient norm 4.9e-13); and the update within the
  float64 trajectory tolerance (1e-5 of each leaf's largest value) of
  the JAX package's ``make_train_step(mesh=make_mesh(2),
  rules=replicated)`` on two of the 8 virtual devices, after one step;
- ``imhn_fsdp`` on (2, 1) gives the replicated update, ``imhn`` on
  (1, 2) (no batch split) the 1-process update within rel 1e-10 (measured
  bit for bit), and every split leaf and its momentum stay chunks after
  the steps;
- a float32 cross-rank BatchNorm over channels whose mean is 500 times
  their spread (where ``mean(x²) - mean(x)²`` cancels) normalises as the
  one-process ``F.batch_norm`` does: output and gradients within 1e-4
  of the largest value (measured 2.3e-5, where one process's own
  float32 output is 1.2e-5 from float64's); normalising with the fast
  formula missed by 2.7e-2 there;
- the eval step's loss is the global batch's;
- a 2-rank checkpoint resumes in one process under ``adjust`` (the saved
  state; the stamp says 2 processes) and ``refuse`` raises; a 1-process
  checkpoint resumes in 2 ranks the same way;
- ``make_train_step`` refuses a mesh without rules and rules without a
  mesh;
- ``cli.train --coordinator ... --num-processes 2`` trains 2 steps of
  ``tiny`` and writes rank 1's event sink as ``events.jsonl.p1``.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.cli import parse_reports
from improved_body_parts_torch.cli.dist_drive import launch_ranks
from improved_body_parts_torch.data.fixture import build_fixture
from improved_body_parts_torch.models import build_model, \
    flax_to_state_dict
from improved_body_parts_torch.train import (
    TopologyChanged,
    make_eval_step,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    step_decay_schedule,
)
from improved_body_parts_torch.train.supervisor import \
    reshard_on_topology_change
from improved_body_parts_tpu import config as jconfig

sys.path.insert(0, "tests")
import torch_dist_ranks  # noqa: E402
from test_torch_models import _seeded_flax  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

HW, ROWS = 64, 4
ARMS = (("replicated", (2, 1)), ("imhn_fsdp", (2, 1)), ("imhn", (1, 2)))


def _config(mod):
    cfg = mod.get_config("tiny")
    return dataclasses.replace(
        cfg, skeleton=dataclasses.replace(cfg.skeleton, width=HW, height=HW),
        train=dataclasses.replace(cfg.train, bf16_compute=False,
                                  learning_rate_per_device=2e-3))


def _batches(cfg, n=2):
    rng = np.random.default_rng(11)
    g, c = HW // cfg.skeleton.stride, cfg.skeleton.num_layers
    return [(rng.integers(0, 256, (ROWS, HW, HW, 3), dtype=np.uint8),
             (rng.uniform(0, 1, (ROWS, g, g, 1)) > 0.1).astype(np.float32),
             (rng.uniform(0, 1, (ROWS, g, g, c))
              * (rng.uniform(0, 1, (ROWS, g, g, c)) > 0.8)).astype(
                  np.float32)) for _ in range(n)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _worst(got, want, prefixes=("model/", "momentum/")):
    return max(_rel(got[k], w) for k, w in want.items()
               if k.startswith(prefixes) and w.dtype.kind == "f")


@pytest.fixture(scope="module")
def setup(tmp_path_factory, one_torch_thread):  # noqa: F811
    work = tmp_path_factory.mktemp("dist")
    tcfg, jcfg = _config(tconfig), _config(jconfig)
    jmodel, variables = _seeded_flax(jcfg, HW, HW, seed=4)
    model = build_model(tcfg, device="cpu", train=True)
    sd = {k: (v.numpy().astype(np.float64) if v.is_floating_point()
              else v.numpy())
          for k, v in flax_to_state_dict(variables, model).items()}
    batches = _batches(tcfg)
    rng = np.random.default_rng(5)
    bn_f32 = ((rng.uniform(20, 60, (1, 4, 1, 1)) + rng.normal(
        0, 0.08, (8, 4, 6, 6))).astype(np.float32),
        rng.normal(0, 1, (8, 4, 6, 6)).astype(np.float32))
    # the 1-process reference on the same global batches
    state = torch_dist_ranks._state(tcfg, sd)
    step = make_train_step(state.model, tcfg, state.optimizer, health=True)
    steps = []
    for batch in batches:
        state, loss, gnorm = step(state, *batch)
        steps.append((float(loss), float(gnorm)))
    single = torch_dist_ranks._full(state)
    single_eval = float(make_eval_step(state.model, tcfg)(state,
                                                          *batches[0]))
    ckpt1 = save_checkpoint(str(work / "one"), state, 1, steps[-1][0],
                            steps[-1][0])
    payload = dict(cfg=tcfg, state_dict=sd, batches=batches, arms=ARMS,
                   ckpt1=ckpt1, ckpt2=str(work / "two"), bn_f32=bn_f32)
    ranks = torch_dist_ranks.spawn_group(torch_dist_ranks.two_rank_checks,
                                         2, payload)
    return dict(tcfg=tcfg, jcfg=jcfg, jmodel=jmodel, variables=variables,
                sd=sd, batches=batches, bn_f32=bn_f32, steps=steps, single=single,
                single_eval=single_eval, ranks=ranks, work=work)


def test_replicated_two_ranks_equal_one_process(setup):
    arm = setup["ranks"][0]["replicated"]
    assert _worst(arm["state"], setup["single"]) <= 1e-8
    for (loss, _), (want, _) in zip(arm["steps"], setup["steps"]):
        assert loss == pytest.approx(want, rel=1e-6)
    # both ranks saw the same global loss and gradient norm
    assert setup["ranks"][1]["replicated"]["steps"] == arm["steps"]


def test_cross_rank_batch_norm_stats_equal_one_process(setup):
    got = setup["ranks"][0]["replicated"]["state"]
    keys = [k for k in setup["single"] if k.endswith(("running_mean",
                                                      "running_var"))]
    assert len(keys) > 50
    for k in keys:
        assert _rel(got[k], setup["single"][k]) <= 1e-10, k
    moved = [k for k in keys if not np.allclose(
        setup["single"][k], setup["sd"][k[len("model/"):]])]
    assert moved


def test_cross_rank_batch_norm_float32_normalises_as_one_process(setup):
    """Float32, channel means 20-60 with a spread of 0.08: the two ranks'
    BatchNorm against one process's (``F.batch_norm``) on all 8 rows,
    forward and backward.  The running mean agrees too; the running
    variance is Flax's fast form in both paths, whose float32
    cancellation at this mean differs with the summation order, so it is
    held in float64 (the stats test above)."""
    import torch

    from improved_body_parts_torch.models.layers import BatchNorm

    x, w = setup["bn_f32"]
    bn = BatchNorm(x.shape[1])
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    want = {"y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "affine_grad": torch.cat([bn.weight.grad,
                                      bn.bias.grad]).numpy(),
            "running_mean": bn.running_mean.numpy()}
    ranks = [setup["ranks"][r]["bn_f32"] for r in (0, 1)]
    for key in ("y", "x_grad"):
        got = np.concatenate([r[key] for r in ranks])
        assert _rel(got, want[key]) <= 1e-4, key
    for key in ("affine_grad", "running_mean"):
        for r in ranks:
            assert _rel(r[key], want[key]) <= 1e-4, key


def test_gradient_is_not_world_times_the_single_process_one(setup):
    """The cross-rank BN all-reduce's backward sums each rank's share
    over the ranks, and the ranks' gradients are averaged: the reduced
    gradient's norm is the single-process one, not twice it."""
    for name, _ in ARMS:
        (_, first), (_, second) = setup["ranks"][0][name]["steps"]
        (_, want1), (_, want2) = setup["steps"]
        assert first == pytest.approx(want1, rel=1e-10), name
        assert second == pytest.approx(want2, rel=1e-8), name


@pytest.mark.parametrize("name", ("imhn_fsdp", "imhn"))
def test_partitioned_layouts_give_the_replicated_update(setup, name):
    """``imhn_fsdp`` splits the batch as the replicated arm does and
    gives its update; ``imhn`` on (1, 2) splits no batch, so it gives the
    1-process update."""
    arm = setup["ranks"][0][name]
    same = (setup["ranks"][0]["replicated"] if name == "imhn_fsdp"
            else {"state": setup["single"], "steps": setup["steps"]})
    assert _worst(arm["state"], same["state"]) <= 1e-10
    assert _worst(arm["state"], setup["single"]) <= 1e-8
    for (loss, _), (want, _) in zip(arm["steps"], same["steps"]):
        assert loss == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ("imhn_fsdp", "imhn"))
def test_split_leaves_stay_chunks_after_the_steps(setup, name):
    arm = setup["ranks"][0][name]
    assert arm["sharded_state"]
    full = setup["single"]
    kept = arm["kept"]
    # each split conv kernel and its momentum
    assert kept and len({k for k, *_ in kept}) == len(kept)
    assert sum(k.startswith("momentum/") for k, *_ in kept) * 2 == len(kept)
    for key, shape, dim, shards in kept:
        want = list(full[key if key.startswith("momentum/")
                         else f"model/{key}"].shape)
        want[dim] //= shards
        assert shape == tuple(want), key
    assert setup["ranks"][1][name]["kept"] == kept


def test_replicated_update_matches_the_jax_meshed_step(setup):
    """JAX's ``make_train_step(mesh=make_mesh(2), rules=replicated)`` in
    float64 from the same weights on the first global batch: the update
    within the float64 trajectory tolerance of ``test_torch_train`` (JAX
    sums its loss in float32 even in x64 mode).  One step: at this net's
    unit-scale weights the update is large, and a second step would
    compound the two packages' float32 loss sums."""
    import jax
    import jax.numpy as jnp

    from improved_body_parts_torch.models import flax_train_state_to_torch
    from improved_body_parts_tpu.models import build_model as jbuild
    from improved_body_parts_tpu.parallel import make_mesh as jmake_mesh
    from improved_body_parts_tpu.parallel.partition import get_ruleset
    from improved_body_parts_tpu.train import schedule as jsched
    from improved_body_parts_tpu.train import state as jstate
    from improved_body_parts_tpu.train import step as jstep

    jcfg = setup["jcfg"]
    with jax.enable_x64(True):
        jmodel = jbuild(jcfg, dtype=jnp.float64)
        jopt = jstate.make_optimizer(jcfg, jsched.step_decay_schedule(
            jcfg.train, 2))

        def f64(x):
            return jnp.asarray(x, jnp.float64)

        params = jax.tree.map(f64, setup["variables"]["params"])
        state = jstate.TrainState(
            params=params,
            batch_stats=jax.tree.map(f64,
                                     setup["variables"]["batch_stats"]),
            opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
        jtrain = jstep.make_train_step(
            jmodel, jcfg, jopt, donate=False, mesh=jmake_mesh(2),
            rules=get_ruleset("replicated"))
        state, loss = jtrain(state, *setup["batches"][0])
        final = jax.tree.map(np.asarray, state)
    model = build_model(setup["tcfg"], device="cpu", train=True)
    want = flax_train_state_to_torch(final, model)
    got = setup["ranks"][0]["replicated"]
    assert got["steps"][0][0] == pytest.approx(float(loss), rel=1e-5)
    # within 1e-5 of each leaf's largest value: the stem's gradient runs
    # to ~200 here, and the float32 loss gradient's rounding with it
    for part, prefix in (("state_dict", "model/"), ("momentum", "momentum/")):
        for k, w in want[part].items():
            if not k.endswith("num_batches_tracked"):
                assert _rel(got["first_state"][prefix + k], w) <= 1e-5, k


def test_eval_step_gives_the_global_batch_loss(setup):
    got = setup["ranks"][0]["replicated"]["eval"]
    assert got == pytest.approx(setup["single_eval"], rel=1e-6)


def test_two_rank_checkpoint_resumes_in_one_process(setup):
    path = os.path.join(str(setup["work"] / "two"), "epoch_0")
    assert json.load(open(os.path.join(path, "COMMIT.json")))[
        "topology"]["process_count"] == 2
    state = torch_dist_ranks._state(setup["tcfg"], setup["sd"])
    state, meta = restore_checkpoint(path, state)
    with pytest.raises(TopologyChanged, match="process_count"):
        reshard_on_topology_change(state, meta, None, 1, "refuse", path,
                                   device="cpu")
    state, change = reshard_on_topology_change(
        state, meta, None, 1, "adjust", path, log_fn=lambda s: None,
        device="cpu")
    assert change["process_count"] == (2, 1)
    saved = setup["ranks"][0]["replicated"]["state"]
    got = torch_dist_ranks._full(state)
    assert all(np.array_equal(got[k], saved[k]) for k in saved)
    assert state.step == 2


def test_one_process_checkpoint_resumes_in_two_ranks(setup):
    for rank in (0, 1):
        res = setup["ranks"][rank]
        assert res["resume_adjust"]["change"]["process_count"] == (1, 2)
        assert res["resume_adjust"]["step"] == 2
        assert "process_count" in res["resume_refuse"]
    got = setup["ranks"][0]["resume_adjust"]["state"]
    assert all(np.array_equal(got[k], w) for k, w in setup["single"].items())


def test_mesh_and_rules_go_together():
    cfg = _config(tconfig)
    model = build_model(cfg, device="cpu", train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(cfg.train, 2))
    with pytest.raises(ValueError, match="pass both or neither"):
        make_train_step(model, cfg, opt, mesh=object())
    with pytest.raises(ValueError, match="pass both or neither"):
        make_train_step(model, cfg, opt, rules=((".", ()),))


def test_cli_two_processes_write_per_rank_sinks(tmp_path):
    h5 = str(tmp_path / "c.h5")
    # 4 records: 2 steps of 2 ranks x tiny's batch of 1
    assert build_fixture(h5, num_images=4, img_size=(96, 128),
                         people_per_image=2, image_size=128, seed=0,
                         drawn=True) == 4
    ckpt = str(tmp_path / "ck")
    logs = [str(tmp_path / f"rank{r}.log") for r in range(2)]
    rcs = launch_ranks(2, ["--config", "tiny", "--train-h5", h5,
                           "--val-h5", h5,
                           "--checkpoint-dir", ckpt, "--epochs", "1",
                           "--workers", "0", "--device", "cpu",
                           "--telemetry-sink", "auto"],
                       lambda r: logs[r], timeout_s=240)
    out = [open(p).read() for p in logs]
    assert rcs == [0, 0], out[0][-2000:] + out[1][-2000:]
    reports = [parse_reports(o)[0] for o in out]
    assert [r["process_id"] for r in reports] == [0, 1]
    assert all(r["num_processes"] == 2 and r["steps"] == 2
               and r["images"] == 4 for r in reports)
    assert reports[0]["state_sha256"] == reports[1]["state_sha256"]
    assert os.path.isfile(os.path.join(ckpt, "events.jsonl"))
    assert os.path.isfile(os.path.join(ckpt, "events.jsonl.p1"))
    meta = json.load(open(os.path.join(ckpt, "epoch_0", "COMMIT.json")))
    assert meta["topology"]["process_count"] == 2
    assert meta["topology"]["mesh_axes"] == {"data": 2, "model": 1}
