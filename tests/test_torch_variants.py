"""Port parity: the five model variants beside ``imhn``.

- ``build_model`` builds all six variants; at published width each has
  the parameter count of ``tests/test_models.py`` (measured on the
  reference networks), counted on the ``meta`` device and equal to JAX
  ``eval_shape``'s count of the same config.
- Each variant at tiny width (16 channels, depth 2, 2 stacks, 32x32
  input; ``imhn`` itself is held so by ``test_torch_models.py`` and
  ``test_torch_train.py``), on weights
  converted from a seeded Flax tree (``models.convert``): every
  ``[stack][scale]`` output within rtol 1e-4 / atol 1e-5 of
  ``model.apply`` in fp32 eval mode (the bound ``test_torch_models.py``
  holds ``imhn`` to); in train mode (batch statistics over 2 images),
  computed in float64 on both sides, the outputs (cast to float32 at the
  end by both models) within rtol 1e-6 / atol 1e-7 and the updated BN
  running stats within rtol 1e-7 / atol 1e-9 of Flax's
  ``mutable=["batch_stats"]`` result: normalising by the statistics of
  so few samples amplifies float32 rounding to 8e-5 on ``imhn``'s
  outputs, in either package.
- The serve lane on every variant unchanged: ``Predictor`` (which takes
  ``preds[-1][0]``) decodes a batch, and the int8 and bf16 storage of
  ``utils.precision`` run the forward; int8 storage gives the outputs of
  the fp32 model on the dequantized weights (rtol 1e-5 / atol 1e-6).
"""
import copy
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.infer import Predictor
from improved_body_parts_torch.models import (
    build_model,
    flax_to_state_dict,
    load_flax_variables,
)
from improved_body_parts_torch.utils.precision import (
    apply_serve_dtype,
    dequantize_int8,
)
from improved_body_parts_tpu import config as jconfig
from improved_body_parts_tpu.models import build_model as jbuild

sys.path.insert(0, "tests")
from test_torch_models import _seeded_flax, one_torch_thread  # noqa: E402,F401



# (variant, nstack at published width) -> reference parameter count
PUBLISHED = {
    ("imhn", 4): 128_998_760,
    ("imhn_independent", 4): 128_998_760,
    ("imhn_final", 4): 227_066_536,
    ("imhn_wide", 3): 152_156_430,
    ("imhn_light", 4): 149_504_936,
    ("ae", 4): 138_861_512,
}
VARIANTS = [v for v, _ in PUBLISHED]
HW = 32


def _variant(pkg, name, variant, **model):
    cfg = pkg.get_config(name)
    return cfg.replace(model=dataclasses.replace(cfg.model, variant=variant,
                                                 **model))


@pytest.mark.parametrize("variant,nstack", list(PUBLISHED))
def test_published_width_parameter_counts(variant, nstack):
    want = PUBLISHED[(variant, nstack)]
    model = build_model(_variant(tconfig, "canonical", variant,
                                 nstack=nstack), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    jmodel = jbuild(_variant(jconfig, "canonical", variant, nstack=nstack),
                    dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 128, 128, 3)), train=False), jax.random.PRNGKey(0))
    assert sum(int(np.prod(p.shape))
               for p in jax.tree.leaves(shapes["params"])) == want


@functools.lru_cache(maxsize=None)
def _flax_variables(variant):
    """The seeded Flax tree of ``variant`` at tiny width (shared by the
    forward and serve tests; nothing writes to it)."""
    return _seeded_flax(_variant(jconfig, "tiny", variant), HW, HW)[1]


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_variant_matches_flax_on_converted_weights(variant, train):
    jcfg = _variant(jconfig, "tiny", variant)
    tcfg = _variant(tconfig, "tiny", variant)
    variables = _flax_variables(variant)
    img = np.random.default_rng(3).uniform(0, 1, (2, HW, HW, 3))
    dt = np.float64 if train else np.float32
    model = build_model(tcfg, dtype=torch.float32, device="cpu",
                        train=train)
    load_flax_variables(model, variables)
    model = model.to(torch.from_numpy(np.zeros(0, dt)).dtype)
    with jax.enable_x64(train):
        jmodel = jbuild(jcfg, dtype=jnp.dtype(dt))
        jvars = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)
        if train:
            want, mutated = jax.jit(lambda v, x: jmodel.apply(
                v, x, train=True, mutable=["batch_stats"]))(
                    jvars, img.astype(dt))
        else:
            want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
                jvars, img.astype(dt))
        want = jax.tree.map(np.asarray, want)
        if train:
            mutated = jax.tree.map(np.asarray, mutated)
    with torch.no_grad():
        got = model(torch.from_numpy(img.astype(dt)))
    nscale = 1 if variant == "ae" else tcfg.model.hourglass_depth + 1
    assert len(got) == len(want) == tcfg.model.nstack
    for i, (ws, gs) in enumerate(zip(want, got)):
        assert len(gs) == len(ws) == nscale
        for j, (a, b) in enumerate(zip(ws, gs)):
            assert b.dtype == torch.float32
            _close(b.numpy(), a, f"{variant} stack {i} scale {j}",
                   *((1e-6, 1e-7) if train else ()))
    if train and variant != "ae":
        new = flax_to_state_dict({**variables, **mutated}, model)
        sd = model.state_dict()
        stats = [k for k in sd if k.endswith(("running_mean",
                                              "running_var"))]
        assert stats
        for k in stats:
            _close(sd[k].numpy(), new[k].numpy(), k, 1e-7, 1e-9)


@pytest.mark.parametrize("variant", VARIANTS)
def test_serve_lane_and_storage_on_every_variant(variant):
    cfg = _variant(tconfig, "tiny", variant)
    model = build_model(cfg, device="cpu", seed=1)
    variables = _flax_variables(variant)
    load_flax_variables(model, variables)
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, HW, HW, 3)).astype(np.float32))
    params, _ = tconfig.default_inference_params()
    model_params = tconfig.InferenceModelParams(boxsize=HW,
                                                max_downsample=64)
    pred = Predictor(model, cfg.skeleton, params, model_params, bucket=64,
                     device="cpu")
    images = [np.random.default_rng(5).integers(0, 256, (48, 64, 3),
                                                dtype=np.uint8)]
    out = pred.predict_decoded_batch(images)
    assert len(out) == 1 and np.isfinite(out[0].subset).all()

    with torch.no_grad():
        q = apply_serve_dtype("int8", copy.deepcopy(model))
        want = dequantize_int8(copy.deepcopy(q))(img)
        got = q(img)
        bf = apply_serve_dtype("bf16", copy.deepcopy(model))(img)
    for gs, ws, bs in zip(got, want, bf):
        for g, w, b in zip(gs, ws, bs):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)
            assert b.dtype == torch.float32 and torch.isfinite(b).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_on_every_variant(variant):
    """One SGD step of each variant at tiny width: the loss is finite, the
    update is taken, the conv weights move (all but a few whose gradient,
    deep in the BN-free AE hourglass, is below their float32 spacing), and
    a parameter the loss does not reach (the independent variant's
    later-scale merges) gets JAX's zero gradient, not none."""
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )

    cfg = _variant(tconfig, "tiny", variant)
    if variant == "ae":
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    scale_weight=(1.0,)))
    model = build_model(cfg, device="cpu", seed=2, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(cfg.train, 4))
    state = create_train_state(model, cfg, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.dim() == 4}
    rng = np.random.default_rng(6)
    h, w = cfg.skeleton.grid_shape
    batch = (rng.integers(0, 256, (1, cfg.skeleton.height,
                                   cfg.skeleton.width, 3), dtype=np.uint8),
             np.ones((1, h, w, 1), np.float32),
             rng.uniform(0, 1, (1, h, w, cfg.skeleton.num_layers)).astype(
                 np.float32))
    state, loss = make_train_step(model, cfg, opt)(state, *batch)
    assert np.isfinite(float(loss)) and int(opt.count) == 1
    after = dict(model.named_parameters())
    assert all(p.grad is not None for p in after.values())
    still = [n for n, b in before.items() if torch.equal(b, after[n])
             and after[n].grad.abs().max() > 0]
    assert len(still) <= 0.2 * len(before), still
    unused = [n for n, p in after.items() if not p.grad.abs().max() > 0]
    if variant == "imhn_independent":
        assert unused and all(".merge_" in n for n in unused)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="unknown model variant"):
        build_model(_variant(tconfig, "tiny", "posenet9"), device="cpu")
