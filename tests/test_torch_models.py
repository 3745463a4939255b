"""Port parity: configs and the IMHN model on converted weights.

- Every ``get_config`` entry and ``default_inference_params()`` of the
  port's config copy equals the JAX package's, field by field.
- The port's ``PoseNet`` on weights converted from a seeded Flax tree
  (``models.convert``) gives every ``[stack][scale]`` output within rtol
  1e-4 / atol 1e-5 of ``model.apply`` in fp32 eval mode (the convolutions
  sum in another order), at an even and an odd input size (the stride-2
  stem pads asymmetrically under Flax ``SAME``).
- The full-width ``canonical`` model has JAX ``eval_shape``'s parameter
  count, 128,998,760, counted on the ``meta`` device.
"""
import dataclasses

import numpy as np
import pytest
import torch

from improved_body_parts_tpu import config as jconfig
from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.models import (
    build_model,
    flax_to_state_dict,
    load_flax_variables,
)

CANONICAL_PARAMS = 128_998_760


@pytest.mark.parametrize("name", jconfig.available_configs())
def test_configs_equal_field_by_field(name):
    want, got = jconfig.get_config(name), tconfig.get_config(name)

    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    for section in ("skeleton", "model", "train"):
        w, g = getattr(want, section), getattr(got, section)
        wf, gf = fields(w), fields(g)
        assert wf.keys() == gf.keys(), section
        for key in wf:
            if dataclasses.is_dataclass(wf[key]):
                assert fields(wf[key]) == fields(gf[key]), (section, key)
            else:
                assert wf[key] == gf[key], (section, key)
    assert tconfig.available_configs() == jconfig.available_configs()


def test_inference_params_equal():
    for want, got in zip(jconfig.default_inference_params(),
                         tconfig.default_inference_params()):
        assert dataclasses.asdict(want) == dataclasses.asdict(got)


def test_canonical_param_count_on_meta():
    model = build_model(tconfig.get_config("canonical"), device="meta")
    assert sum(p.numel() for p in model.parameters()) == CANONICAL_PARAMS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A module's torch work on one intra-op thread, restored after (the
    port's test modules import this fixture).  Beside the suite's other
    worker processes, torch's default of one spinning thread per core
    oversubscribes the host and slows small CPU ops many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seeded_flax(cfg, h, w, seed=0):
    """A Flax variables tree of the ``cfg`` model with every leaf drawn
    from a numpy seed at unit-scale activations (the package's own init,
    N(0, 0.001), would leave the outputs near zero and prove little)."""
    import jax
    import jax.numpy as jnp

    from improved_body_parts_tpu.models import build_model as jbuild

    model = jbuild(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, h, w, 3), jnp.float32)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan_in), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), shapes)
    return model, variables


@pytest.mark.parametrize("h,w", [(64, 64), (63, 65)])
def test_tiny_model_matches_flax_on_converted_weights(h, w):
    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, h, w)
    img = np.random.default_rng(1).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    want = jmodel.apply(variables, img, train=False)

    model = build_model(cfg, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert len(got) == len(want) == cfg.model.nstack
    for i, (ws, gs) in enumerate(zip(want, got)):
        assert len(gs) == len(ws) == cfg.model.hourglass_depth + 1
        for j, (a, b) in enumerate(zip(ws, gs)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"stack {i} scale {j}")


def test_converter_fails_loudly_on_unused_or_missing_leaf():
    cfg = tconfig.get_config("tiny")
    _, variables = _seeded_flax(cfg, 32, 32)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    extra = {**variables, "params": {**variables["params"],
                                     "Bogus_0": {"kernel": np.zeros(1)}}}
    with pytest.raises(ValueError, match="unused Flax leaf params/Bogus_0"):
        flax_to_state_dict(extra, model)
    params = dict(variables["params"])
    params.pop("Backbone_0")
    with pytest.raises(ValueError, match="missing Flax leaf"):
        flax_to_state_dict({**variables, "params": params}, model)


def test_entry_points_default_to_cuda_and_refuse_the_cpu_quietly(
        monkeypatch):
    """Without a GPU an entry point raises unless the caller asks for the
    CPU, for every model variant."""
    from improved_body_parts_torch.infer import Predictor

    cfg = tconfig.get_config("tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(None, cfg.skeleton)
    other = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant="imhn_final"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(other)
