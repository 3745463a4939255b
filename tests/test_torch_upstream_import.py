"""The port's upstream ``.pth`` importer
(``improved_body_parts_torch.cli.import_torch_checkpoint``) against the
JAX package's (``tools/import_torch_checkpoint.py``), on the CPU:

- a seeded ``tiny`` port model written in upstream's names: the JAX
  tool's ``convert_posenet_state_dict`` of that dict gives a Flax
  forward, the port's importer a port forward, and every ``[stack]
  [scale]`` output agrees within ``test_torch_models.py``'s tolerance
  (rtol 1e-4 / atol 1e-5, fp32 eval), for ``imhn`` and
  ``imhn_independent``;
- the upstream key set written equals the set the JAX tool consumes;
- the import renames only: the round trip gives the model's tensors
  bit for bit, and ``module.`` / ``posenet.`` prefixes are stripped;
- the CLI writes an ``epoch_<N>`` checkpoint that ``cli.evaluate``'s
  ``load_predictor`` loads as it is;
- the refusals: an extra key, a missing key, a shape mismatch, a
  variant outside upstream's layout, a pickled non-tensor payload under
  ``weights_only`` (loaded with ``--unsafe-load``), and ``--device
  cuda`` on a host without a card.
"""
import dataclasses
import pickle
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch.cli import import_torch_checkpoint as imp
from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.models import build_model

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
import import_torch_checkpoint as jimp  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401


def _config(name="tiny", variant="imhn"):
    cfg = get_config(name)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant=variant))


def _seeded_model(cfg, seed=0):
    """The ``cfg`` model (fp32, eval) with every tensor drawn from a numpy
    seed at unit-scale activations."""
    model = build_model(cfg, dtype=torch.float32, device="cpu").eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() > 1:
                fan_in = int(np.prod(t.shape[1:]))
                val = rng.normal(0, 1 / np.sqrt(fan_in), t.shape)
            elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                val = rng.uniform(0.5, 1.5, t.shape)
            else:
                val = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(val.astype(np.float32)))
    return model


def _upstream(model, cfg, prefix=""):
    m = cfg.model
    return imp.export_upstream_state_dict(model, m.nstack,
                                          m.hourglass_depth, prefix=prefix)


class _Recorder(jimp._Mapper):
    """The JAX tool's walk, keeping the names it consumed."""
    seen = []

    def __init__(self, sd):
        super().__init__(sd)
        _Recorder.seen.append(self)


@pytest.mark.parametrize("variant", ["imhn", "imhn_independent"])
@pytest.mark.parametrize("h,w", [(64, 64), (63, 65)])
def test_forward_equals_the_jax_tools_import(variant, h, w):
    import jax.numpy as jnp

    from improved_body_parts_tpu.config import get_config as jconfig
    from improved_body_parts_tpu.models import build_model as jbuild

    cfg = _config("tiny", variant)
    sd = _upstream(_seeded_model(cfg), cfg, prefix="module.")
    stripped = imp.strip_prefixes(sd)
    params, stats = jimp.convert_posenet_state_dict(
        {k: v.numpy() for k, v in stripped.items()}, cfg.model.nstack,
        cfg.model.hourglass_depth)
    jcfg = jconfig("tiny")
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, variant=variant))
    img = np.random.default_rng(1).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    want = jbuild(jcfg, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, img, train=False)

    model = build_model(cfg, dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(imp.convert_upstream_state_dict(
        stripped, model, cfg.model.nstack, cfg.model.hourglass_depth),
        strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert len(got) == len(want) == cfg.model.nstack
    for i, (ws, gs) in enumerate(zip(want, got)):
        assert len(gs) == len(ws) == cfg.model.hourglass_depth + 1
        for j, (a, b) in enumerate(zip(ws, gs)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"stack {i} scale {j}")


@pytest.mark.parametrize("name", ["tiny", "tiny_student", "synth"])
def test_upstream_key_set_is_what_the_jax_tool_consumes(name, monkeypatch):
    cfg = _config(name)
    sd = _upstream(build_model(cfg, dtype=torch.float32, device="cpu"), cfg)
    _Recorder.seen = []
    monkeypatch.setattr(jimp, "_Mapper", _Recorder)
    jimp.convert_posenet_state_dict({k: v.numpy() for k, v in sd.items()},
                                    cfg.model.nstack,
                                    cfg.model.hourglass_depth)
    (walk,) = _Recorder.seen
    assert set(sd) == walk.used
    assert sum(k.endswith("num_batches_tracked") for k in sd) > 0


def test_import_is_a_renaming_bit_for_bit():
    cfg = _config()
    model = _seeded_model(cfg)
    sd = imp.convert_upstream_state_dict(
        imp.strip_prefixes(_upstream(model, cfg, prefix="module.posenet.")),
        model, cfg.model.nstack, cfg.model.hourglass_depth)
    ref = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("prefix", ["", "module.", "posenet.",
                                    "module.posenet."])
def test_prefixes_are_stripped(prefix):
    cfg = _config()
    sd = _upstream(build_model(cfg, dtype=torch.float32, device="cpu"), cfg,
                   prefix=prefix)
    stripped = imp.strip_prefixes(sd)
    assert all(not k.startswith(("module.", "posenet.")) for k in stripped)
    assert "pre.conv1.weight" in stripped


def _convert(sd, cfg):
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    return imp.convert_upstream_state_dict(sd, model, cfg.model.nstack,
                                           cfg.model.hourglass_depth)


def test_an_unmapped_upstream_key_is_refused():
    cfg = _config()
    sd = _upstream(build_model(cfg, dtype=torch.float32, device="cpu"), cfg)
    sd["pre.bogus.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unmapped upstream key "
                                         "pre.bogus.weight"):
        _convert(sd, cfg)


def test_a_missing_key_leaves_a_tensor_unfilled():
    cfg = _config()
    sd = _upstream(build_model(cfg, dtype=torch.float32, device="cpu"), cfg)
    del sd["outs.1.0.conv.bias"]
    with pytest.raises(ValueError, match="left unfilled"):
        _convert(sd, cfg)


def test_a_shape_mismatch_is_refused():
    cfg = _config()
    sd = _upstream(build_model(cfg, dtype=torch.float32, device="cpu"), cfg)
    sd["pre.conv1.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="pre.conv1.weight: shape"):
        _convert(sd, cfg)


def _write_pth(path, cfg, model=None, **payload):
    model = model or _seeded_model(cfg)
    torch.save({"weights": _upstream(model, cfg, prefix="module."),
                "epoch": 52, "train_loss": 0.25, **payload}, path)
    return model


def test_cli_writes_a_checkpoint_the_evaluate_cli_loads(tmp_path, capsys):
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.train import (
        read_commit_meta,
        restore_checkpoint,
    )

    cfg = _config()
    model = _write_pth(tmp_path / "PoseNet_52_epoch.pth", cfg)
    path = imp.main(["--pth", str(tmp_path / "PoseNet_52_epoch.pth"),
                     "--out", str(tmp_path / "imported"), "--config",
                     "tiny", "--device", "cpu"])
    assert path.endswith("epoch_52")
    assert "imported" in capsys.readouterr().out
    payload = restore_checkpoint(path)
    assert payload["epoch"] == 52 and payload["train_loss"] == 0.25
    assert payload["optimizer"] is None
    assert read_commit_meta(path)["epoch"] == 52
    pred = load_predictor("tiny", path, device="cpu", params_dtype="fp32")
    ref = model.state_dict()
    for k, v in pred.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k


def test_a_variant_outside_upstreams_layout_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="variant 'ae'"):
        imp.main(["--pth", str(tmp_path / "none.pth"), "--out",
                  str(tmp_path / "out"), "--config", "ae", "--device",
                  "cpu"])


class _NotATensor:
    """A pickled payload object: weights_only loading must refuse it."""


def test_weights_only_refuses_a_pickled_non_tensor_payload(tmp_path):
    cfg = _config()
    pth = tmp_path / "legacy.pth"
    _write_pth(pth, cfg, extra=_NotATensor())
    args = ["--pth", str(pth), "--out", str(tmp_path / "out"), "--config",
            "tiny", "--device", "cpu"]
    with pytest.raises(pickle.UnpicklingError):
        imp.main(args)
    assert imp.main(args + ["--unsafe-load"]).endswith("epoch_52")


def test_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    cfg = _config()
    _write_pth(tmp_path / "w.pth", cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imp.main(["--pth", str(tmp_path / "w.pth"), "--out",
                  str(tmp_path / "out"), "--config", "tiny"])
