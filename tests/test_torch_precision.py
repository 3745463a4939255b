"""Serve-time weight storage of the port (``utils.precision``,
``models.convert``'s int8 trees, ``serve.artifacts``) against the JAX
package, on the CPU:

- ``quantize_int8``'s int8 values and scales equal the JAX package's bit
  for bit after the layout change (OIHW / (out, in) against HWIO /
  (in, out)), on the tiny IMHN's seeded weights; a JAX ``quantize_int8``
  tree converts into the port's int8 storage with the same tensors;
- the int8 forward is within 1e-5 (rel 1e-4) of the JAX
  ``DequantizingModel`` forward in float32 compute (the dequantized
  weights are equal; the convolutions sum in other orders);
- the bf16 forward, both packages computing in bf16 on bf16-stored
  weights, BN stats included: within 4e-2 of the JAX ``bf16_params``
  forward on outputs up to ~1.1 (one bf16 rounding is 2^-8 relative,
  and the packages round at other ops; fp32 storage under bf16 compute
  is as far from JAX's, see the test);
- storage bytes, ``dequantize_int8``, ``resolve_params_dtype``'s modes;
- ``checkpoint_predictor`` at each dtype from a port checkpoint, and
  ``cascade_predictors``;
- ``cli.evaluate --params-dtype`` and ``cli.synth_ap --dtype-matrix
  --decode-path full`` at ``--device cpu`` on the drawn fixture.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.models import build_model, load_flax_variables
from improved_body_parts_torch.utils import precision as tprec
from improved_body_parts_tpu.utils import precision as jprec

sys.path.insert(0, "tests")
from test_torch_models import _seeded_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64


@pytest.fixture(scope="module")
def tiny():
    """The tiny IMHN's seeded Flax tree, its JAX models (fp32 and bf16
    compute) and a test batch."""
    import jax.numpy as jnp

    from improved_body_parts_tpu.models import build_model as jbuild

    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, HW, HW, seed=3)
    img = np.random.default_rng(1).uniform(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, img=img,
                jmodel16=jbuild(cfg, dtype=jnp.bfloat16))


def _port(tiny, dtype=torch.float32):
    model = build_model(tiny["cfg"], dtype=dtype, device="cpu")
    return load_flax_variables(model, tiny["variables"])


def _max_err(got, want):
    return max(float(np.abs(g.numpy() - np.asarray(w, np.float32)).max())
               for gs, ws in zip(got, want) for g, w in zip(gs, ws))


def _layout(a, ndim):
    """A Flax kernel or its int8 values in torch's layout."""
    return np.transpose(a, (3, 2, 0, 1)) if ndim == 4 else a.T


def test_quantize_int8_equals_jax_bit_for_bit(tiny):
    from improved_body_parts_torch.models.convert import flax_leaf_map

    jq = jprec.quantize_int8(tiny["variables"])
    model = tprec.quantize_int8(_port(tiny))
    sd = model.state_dict()
    leaf_map = flax_leaf_map(model)
    n_layers = 0
    for key, t in sd.items():
        if not key.endswith(".weight_q"):
            continue
        _, path, _ = leaf_map[key]
        leaf = jq["params"]
        for p in path[:-1]:
            leaf = leaf[p]
        q = np.asarray(leaf["int8_q"])
        assert t.dtype == torch.int8 and q.dtype == np.int8
        np.testing.assert_array_equal(t.numpy(), _layout(q, q.ndim), key)
        scale = sd[key[:-len("_q")] + "_scale"].numpy()
        want = np.asarray(leaf["int8_scale"])
        np.testing.assert_array_equal(scale.view(np.uint32),
                                      want.view(np.uint32), key)
        n_layers += 1
    # every conv and dense weight of the tiny IMHN, nothing else
    n_weights = sum(1 for k, v in _port(tiny).state_dict().items()
                    if k.endswith(".weight") and v.dim() >= 2)
    assert n_layers == n_weights > 0


def test_jax_int8_tree_converts_into_int8_storage(tiny):
    jq = jprec.quantize_int8(tiny["variables"])
    carried = tprec.quantize_int8(build_model(tiny["cfg"], device="cpu"))
    load_flax_variables(carried, jq)
    own = tprec.quantize_int8(_port(tiny)).state_dict()
    got = carried.state_dict()
    assert list(got) == list(own)
    for k, v in own.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def test_int8_forward_matches_jax_dequantizing_model(tiny):
    jq = jprec.quantize_int8(tiny["variables"])
    want = jprec.DequantizingModel(tiny["jmodel"]).apply(jq, tiny["img"],
                                                         train=False)
    model = tprec.quantize_int8(_port(tiny))
    with torch.no_grad():
        got = model(torch.from_numpy(tiny["img"]))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
    # the dequantized model is the same function, bit for bit
    plain = tprec.dequantize_int8(model)
    assert not any(isinstance(m, tprec.Int8Layer) for m in plain.modules())
    with torch.no_grad():
        again = plain(torch.from_numpy(tiny["img"]))
    for gs, hs in zip(got, again):
        for g, h in zip(gs, hs):
            assert torch.equal(g, h)


def test_bf16_forward_matches_jax_bf16_params(tiny):
    jb = jprec.bf16_params(tiny["variables"])
    want = tiny["jmodel16"].apply(jb, tiny["img"], train=False)
    model = tprec.bf16_params(_port(tiny, torch.bfloat16))
    assert {t.dtype for t in model.parameters()} == {torch.bfloat16}
    assert {b.dtype for n, b in model.named_buffers()
            if not n.endswith("num_batches_tracked")} == {torch.bfloat16}
    with torch.no_grad():
        got = model(torch.from_numpy(tiny["img"]))
    assert _max_err(got, want) <= 4e-2
    # the storage is real: fp32 weights under the same bf16 compute
    # give other outputs, as far from JAX's bf16 forward as bf16 is
    with torch.no_grad():
        fp32_stored = _port(tiny, torch.bfloat16)(
            torch.from_numpy(tiny["img"]))
    assert 0 < _max_err(fp32_stored, [[np.asarray(g) for g in gs]
                                      for gs in got])
    assert _max_err(fp32_stored, want) <= 4e-2


def test_storage_modes_and_bytes(tiny):
    fp32 = _port(tiny)
    n32 = tprec.storage_bytes(fp32)
    assert tprec.resolve_params_dtype("auto", fp32) is fp32  # the CPU
    assert next(fp32.parameters()).dtype == torch.float32
    assert tprec.resolve_params_dtype("fp32", fp32) is fp32
    with pytest.raises(ValueError):
        tprec.resolve_params_dtype("int4", fp32)
    bf16 = tprec.apply_serve_dtype("bf16", _port(tiny))
    int8 = tprec.apply_serve_dtype("int8", _port(tiny))
    n16, n8 = tprec.storage_bytes(bf16), tprec.storage_bytes(int8)
    # bf16 halves every float (BN's int64 step counters stay as they
    # are); int8 keeps biases, norms and scales fp32
    counters = sum(b.numel() * b.element_size() for b in fp32.buffers()
                   if not b.is_floating_point())
    assert 2 * (n16 - counters) == n32 - counters
    assert n8 <= 0.35 * n32
    with pytest.raises(TypeError):
        tprec.Int8Layer(torch.nn.BatchNorm2d(4))


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A saved checkpoint of the port's tiny config (seeded init)."""
    from improved_body_parts_torch.cli.synth_ap import save_fresh_checkpoint

    return save_fresh_checkpoint("tiny", str(
        tmp_path_factory.mktemp("ckpt") / "fresh"), 4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8", "auto"])
def test_checkpoint_predictor_at_each_dtype(port_checkpoint, dtype):
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.serve import checkpoint_predictor

    pred = checkpoint_predictor("tiny", port_checkpoint, dtype, boxsize=128,
                                bucket=64, fused_tta=False, device="cpu")
    assert pred.device.type == "cpu" and not pred.fused_tta
    assert pred.model_params.boxsize == 128 and pred.bucket == 64
    int8_layers = [m for m in pred.model.modules()
                   if isinstance(m, tprec.Int8Layer)]
    assert bool(int8_layers) == (dtype == "int8")
    want_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert pred.model.backbone.stem.bn.weight.dtype == want_dtype
    ref = load_predictor("tiny", port_checkpoint, device="cpu", bucket=64,
                         boxsize=128, params_dtype=dtype)
    assert tprec.storage_bytes(ref.model) == tprec.storage_bytes(pred.model)
    img = np.random.default_rng(2).integers(0, 255, (96, 128, 3),
                                            dtype=np.uint8)
    a, b = pred.predict_decoded(img), ref.predict_decoded(img)
    np.testing.assert_array_equal(a.subset, b.subset)
    np.testing.assert_array_equal(a.compact.peaks.score,
                                  b.compact.peaks.score)


def test_cascade_predictors_pair(port_checkpoint):
    from improved_body_parts_torch.serve import cascade_predictors

    student, teacher = cascade_predictors(
        "tiny_student", "tiny", teacher_checkpoint=port_checkpoint,
        device="cpu")
    assert any(isinstance(m, tprec.Int8Layer)
               for m in student.model.modules())
    assert not any(isinstance(m, tprec.Int8Layer)
                   for m in teacher.model.modules())


def _cli(module, *args, cwd=None, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", f"improved_body_parts_torch.cli.{module}",
         *args], capture_output=True, text=True, env=env, timeout=600,
        cwd=cwd)
    if check:
        assert proc.returncode == 0, (proc.stdout[-2000:],
                                      proc.stderr[-2000:])
    return proc


def test_synth_ap_dtype_matrix_and_evaluate_params_dtype(tmp_path):
    """``cli.synth_ap --dtype-matrix --decode-path full`` end to end on the
    CPU: the JAX tool's keys, each evaluation's report naming its
    storage; then ``cli.evaluate --params-dtype int8`` on the trained
    checkpoint prints the AP the matrix recorded."""
    out, work = tmp_path / "ap.json", tmp_path / "work"
    _cli("synth_ap", "--config", "synth", "--train-images", "4",
         "--val-images", "2", "--epochs", "1", "--device", "cpu",
         "--decode-path", "full", "--dtype-matrix", "--workdir", str(work),
         "--out", str(out), cwd=str(tmp_path))
    result = json.loads(out.read_text())
    assert result["decode_path"] == "full"
    for key in ("ap_trained", "ap_trained_bf16", "ap_trained_int8"):
        assert 0.0 <= result[key] <= 1.0, (key, result[key])
    delta = abs(result["ap_trained_int8"] - result["ap_trained_bf16"])
    assert result["int8_vs_bf16_ap_delta"] == round(delta, 6)
    assert result["int8_ap_tolerance"] == 0.01
    assert result["int8_within_tolerance"] == (delta <= 0.01)
    reports = result["cli_reports"]
    for dtype in ("bf16", "int8"):
        (rep,) = reports[f"evaluate_trained_{dtype}"]
        assert rep["params_dtype"] == dtype and rep["device"] == "cpu"
    assert reports["evaluate_trained"][0]["params_dtype"] == "auto"

    stdout = _cli("evaluate", "--config", "synth", "--checkpoint",
                  result["checkpoint"], "--anno",
                  str(work / "person_keypoints_synth.json"), "--images",
                  str(work / "val"), "--oks-proxy", "--boxsize", "128",
                  "--params-dtype", "int8", "--device", "cpu",
                  "--dump-name", "int8_again", cwd=str(work)).stdout
    assert f"AP: {result['ap_trained_int8']}" in stdout
