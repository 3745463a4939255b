"""The port's network introspection and debug overlays
(``improved_body_parts_torch.utils.visualize``, ``cli.train
--debug-overlays``) against the JAX package's
(``improved_body_parts_tpu.utils.visualize``, ``tools/train.py``), on
the CPU:

- ``colorize_jet`` and ``train_batch_overlay`` bit for bit JAX's, on
  float and uint8 images;
- ``param_table``'s total and row count equal JAX's on the same
  (converted) ``tiny`` weights, and ``module_dot`` is valid DOT with the
  same total;
- ``cli.train --debug-overlays`` writes ``overlays/epoch_<N>.png`` equal
  to JAX's ``save_batch_overlays`` of the same first batch (in-process
  and through the shm ring), and skips it under ``--device-gt`` with the
  JAX CLI's message.
"""
import os
import re
import sys

import cv2
import numpy as np
import pytest
import torch

from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.models import build_model, load_flax_variables
from improved_body_parts_torch.utils import visualize as tviz

sys.path.insert(0, "tests")
from improved_body_parts_tpu.utils import visualize as jviz  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _seeded_flax,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colorize_jet_equals_jax(seed):
    rng = np.random.default_rng(seed)
    # every segment and its edges, and values outside [0, 1]
    gray = np.concatenate([rng.uniform(-0.2, 1.2, 500),
                           np.array([0.0, 0.125, 0.375, 0.625, 0.875, 1.0,
                                     0.1249999, 0.8750001])])
    gray = gray.astype(np.float32).reshape(-1, 4)
    got, want = tviz.colorize_jet(gray), jviz.colorize_jet(gray)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("channel", [0, 3, 49])
def test_train_batch_overlay_equals_jax(dtype, channel):
    rng = np.random.default_rng(channel)
    image = rng.uniform(0, 1, (64, 80, 3))
    image = (image * 255).astype(np.uint8) if dtype == "uint8" \
        else image.astype(np.float32)
    maps = rng.uniform(0, 1, (16, 20, 50)).astype(np.float32)
    got = tviz.train_batch_overlay(image, maps, channel)
    want = jviz.train_batch_overlay(image, maps, channel)
    assert got.dtype == np.uint8 and got.shape == (16, 20, 3)
    assert np.array_equal(got, want)


def test_save_batch_overlays_writes_the_jax_png(tmp_path):
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    maps = rng.uniform(0, 1, (2, 16, 16, 50)).astype(np.float32)
    a = tviz.save_batch_overlays(str(tmp_path / "a.png"), images, maps,
                                 (0, 30))
    b = jviz.save_batch_overlays(str(tmp_path / "b.png"), images, maps,
                                 (0, 30))
    assert np.array_equal(cv2.imread(a), cv2.imread(b))


def _tiny_pair():
    cfg = get_config("tiny")
    _, variables = _seeded_flax(cfg, 32, 32)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    return model, variables


def _total(table: str) -> int:
    last = table.splitlines()[-1]
    assert last.startswith("TOTAL")
    return int(last.split()[-1].replace(",", ""))


def test_param_table_total_equals_jax():
    model, variables = _tiny_pair()
    got, want = tviz.param_table(model), jviz.param_table(variables)
    assert _total(got) == _total(want) == sum(
        p.numel() for p in model.parameters())
    assert len(got.splitlines()) == len(want.splitlines())
    cut = tviz.param_table(model, max_rows=5).splitlines()
    assert len(cut) == 7 and cut[5].startswith("... (")


def test_module_dot_is_valid_dot_with_the_jax_total():
    model, variables = _tiny_pair()
    dot, jdot = tviz.module_dot(model), jviz.module_dot(variables)
    lines = dot.splitlines()
    assert lines[0] == "digraph model {" and lines[-1] == "}"
    node = r'(root|"n/[^"\\]*(\\.[^"\\]*)*")'
    for line in lines[1:-1]:
        assert line.endswith(";"), line
        body = line.strip()[:-1]
        assert (re.fullmatch(rf"{node} -> {node}", body)
                or re.fullmatch(rf'{node} \[label="[^"]*"\]', body)
                or body in ("rankdir=LR", "node [shape=box, fontsize=10]")), \
            line
    root = re.compile(r'root \[label="params\\n([0-9,]+)"\]')
    assert root.search(dot).group(1) == root.search(jdot).group(1)
    # every edge's ends are declared
    declared = {m.group(1) for m in re.finditer(r'^  ("n/[^"]+") \[', dot,
                                                re.M)} | {"root"}
    for a, b in re.findall(r'^  (\S+) -> (\S+);$', dot, re.M):
        assert a in declared and b in declared
    shallow = tviz.module_dot(model, max_depth=1)
    assert shallow.count("->") == len(
        {n.split(".")[0] for n, _ in model.named_parameters()})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from improved_body_parts_torch.data.fixture import build_fixture

    path = str(tmp_path_factory.mktemp("vis") / "train.h5")
    build_fixture(path, num_images=2, people_per_image=1, seed=4)
    return path


def _first_batch(corpus_path):
    """The train CLI's first batch of epoch 0 (the sync path's call)."""
    from improved_body_parts_torch.data import CocoPoseDataset, batches

    cfg = get_config("tiny")
    ds = CocoPoseDataset(corpus_path, cfg, augment=True, seed=0)
    try:
        return next(iter(batches(ds, cfg.train.batch_size_per_device, 0,
                                 pipeline="sync", wire=cfg.train.input_wire)))
    finally:
        ds.close()


@pytest.mark.parametrize("workers", [0, 1])
def test_debug_overlays_equal_jax_on_the_first_batch(corpus, tmp_path,
                                                     workers):
    from improved_body_parts_torch.cli import train

    ckpt = tmp_path / "ckpt"
    train.main(["--config", "tiny", "--epochs", "1", "--train-h5", corpus,
                "--checkpoint-dir", str(ckpt), "--workers", str(workers),
                "--debug-overlays", "--device", "cpu"])
    got = cv2.imread(str(ckpt / "overlays" / "epoch_0.png"))
    images, _, labels = _first_batch(corpus)
    sk = get_config("tiny").skeleton
    want = jviz.save_batch_overlays(str(tmp_path / "jax.png"), images,
                                    labels, (sk.bkg_start, sk.heat_start))
    assert got is not None and np.array_equal(got, cv2.imread(want))


def test_debug_overlays_skipped_under_device_gt(corpus, tmp_path, capsys):
    from improved_body_parts_torch.cli import train

    ckpt = tmp_path / "ckpt"
    train.main(["--config", "tiny", "--epochs", "1", "--train-h5", corpus,
                "--checkpoint-dir", str(ckpt), "--workers", "0",
                "--debug-overlays", "--device-gt", "4", "--device", "cpu"])
    assert ("--debug-overlays needs host-side labels; skipped under "
            "--device-gt") in capsys.readouterr().out
    assert not os.path.exists(ckpt / "overlays")
