"""The train CLI's new flags end to end on the CPU, and the COCO -> HDF5
builder.

- ``cli.make_corpus`` (``data.hdf5_corpus.build_coco_corpus``) writes the
  JAX builder's HDF5 bit for bit (every dataset, every attribute) from the
  fixture's COCO-format train set (crowd regions included).
- ``cli.train`` on a tiny corpus, ``--device cpu``:
  ``--workers 2 --input-pipeline shm --device-gt 6 --wire uint8`` trains
  to the same final state SHA-256 as ``--input-pipeline sync``;
  ``--no-focal``, ``--on-divergence skip_step``; ``--supervised`` runs
  to its total and a second launch finds the target reached, with both
  segments in ``RUN.json``; ``--distill-from`` (an epoch directory or a
  checkpoint directory) with ``--teacher-config``, ``--distill-alpha``
  and ``--distill-alpha-warmup``; ``--swa --swa-freq`` resumes and saves
  an SWA checkpoint; ``cli.swa_stage`` on that workdir writes its
  artifact.
- the conflicting flags, and the one option the port does not have,
  raise a clear error (the multi-card flags run end to end in
  ``test_torch_dist.py``).
"""
import json
import os
import sys

import h5py
import numpy as np
import pytest

from improved_body_parts_torch.cli import parse_reports
from improved_body_parts_torch.cli import train as cli_train
from improved_body_parts_torch.cli.make_corpus import main as make_corpus
from improved_body_parts_torch.data.fixture import (
    build_coco_train_set,
    build_fixture,
    build_val_set,
)
from improved_body_parts_torch.train import (
    latest_checkpoint,
    restore_checkpoint,
)
from improved_body_parts_tpu.data.hdf5_corpus import \
    build_coco_corpus as jbuild_coco_corpus

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(v).tolist() if not isinstance(v, str)
                     else v for k, v in obj.attrs.items()}
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (data, attrs)
        f.visititems(visit)
    return out


def test_make_corpus_equals_the_jax_builder(tmp_path):
    img_dir, anno = str(tmp_path / "images"), str(tmp_path / "ann.json")
    assert build_coco_train_set(img_dir, anno, num_images=6,
                                img_size=(96, 128), people_per_image=2,
                                image_size=128, crowd=True, seed=5) >= 6
    outs = {k: (str(tmp_path / f"{k}_tr.h5"), str(tmp_path / f"{k}_va.h5"))
            for k in ("port", "jax")}
    counts = make_corpus(["--anno", anno, "--images", img_dir,
                          "--out-train", outs["port"][0],
                          "--out-val", outs["port"][1],
                          "--image-size", "128", "--val-size", "2"])
    assert counts == jbuild_coco_corpus(anno, img_dir, *outs["jax"],
                                        image_size=128, val_size=2)
    assert counts[0] > 0 and counts[1] > 0
    for got, want in zip(outs["port"], outs["jax"]):
        g, w = _h5_items(got), _h5_items(want)
        assert g.keys() == w.keys()
        for name in w:
            assert g[name][1] == w[name][1], name
            if w[name][0] is None:
                assert g[name][0] is None
            else:
                np.testing.assert_array_equal(g[name][0], w[name][0],
                                              err_msg=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_train")
    path = str(d / "train.h5")
    assert build_fixture(path, num_images=3, people_per_image=2,
                         image_size=128, seed=4, drawn=True) >= 4
    return path


def _run(capsys, *argv):
    cli_train.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    (report,) = parse_reports(out)
    return report, out


def test_ring_and_device_gt_match_the_sync_pipeline(corpus, tmp_path,
                                                    capsys):
    common = ["--config", "tiny", "--epochs", "1", "--train-h5", corpus,
              "--device-gt", "6", "--wire", "uint8", "--no-focal",
              "--on-divergence", "skip_step", "--seed", "3"]
    shm, _ = _run(capsys, *common, "--workers", "2", "--input-pipeline",
                  "shm", "--checkpoint-dir", str(tmp_path / "shm"))
    sync, _ = _run(capsys, *common, "--workers", "2", "--input-pipeline",
                   "sync", "--checkpoint-dir", str(tmp_path / "sync"))
    assert shm["steps"] == sync["steps"] > 0
    assert shm["state_sha256"] == sync["state_sha256"]
    assert shm["data_wait_ms_per_step"] >= 0


def test_supervised_run_reaches_its_total(corpus, tmp_path, capsys):
    ckpt = str(tmp_path / "sup")
    argv = ["--config", "tiny", "--epochs", "2", "--train-h5", corpus,
            "--checkpoint-dir", ckpt, "--supervised", "--workers", "0"]
    first, _ = _run(capsys, *argv)
    assert first["steps"] > 0
    second, out = _run(capsys, *argv)
    assert second["steps"] == 0 and "already reached" in out
    with open(os.path.join(ckpt, "RUN.json")) as f:
        run = json.load(f)
    assert [s["status"] for s in run["segments"]] == ["completed"] * 2
    assert run["segments"][1]["resumed_epoch"] == 1
    assert run["tool"] == "train"


def test_distill_and_swa_flags(corpus, tmp_path, capsys):
    teacher_dir = str(tmp_path / "teacher")
    _run(capsys, "--config", "tiny", "--epochs", "1", "--train-h5", corpus,
         "--checkpoint-dir", teacher_dir, "--workers", "0")
    student_dir = str(tmp_path / "student")
    for source in (latest_checkpoint(teacher_dir), teacher_dir):
        report, out = _run(
            capsys, "--config", "tiny_student", "--epochs", "1",
            "--train-h5", corpus, "--checkpoint-dir", student_dir,
            "--workers", "0", "--distill-from", source,
            "--teacher-config", "tiny", "--distill-alpha", "0.7",
            "--distill-alpha-warmup", "2")
        assert report["steps"] > 0 and "distilling from" in out
        assert "alpha 0.7, warmup 2 steps" in out
    report, out = _run(capsys, "--config", "tiny_student", "--epochs", "1",
                       "--train-h5", corpus, "--checkpoint-dir",
                       student_dir, "--workers", "0", "--swa",
                       "--swa-freq", "1", "--resume", "auto")
    assert "SWA checkpoint saved" in out
    saved = restore_checkpoint(latest_checkpoint(student_dir))
    assert saved["swa_count"] == 2 and saved["swa_params"] is not None


def test_swa_stage_cli_on_a_workdir(corpus, tmp_path):
    from improved_body_parts_torch.cli import swa_stage

    work = tmp_path / "work"
    work.mkdir()
    os.symlink(corpus, work / "train_drawn.h5")
    build_val_set(str(work / "val"), str(work / "person_keypoints_synth"
                                          ".json"), num_images=2,
                  people_per_image=2, image_size=128, seed=9, drawn=True)
    cli_train.main(["--config", "tiny", "--epochs", "1", "--train-h5",
                    corpus, "--checkpoint-dir", str(work / "ckpt"),
                    "--workers", "0", "--device", "cpu"])
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"ap_trained": 0.25}, allow_nan=False))
    out = tmp_path / "swa.json"
    result = swa_stage.main(["--workdir", str(work), "--config", "tiny",
                             "--epochs", "1", "--swa-freq", "1",
                             "--base", str(base), "--out", str(out),
                             "--device", "cpu"])
    assert 0.0 <= result["ap_swa"] <= 1.0
    assert result["swa_delta"] == pytest.approx(result["ap_swa"] - 0.25)
    assert result["checkpoint"].endswith("epoch_1")
    assert json.loads(out.read_text())["ap_base"] == 0.25
    (rep,) = result["cli_reports"]["train"]
    assert rep["device"] == "cpu" and rep["steps"] > 0


@pytest.mark.parametrize("argv,match", [
    (["--input-pipeline", "pool"], "pool"),
    (["--partition", "--swa"], "SWA stage without it"),
    (["--partition", "--partition-rules", "nope"], "unknown"),
    (["--partition-rules", "imhn"], "require --partition"),
    (["--mesh-model", "2"], "require --partition"),
    (["--coordinator", "localhost:1"], "pass both or neither"),
    (["--num-processes", "2"], "pass both or neither"),
    (["--process-id", "1"], "out of range"),
    (["--supervised", "--swa"], "SWA stage unsupervised"),
    (["--distill-from", "x", "--teacher-config", "tiny", "--device-gt",
      "4"], "--device-gt"),
    (["--distill-from", "x", "--teacher-config", "tiny", "--partition"],
     "replicated step .* drop --partition"),
])
def test_unported_and_conflicting_flags_are_refused(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_train.main(["--config", "tiny", *argv, "--device", "cpu"])
