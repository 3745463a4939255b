"""The port's training tools (``improved_body_parts_torch.cli``'s
``feed_rate``, ``ckpt_bench``, ``chaos_train``, ``ab_summary`` and
``list_coco``) and ``data.ShmRingInput.stream``, on the CPU at ``tiny``:

- ``stream()``: the port ring's batches across two epoch boundaries
  equal the JAX ring's ``stream()`` on the same HDF5 fixture bit for
  bit, and the port's own ``batches(0)``, ``batches(1)``, ... in order;
- ``feed_rate`` and ``ckpt_bench`` at smoke size: the artifact holds
  the JAX tool's keys (``workers_for_v5e8`` renamed
  ``workers_for_8_cards``) with the card stamp, ``ckpt_bench``'s sync
  and async saves restore bit-identical with one save an epoch; the
  train rate comes from a ``train_bench`` artifact's largest batch or
  ``--train-rate``, never a built-in figure;
- ``ab_summary``: the same per-seed numbers in the port's
  ``*_TORCH_S<n>.json`` give the JAX tool's verdicts on its own names,
  and the JAX names are not read;
- ``chaos_train``: its process-table, run-token and event-stream
  helpers, its resume check and verdict (a failed control run fails
  it), and its seed → injection plan against the JAX tool's (the JAX
  tool's ``main`` run with a stand-in ``Popen`` whose children die at
  once);
- a spawned ring worker maps no libtorch;
- ``list_coco`` prints the categories in the file's order and the
  sorted supercategories;
- the refusals: each JAX artifact name, ``--pipelines pool``, a missing
  train rate, and ``--device cuda`` on a host without a card.

A whole chaos run on the CPU (three supervised segments, two of them
resumed from a commit, and a control run) is marked ``slow``, as the
JAX package's own are.
"""
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from improved_body_parts_torch.cli import (
    ab_summary,
    chaos_train,
    ckpt_bench,
    feed_rate,
    list_coco,
)

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
from test_torch_models import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ stream()
@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    from improved_body_parts_torch.data.fixture import build_fixture

    path = str(tmp_path_factory.mktemp("ring") / "fixture.h5")
    build_fixture(path, num_images=3, people_per_image=1, seed=5)
    return path


def _take(it, n):
    out = []
    for batch in it:
        out.append(tuple(np.array(a) for a in batch))
        if len(out) == n:
            break
    it.close()
    return out


def test_stream_equals_the_jax_rings_across_two_epoch_boundaries(
        fixture_path):
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import CocoPoseDataset, ShmRingInput
    from improved_body_parts_tpu.config import get_config as jconfig
    from improved_body_parts_tpu.data import CocoPoseDataset as JDataset
    from improved_body_parts_tpu.data import ShmRingInput as JRing

    batch = 2
    ds = CocoPoseDataset(fixture_path, get_config("tiny"), seed=3)
    per_epoch = len(ds) // batch
    n = 2 * per_epoch + 1            # into the third epoch
    with ShmRingInput(ds, batch, 1, wire="uint8") as ring:
        got = _take(ring.stream(start_epoch=1), n)
        want_port = [b for e in (1, 2, 3)
                     for b in _take(ring.batches(e), per_epoch)][:n]
    jds = JDataset(fixture_path, jconfig("tiny"), seed=3)
    with JRing(jds, batch, 1, wire="uint8") as jring:
        want = _take(jring.stream(start_epoch=1), n)
    assert len(got) == len(want) == n
    for g, w, p in zip(got, want, want_port):
        for a, b, c in zip(g, w, p):
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert np.array_equal(a, c)


def test_a_spawned_ring_worker_starts_without_torch(fixture_path):
    """A ring worker imports ``data.shm_ring`` (so the package root and
    ``data``), none of which imports torch: its process maps no libtorch.
    The ring's owner is a fresh interpreter, so no test module is in it
    (its consumer side imports torch; spawn gives the worker none of
    that)."""
    code = (
        "import json\n"
        "from improved_body_parts_torch.config import get_config\n"
        "from improved_body_parts_torch.data import CocoPoseDataset, "
        "ShmRingInput\n"
        f"ds = CocoPoseDataset({fixture_path!r}, get_config('tiny'))\n"
        "with ShmRingInput(ds, 1, 1, wire='uint8') as ring:\n"
        "    it = ring.batches(0)\n"
        "    next(it)\n"
        "    maps = [open(f'/proc/{p.pid}/maps').read() "
        "for p in ring._procs]\n"
        "    it.close()\n"
        "print(json.dumps(['libtorch' in m for m in maps]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == [False]


def test_records_file_gives_the_hdf5_corpus_samples(fixture_path, tmp_path):
    """``save_records`` / ``open_corpus``: the ``.npz`` records of
    ``build_fixture``'s arguments sample as its HDF5 corpus does."""
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset, open_corpus
    from improved_body_parts_torch.data.fixture import (
        fixture_records,
        load_records,
        save_records,
    )

    cfg = get_config("tiny")
    records = fixture_records(num_images=3, people_per_image=1, seed=5)
    path = str(tmp_path / "train.npz")
    assert save_records(path, records) == len(records)
    for a, b in zip(load_records(path), records):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    npz, h5 = (open_corpus(path, cfg, seed=2),
               open_corpus(fixture_path, cfg, seed=2))
    assert isinstance(npz, MemoryDataset) and len(npz) == len(h5)
    for i in range(len(h5)):
        for x, y in zip(npz.sample(i, epoch=1), h5.sample(i, epoch=1)):
            assert np.array_equal(x, y)
    h5.close()


# ----------------------------------------------------------- feed_rate
JAX_FEED_KEYS = {"config", "image_size", "batch", "platform", "host_cores",
                 "host_note", "wire", "chip_train_rate_imgs_per_sec",
                 "protocol", "rows", "projection"}
JAX_PROJECTION_KEYS = {"sync_rate", "shm_per_worker_rate",
                       "workers_for_one_chip", "workers_for_v5e8"}


def _feed(tmp_path, *extra):
    return feed_rate.main(["--config", "tiny", "--records", "2", "--batch",
                           "2", "--workers", "0,1", "--min-seconds", "0.5",
                           "--repeats", "1", "--device", "cpu", "--out",
                           str(tmp_path / "feed.json"), *extra])


@pytest.fixture(scope="module")
def feed_report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("feed")
    bench = tmp / "train_bench_torch.json"
    bench.write_text(json.dumps({"batches": {
        "2": {"imgs_per_sec": 5.0}, "8": {"imgs_per_sec": 12.5},
        "4": {"imgs_per_sec": 20.0}}}, allow_nan=False))
    report = _feed(tmp, "--train-bench", str(bench))
    return report, json.loads((tmp / "feed.json").read_text())


def test_feed_rate_artifact_has_the_jax_keys(feed_report):
    report, on_disk = feed_report
    assert on_disk == json.loads(json.dumps(report, allow_nan=False))
    assert set(report) == JAX_FEED_KEYS | {"device", "power_limit",
                                           "train_rate_source"}
    assert report["platform"] == report["device"] == "cpu"
    assert report["power_limit"] is None
    assert {(r["mode"], r["pipeline"], r["workers"])
            for r in report["rows"]} == {
        ("host_gt", "sync", 0), ("host_gt", "shm", 1),
        ("device_gt", "sync", 0), ("device_gt", "shm", 1)}
    for r in report["rows"]:
        assert r["samples"] > 0 and np.isfinite(r["samples_per_sec"])
    for proj in report["projection"].values():
        assert set(proj) == (JAX_PROJECTION_KEYS - {"workers_for_v5e8"}
                             | {"workers_for_8_cards"})


def test_feed_rate_takes_the_largest_train_bench_batch(feed_report):
    report, _ = feed_report
    # batch 8's rate, not the fastest batch's
    assert report["chip_train_rate_imgs_per_sec"] == 12.5
    for mode, proj in report["projection"].items():
        per = proj["shm_per_worker_rate"]
        assert proj["workers_for_one_chip"] == int(np.ceil(12.5 / per))
        assert proj["workers_for_8_cards"] == int(np.ceil(100.0 / per))


def test_feed_rate_asks_for_a_train_rate_without_the_artifact(tmp_path):
    with pytest.raises(SystemExit, match="--train-rate"):
        _feed(tmp_path, "--train-bench", str(tmp_path / "missing.json"))


def test_feed_rate_takes_train_rate_flag(tmp_path):
    report = feed_rate.main([
        "--config", "tiny", "--records", "2", "--batch", "2", "--workers",
        "0", "--min-seconds", "0.2", "--repeats", "1", "--train-rate", "7",
        "--device", "cpu", "--out", str(tmp_path / "f.json")])
    assert report["chip_train_rate_imgs_per_sec"] == 7.0
    assert report["train_rate_source"] == "--train-rate 7.0"
    assert report["projection"] == {}     # no shm row, no per-worker rate


@pytest.mark.parametrize("args,match", [
    (["--out", "INPUT_PIPELINE.json"], "JAX tool's artifact"),
    (["--pipelines", "sync,shm,pool"], "not ported"),
])
def test_feed_rate_refusals(tmp_path, args, match):
    with pytest.raises(SystemExit, match=match):
        feed_rate.main(["--config", "tiny", "--train-rate", "1",
                        "--device", "cpu", "--out",
                        str(tmp_path / "f.json"), *args])


# ---------------------------------------------------------- ckpt_bench
JAX_CKPT_KEYS = {
    "config", "protocol", "rounds", "epochs_per_arm", "steps_per_epoch",
    "payload_bytes", "saves_per_arm", "sync_stall_ms_mean",
    "sync_stall_ms_median", "async_stall_ms_mean", "async_stall_ms_median",
    "per_round_stall_reduction", "stall_reduction", "stall_reduction_target",
    "meets_target", "bit_identical_restore", "write_spans",
    "snapshot_spans", "write_overlapping_later_spans",
    "write_overlaps_step_or_eval", "trace", "telemetry_events", "host_note",
    "commit_meta_sample"}


@pytest.fixture(scope="module")
def ckpt_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt") / "ckpt_bench_torch.json"
    report = ckpt_bench.main(["--config", "tiny", "--rounds", "1",
                              "--epochs", "2", "--steps", "2",
                              "--eval-steps", "1", "--device", "cpu",
                              "--out", str(out)])
    return report, json.loads(out.read_text())


def test_ckpt_bench_restores_bit_identical_one_save_an_epoch(ckpt_report):
    report, on_disk = ckpt_report
    assert report["bit_identical_restore"] is True
    assert report["saves_per_arm"] == report["epochs_per_arm"] == 2
    assert on_disk["bit_identical_restore"] is True
    assert report["stall_reduction_target"] == 5.0
    assert report["meets_target"] == (report["stall_reduction"] >= 5.0)


def test_ckpt_bench_artifact_has_the_jax_keys(ckpt_report):
    report, _ = ckpt_report
    assert JAX_CKPT_KEYS <= set(report)
    assert set(report) - JAX_CKPT_KEYS == {"batch", "image_size",
                                           "platform", "device",
                                           "power_limit"}
    model = __import__("improved_body_parts_torch.models",
                       fromlist=["build_model"]).build_model(
        __import__("improved_body_parts_torch.config",
                   fromlist=["get_config"]).get_config("tiny"),
        device="cpu")
    n = sum(p.numel() for p in model.parameters())
    # params + momentum + SWA shadow in fp32, plus BN stats and the count
    assert report["payload_bytes"] > 3 * 4 * n
    assert report["write_spans"] == 2 * report["saves_per_arm"]
    assert report["snapshot_spans"] == report["saves_per_arm"]
    assert report["commit_meta_sample"]["async"] is True


def test_ckpt_bench_write_overlap_reading():
    events = [
        {"ph": "X", "name": "serialize", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "name": "commit", "ts": 150.0, "dur": 10.0},
        {"ph": "X", "name": "step_window", "ts": 120.0, "dur": 5.0},
        {"ph": "X", "name": "eval_epoch", "ts": 155.0, "dur": 5.0},
        {"ph": "X", "name": "compute", "ts": 90.0, "dur": 30.0},
        {"ph": "i", "name": "step_window", "ts": 130.0},
    ]
    assert ckpt_bench.write_overlaps(events) == 2


def test_ckpt_bench_refuses_the_jax_artifact(tmp_path):
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        ckpt_bench.main(["--device", "cpu", "--out",
                         str(tmp_path / "CKPT_BENCH.json")])


# ---------------------------------------------------------- ab_summary
def _write(d, name, **kw):
    with open(os.path.join(d, name), "w") as f:
        json.dump(kw, f, allow_nan=False)


SCENARIOS = {
    "neutral": [("SYNTH_AP_DEEP_S1.json", "ap_trained", 0.90),
                ("SYNTH_AP_DEEP_S2.json", "ap_trained", 0.92),
                ("SYNTH_AP_DEEP_SWA_S1.json", "ap_swa", 0.905),
                ("SYNTH_AP_DEEP_SWA_S2.json", "ap_swa", 0.915)],
    "win": [("SYNTH_AP_DEEP_S1.json", "ap_trained", 0.90),
            ("SYNTH_AP_DEEP_S2.json", "ap_trained", 0.91),
            ("SYNTH_AP_DEEP_DEVICEGT_S1.json", "ap_trained", 0.95),
            ("SYNTH_AP_DEEP_DEVICEGT_S2.json", "ap_trained", 0.96)],
    "consistent": [("SYNTH_AP_CROWD_S1.json", "ap_trained", 0.60),
                   ("SYNTH_AP_CROWD_S2.json", "ap_trained", 0.64),
                   ("SYNTH_AP_CROWD_UNMASKED_S1.json", "ap_trained", 0.59),
                   ("SYNTH_AP_CROWD_UNMASKED_S2.json", "ap_trained", 0.63)],
    "one_seed": [("SYNTH_AP_DEEP_S3.json", "ap_trained", 0.80),
                 ("SYNTH_AP_DEEP_SWA_S3.json", "ap_swa", 0.85)],
    "missing_arm": [("SYNTH_AP_DEEP_S1.json", "ap_trained", 0.9)],
}


def _torch_name(name):
    return re.sub(r"_S(\d+)\.json$", r"_TORCH_S\1.json", name)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_ab_summary_gives_the_jax_verdicts(tmp_path, scenario):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    for name, key, value in SCENARIOS[scenario]:
        _write(str(jdir), name, **{key: value})
        _write(str(tdir), _torch_name(name), **{key: value})
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ab_summary.py"),
         "--dir", str(jdir), "--out", str(jdir / "AB.json")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-800:]
    want = json.loads((jdir / "AB.json").read_text())
    got = ab_summary.main(["--dir", str(tdir), "--out",
                           str(tdir / "ab_summary_torch.json")])
    for pair in ("swa_vs_base", "devgt_vs_hostgt",
                 "crowd_masked_vs_ablated"):
        g, w = dict(got[pair]), dict(want[pair])
        g.pop("sources", None)
        sources = w.pop("sources", None)
        if "note" in w:
            assert g == w
            continue
        assert g == w, pair
        assert got[pair]["sources"] == sorted(_torch_name(s)
                                              for s in sources)


def test_ab_summary_reads_no_jax_artifact(tmp_path):
    for name, key, value in SCENARIOS["win"]:
        _write(str(tmp_path), name, **{key: value})
    got = ab_summary.main(["--dir", str(tmp_path), "--out",
                           str(tmp_path / "s.json")])
    for pair in ("swa_vs_base", "devgt_vs_hostgt",
                 "crowd_masked_vs_ablated"):
        assert got[pair]["note"].startswith("no common seeds")


def test_ab_summary_refuses_the_jax_artifact(tmp_path):
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        ab_summary.main(["--dir", str(tmp_path), "--out",
                         str(tmp_path / "AB_SUMMARY.json")])


# --------------------------------------------------------- chaos_train
def test_process_table_finds_descendants_and_waits_them_out():
    parent = subprocess.Popen(
        [sys.executable, "-c",
         "import subprocess, sys, time; "
         "subprocess.Popen([sys.executable, '-c', "
         "'import time; time.sleep(30)']); time.sleep(30)"])
    try:
        deadline = time.monotonic() + 20
        kids = []
        while time.monotonic() < deadline and not kids:
            kids = chaos_train.descendants(parent.pid)
            time.sleep(0.05)
        assert len(kids) == 1
        assert chaos_train.proc_table()[kids[0]] == parent.pid
        assert "time.sleep(30)" in chaos_train.cmdline(kids[0])
        assert chaos_train.ring_worker_pids(parent.pid) == []
        assert chaos_train.wait_gone(kids, timeout_s=0.3) == kids
        for pid in kids + [parent.pid]:
            os.kill(pid, 9)
        parent.wait()
        assert chaos_train.wait_gone(kids, timeout_s=10) == []
    finally:
        if parent.poll() is None:
            parent.kill()
            parent.wait()


def test_processes_with_env_finds_only_the_runs_token():
    env = dict(os.environ, **{chaos_train.RUN_TOKEN_ENV: "run_a"})
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)"], env=env)
    try:
        name = chaos_train.RUN_TOKEN_ENV
        assert chaos_train.processes_with_env(name, "run_a") == [child.pid]
        assert chaos_train.processes_with_env(name, "run_b") == []
        assert os.getpid() not in chaos_train.processes_with_env(
            name, "run_a")
        child.kill()
        child.wait()
        assert chaos_train.processes_with_env(name, "run_a") == []
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


STEP, RESUME0 = {"event": "train_step"}, {"event": "resume", "epoch": 0}


@pytest.mark.parametrize("committed,events,want", [
    (-1, [{"event": "resume", "found": False}, STEP], True),
    (-1, [RESUME0, STEP], False),
    (0, [RESUME0, STEP], True),
    (1, [RESUME0, STEP], False),
    (0, [{"event": "resume", "found": False}, STEP], False),
    (0, [STEP], False),             # trained past a commit, no resume
    (0, [], True),                  # killed before it resumed
])
def test_resume_matches_the_last_commit(committed, events, want):
    assert chaos_train.resume_matches(committed, events) is want


GOOD_RUN = dict(completed=True, resume_mismatches=[], leaked=[],
                writer_leak=False, control_requested=True, final_ok=True)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"final_ok": None}, False),    # the control run failed
    ({"final_ok": False}, False),
    ({"control_requested": False, "final_ok": None}, True),
    ({"completed": False}, False),
    ({"resume_mismatches": [{"segment": 1}]}, False),
    ({"leaked": [123]}, False),
    ({"writer_leak": True}, False),
])
def test_run_ok_verdicts(change, want):
    assert chaos_train.run_ok(**{**GOOD_RUN, **change}) is want


def test_read_events_skips_torn_lines(tmp_path):
    path = tmp_path / "events.jsonl"
    assert chaos_train.read_events(str(path)) == []
    path.write_text('{"event": "a"}\n\nnot json\n{"event": "b", "x": 1}\n'
                    '{"event": "c"')
    assert chaos_train.read_events(str(path)) == [
        {"event": "a"}, {"event": "b", "x": 1}]


class _Exited:
    def __init__(self, rc=0):
        self.returncode = rc

    def poll(self):
        return self.returncode


def test_wait_for_event_reads_from_start_and_after_exit(tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps({"event": "train_step", "n": i},
                                       allow_nan=False) + "\n"
                            for i in range(3)))
    is_step = (lambda e: e["event"] == "train_step")  # noqa: E731
    got = chaos_train.wait_for_event(str(path), is_step, _Exited(),
                                     timeout_s=1, start=2)
    assert got == {"event": "train_step", "n": 2}
    assert chaos_train.wait_for_event(str(path), is_step, _Exited(),
                                      timeout_s=1, start=3) is None


def test_steps_per_epoch_follow_the_configs_batch():
    from improved_body_parts_torch.config import get_config

    for name in ("tiny", "synth", "canonical"):
        batch = get_config(name).train.batch_size_per_device
        assert chaos_train.steps_per_epoch(name, 8) == max(8 // batch, 1)
    assert chaos_train.steps_per_epoch("canonical", 2) == 1


class _DeadChild:
    """A child that exits at once with code 0; keeps its kill spec."""
    specs = []

    def __init__(self, argv, env=None, **kw):
        _DeadChild.specs.append((env or {}).get("IBP_CHAOS_KILL"))
        self.returncode, self.pid, self.stderr = 0, 0, None

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def send_signal(self, sig):
        pass


def _plan_of(run, tmp_path, monkeypatch, out):
    """The segments' injections of a chaos tool's ``run()`` whose
    children all die at once (no checkpoint is ever committed)."""
    import tempfile

    _DeadChild.specs = []
    monkeypatch.setattr(subprocess, "Popen", _DeadChild)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run()
    with open(out) as f:
        report = json.load(f)
    return [s["injection"] for s in report["segments"]], report


@pytest.mark.parametrize("seed,kills", [(6, 2), (35, 2), (0, 2), (11, 3),
                                        (3, 8)])
def test_injection_plan_equals_the_jax_tools(tmp_path, monkeypatch, seed,
                                             kills):
    import chaos_train as jchaos

    flags = ["--kills", str(kills), "--seed", str(seed), "--epochs", "6",
             "--records", "6", "--no-control"]
    jout, tout = str(tmp_path / "CHAOS.json"), str(tmp_path / "c.json")
    monkeypatch.setattr(sys, "argv", ["chaos_train.py", *flags, "--out",
                                      jout])
    want, _ = _plan_of(jchaos.main, tmp_path, monkeypatch, jout)
    want_specs = list(_DeadChild.specs)
    # the JAX tool takes 2 samples a step at tiny ("batch 2"); the port
    # reads the config's batch (1 at tiny): held to the JAX count here,
    # the draws are the same
    monkeypatch.setattr(chaos_train, "steps_per_epoch",
                        lambda config, records: max(records // 2, 1))
    got, report = _plan_of(lambda: chaos_train.main(
        [*flags, "--device", "cpu", "--out", tout]), tmp_path, monkeypatch,
        tout)
    assert got == want
    assert _DeadChild.specs == want_specs
    assert len([g for g in got if g]) == kills
    assert report["injections_done"] == kills
    rng = random.Random(seed)
    assert report["injection_kinds"] == sorted(set(
        chaos_train.injection_plan(rng, kills)))


def test_seed_35_tears_the_second_write_then_sends_a_sigterm():
    """The plan of ``chip_smoke.py`` phase 15(c) and the slow run below:
    at 4 epochs the SIGKILL lands at the second ``mid_ckpt_write`` hit,
    after epoch 0's commit (a save waits for the write before it)."""
    rng = random.Random(35)
    assert chaos_train.injection_plan(rng, 2) == ["mid_ckpt_write",
                                                  "sigterm"]
    assert chaos_train.pick_hit(rng, "mid_ckpt_write", -1, 4, 2) == 2
    plan = chaos_train.injection_plan(random.Random(0), 8)
    assert sorted(set(plan)) == sorted(chaos_train.KINDS)


@pytest.mark.parametrize("cli,name", [(chaos_train, "CHAOS.json"),
                                      (chaos_train, "CHAOS_SMOKE.json")])
def test_chaos_train_refuses_the_jax_artifacts(tmp_path, cli, name):
    with pytest.raises(SystemExit, match="JAX tool's artifact"):
        cli.main(["--device", "cpu", "--out", str(tmp_path / name)])


@pytest.mark.slow
def test_chaos_run_two_kills_with_the_control(tmp_path):
    out = str(tmp_path / "chaos_train_torch.json")
    report = chaos_train.main(["--config", "tiny", "--kills", "2", "--seed",
                               "35", "--epochs", "4", "--records", "4",
                               "--device", "cpu", "--strict", "--out", out])
    assert report["ok"] and report["completed"]
    assert report["injections_done"] == 2
    assert report["injection_kinds"] == ["mid_ckpt_write", "sigterm"]
    assert report["all_resumes_on_last_committed"]
    # the torn write came after epoch 0's commit: the SIGTERM segment and
    # the last one resume from it, and the final state is compared after
    first, *rest = report["segments"]
    assert first["injection"] == {"kind": "mid_ckpt_write", "hit": 2}
    assert first["committed_after"] == 0
    assert report["resumes_from_commit"] == len(rest) == 2
    assert all(s["resumed_from"] == s["committed_before"] == 0
               for s in rest)
    assert rest[-1]["end_status"] == "completed"
    assert report["leaked_pids_total"] == 0
    assert report["writer_thread_leaked"] is False
    assert report["control"]["returncode"] == 0
    assert report["final_matches_control"] is True


# --------------------------------------------------- device and list_coco
@pytest.mark.parametrize("cli,args", [
    (feed_rate, ["--config", "tiny", "--train-rate", "1"]),
    (ckpt_bench, ["--config", "tiny"]),
    (chaos_train, ["--config", "tiny"]),
])
def test_the_tools_default_to_cuda_and_raise_without_a_card(
        tmp_path, monkeypatch, cli, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([*args, "--out", str(tmp_path / "out_torch.json")])


def test_list_coco_prints_categories_and_supercategories(tmp_path, capsys):
    anno = tmp_path / "instances_tiny.json"
    anno.write_text(json.dumps({"images": [], "annotations": [],
                                "categories": [
                                    {"id": 3, "name": "car",
                                     "supercategory": "vehicle"},
                                    {"id": 1, "name": "person",
                                     "supercategory": "person"},
                                    {"id": 18, "name": "dog",
                                     "supercategory": "animal"},
                                    {"id": 2, "name": "bicycle",
                                     "supercategory": "vehicle"}]},
                               allow_nan=False))
    names, supers = list_coco.main(["--anno", str(anno)])
    assert names == ["car", "person", "dog", "bicycle"]
    assert supers == ["animal", "person", "vehicle"]
    assert capsys.readouterr().out == (
        "COCO categories:\ncar person dog bicycle\n\n"
        "COCO supercategories:\nanimal person vehicle\n")
