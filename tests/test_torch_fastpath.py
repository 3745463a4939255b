"""The port's temporal-coherence fast path
(``improved_body_parts_torch.stream.fastpath``) and its bench
(``cli.stream_bench``) held to the JAX package's, on the CPU.

- ``FastPath`` decisions equal the JAX package's on the same seeded
  sequence of delivered tiers, signals, tracker boxes and failures, over
  several configurations; ``signals_from_people``, ``split_result``,
  ``paste_back`` and ``FastPathMetrics`` equal on the same inputs.
- ``quality_arm`` of ``cli.stream_bench`` and of ``tools/stream_bench.py``
  give the same document (but the host-clock latencies) on the
  ``static`` and ``slow_pan`` scenes at one and two people, with the fast
  path on (the ROI tier engaged where the person fits its window,
  three-tier conservation exact) and off.
- Over the port's ``DynamicBatcher`` (stub predictor of
  ``tests/test_torch_serve.py``, ``emit_signals=True``): the ROI bucket
  warmed through ``DynamicBatcher.warmup`` runs no lane shape first after
  warmup (``obs.CompileWatch``), the tier sequence equals the JAX
  package's over its own stub, and the ROI answer is the crop's own
  decode pasted back by the anchor.
- ``cli.stream_bench --fastpath --device cpu`` end to end in a tmp dir,
  and its default mode (the N-stream and serial 1-stream rounds).
"""
import json
import os
import sys

import numpy as np
import pytest

import improved_body_parts_torch.stream as ts
import improved_body_parts_tpu.stream as js
from improved_body_parts_torch.stream import fastpath as tfp
from improved_body_parts_tpu.stream import fastpath as jfp

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")
from test_torch_models import one_torch_thread  # noqa: E402,F401


class _Box:
    """The tracker surface the policy reads (``union_box``,
    ``confirmed``)."""

    def __init__(self, box, confirmed):
        self.box, self._confirmed = box, confirmed

    @property
    def confirmed(self):
        return self._confirmed

    def union_box(self):
        return self.box


CONFIGS = [
    dict(max_skip_run=3, min_stable=2),
    dict(max_skip_run=1, min_stable=1, roi_width=200, roi_margin=10,
         full_refresh_every=3),
    dict(max_skip_run=2, min_stable=1, roi_width=160, roi_margin=4,
         full_refresh_every=0, people_delta=1, score_floor=0.3),
    dict(max_skip_run=4, min_stable=3, roi_width=300,
         escalate_on_overflow=False),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_fastpath_decisions_equal_jax(cfg):
    """200 frames of one seeded scenario through both policies: every
    decision, and the final snapshot, equal."""
    rng = np.random.default_rng(len(str(cfg)))
    fps = (jfp.FastPath(jfp.FastPathConfig(**cfg)),
           tfp.FastPath(tfp.FastPathConfig(**cfg)))
    n_people = 2
    for _ in range(200):
        got = [fp.decide(120, 480) for fp in fps]
        assert tuple(got[1]) == tuple(got[0])
        if rng.uniform() < 0.05:
            for fp in fps:
                fp.on_failed(got[0].tier)
            continue
        if rng.uniform() < 0.1:
            n_people = int(rng.integers(0, 4))
        x0 = float(rng.uniform(0, 400))
        box = (x0, 10.0, x0 + float(rng.uniform(5, 250)), 100.0)
        confirmed = int(rng.integers(0, 3))
        flags = [bool(rng.uniform() < 0.03) for _ in range(3)]
        score = float(rng.uniform(0.2, 1.0))
        for mod, fp in zip((jfp, tfp), fps):
            sig = mod._Signals(n_people, *flags, score, True)
            fp.on_delivered(got[0].tier, sig, _Box(box, confirmed))
    assert fps[1].snapshot() == fps[0].snapshot()


def test_signals_split_and_paste_back_equal():
    rng = np.random.default_rng(3)
    people = [([(float(x), float(y)) if rng.uniform() > 0.2 else None
                for x, y in rng.uniform(0, 200, (17, 2))],
               float(rng.uniform(0, 1))) for _ in range(3)]
    for ps in ([], people):
        assert tuple(ts.signals_from_people(ps)) == tuple(
            js.signals_from_people(ps))
    sig = ts.signals_from_people(people)
    assert tfp.split_result((people, sig)) == (people, sig)
    assert tfp.split_result(people) == jfp.split_result(people)
    for off in ((0, 0), (37, 0), (120, 5)):
        assert ts.paste_back(people, off) == js.paste_back(people, off)


def test_fastpath_metrics_equal_and_conservation_exact():
    rng = np.random.default_rng(5)
    ms = (js.FastPathMetrics(), ts.FastPathMetrics())
    open_tiers = []
    for i in range(300):
        if open_tiers and rng.uniform() < 0.55:
            tier = open_tiers.pop(int(rng.integers(len(open_tiers))))
            kind = rng.choice(["answer", "fail", "drop"], p=[0.8, 0.1, 0.1])
            lat = float(rng.uniform(0, 0.05))
            for m in ms:
                if kind == "answer":
                    m.on_answer(tier, lat)
                elif kind == "fail":
                    m.on_fail(tier)
                else:
                    m.on_drop(tier)
        else:
            tier = str(rng.choice(jfp.TIERS))
            reason = (None if tier == "tracker"
                      else str(rng.choice(jfp.FASTPATH_REASONS)))
            open_tiers.append(tier)
            for m in ms:
                m.on_submit(tier, reason)
        assert ms[1].conservation() == ms[0].conservation()
    assert ms[1].conservation()["exact"]
    assert ms[1].snapshot() == ms[0].snapshot()
    assert tfp.TIERS == jfp.TIERS
    assert tfp.FASTPATH_REASONS == jfp.FASTPATH_REASONS


def _no_latency(doc):
    """A quality document without its host-clock tier latencies."""
    doc = dict(doc)
    if "fastpath" in doc:
        doc["fastpath"] = {k: v for k, v in doc["fastpath"].items()
                           if k != "tier_latency_ms"}
    return doc


@pytest.mark.parametrize("scene,people", [
    ("static", 1), ("static", 2), ("slow_pan", 1), ("slow_pan", 2)])
def test_quality_arm_equal_jax(scene, people):
    """The bench's deterministic quality protocol in both packages, fast
    path on and off: the same document (but the host-clock latencies),
    AP and identity switches equal across the arms, forwards saved,
    three-tier conservation exact; one person fits the ROI window, two
    do not."""
    import stream_bench as jbench

    from improved_body_parts_torch.cli import stream_bench as tbench

    kw = dict(max_skip_run=3, min_stable=2, roi_width=160, roi_margin=16,
              full_refresh_every=4, people_delta=0)
    docs = {}
    for name, bench, mod in (("jax", jbench, js), ("torch", tbench, ts)):
        cfg = mod.FastPathConfig(**kw)
        docs[name] = [_no_latency(bench.quality_arm(scene, 24, 256,
                                                    people, 3, c))
                      for c in (cfg, None)]
    assert docs["torch"] == docs["jax"]
    on, off = docs["torch"]
    assert on["synthetic_ap"] == off["synthetic_ap"]
    assert on["identity_switches"] == off["identity_switches"]
    assert on["engine_forwards"] < off["engine_forwards"]
    cons = on["fastpath"]["conservation"]
    assert cons["exact"] and cons["answered_tracker"] > 0
    assert (cons["answered_roi"] > 0) == (people == 1)
    assert cons["submitted"] == (cons["answered_tracker"]
                                 + cons["answered_roi"]
                                 + cons["escalated_full"] + cons["failed"]
                                 + cons["dropped"] + cons["depth"])


# --------------------------------------------------------------------- #
# the ROI bucket over the port's DynamicBatcher                         #
# --------------------------------------------------------------------- #
SIZE = (256, 256)
# the planted people span x ~[0, 174]: with margins they fit a 192-wide
# window, a narrower lane than the 256 full frame
ROI_W = 192


def _roi_run(obs, serve, stream, pred, warm):
    """The JAX test's 8-frame ROI sequence over one package's batcher;
    returns (fastpath snapshot, delivered people, first runs after
    warmup)."""
    watch = obs.CompileWatch(obs.Registry()).install()
    try:
        cfg = stream.FastPathConfig(max_skip_run=2, min_stable=1,
                                    roi_width=ROI_W, roi_margin=8,
                                    full_refresh_every=0)
        img = np.zeros((*SIZE, 3), np.uint8)
        with serve.DynamicBatcher(pred, max_batch=2, max_wait_ms=20,
                                  use_native=False,
                                  emit_signals=True) as server:
            warm(server)
            with stream.SessionManager(server, fastpath=cfg) as mgr:
                # max_age=0: the content-blind stub answers the crop
                # with shifted people, so the pre-shift track must die
                session = mgr.open("cam0",
                                   tracker=stream.Tracker(max_age=0))
                watch.mark_warm("both buckets warmed")
                results = [session.submit_frame(img).result(timeout=120)
                           for _ in range(8)]
        return (session.fastpath.snapshot(),
                [[(p.keypoints, p.score) for p in r] for r in results],
                watch.recompiles.value)
    finally:
        watch.uninstall()


def test_roi_bucket_warmed_zero_first_runs_and_jax_tiers():
    from test_serve import _make_pred as jax_make_pred
    from test_torch_serve import _make_pred, _person_maps, _reference

    import improved_body_parts_torch.obs as tobs
    import improved_body_parts_torch.serve as tserve
    import improved_body_parts_tpu.obs as jobs
    import improved_body_parts_tpu.serve as jserve

    maps = _person_maps()
    pred = _make_pred(maps)
    shapes = [SIZE, (SIZE[0], ROI_W)]
    snap, people, first_runs = _roi_run(
        tobs, tserve, ts, pred, lambda server: server.warmup(shapes))
    jpred = jax_make_pred(maps)
    jsnap, jpeople, _ = _roi_run(
        jobs, jserve, js, jpred, lambda server: server.warmup(shapes))
    assert first_runs == 0.0
    assert snap["exact"] and snap["failed"] == 0
    for key in ("answered_tracker", "answered_roi", "escalated_full",
                "escalations", "submitted"):
        assert snap[key] == jsnap[key], key
    assert {k: v for k, v in snap["escalations"].items() if v} == {
        "cold": 1, "interval": 1, "people": 2}
    # the ROI frame (index 3) is the crop's own decode + the anchor
    xs = [c[0] for kps, _ in people[0] for c in kps if c is not None]
    x0 = min(max(int(np.floor(min(xs))) - 8, 0), SIZE[1] - ROI_W)
    want = ts.paste_back(_reference(
        pred, np.zeros((SIZE[0], ROI_W, 3), np.uint8)), (x0, 0))
    got = people[3]
    assert len(got) == len(want) == len(jpeople[3]) >= 1
    for (gk, gs), (wk, ws), (jk, jsc) in zip(
            sorted(got, key=lambda r: -r[1]),
            sorted(want, key=lambda r: -r[1]),
            sorted(jpeople[3], key=lambda r: -r[1])):
        # the fused lane against the host decode of the same crop, and
        # against the JAX package's fused lane
        assert gs == pytest.approx(ws, abs=1e-6)
        assert gs == pytest.approx(jsc, abs=1e-4)
        for pg, pw, pj in zip(gk, wk, jk):
            assert (pg is None) == (pw is None) == (pj is None)
            if pg is not None:
                assert pg == pytest.approx(pw, abs=1e-4)
                assert pg == pytest.approx(pj, abs=1e-3)


def test_stream_bench_cli_fastpath_on_cpu(tmp_path, monkeypatch, capsys):
    """``cli.stream_bench --fastpath --device cpu`` end to end in a tmp
    dir: the artifact in the working directory, conservation exact,
    0 first runs after warmup in both arms, equal quality per scene, and
    the JAX tool's artifact names refused."""
    from improved_body_parts_torch.cli import parse_reports
    from improved_body_parts_torch.cli import stream_bench as tbench

    monkeypatch.chdir(tmp_path)
    argv = ["--config", "tiny", "--streams", "2", "--frames", "8",
            "--size", "128", "--boxsize", "128", "--fastpath",
            "--fp-roi-width", "96", "--fp-people-delta", "8",
            "--rounds", "1", "--fp-quality-frames", "16",
            "--max-batch", "2", "--device", "cpu"]
    report = tbench.main(argv)
    (rep,) = parse_reports(capsys.readouterr().out)
    assert rep["quality_equal_all_scenes"] is True
    on_disk = json.loads((tmp_path / "stream_bench_torch.json").read_text())
    assert on_disk["verdict"] == report["verdict"]
    assert os.path.exists(tmp_path / "stream_bench_torch_events.jsonl")
    assert report["recompiles_post_warmup"] == 0
    assert report["fastpath_arm_recompile_delta_total"] == 0
    assert report["baseline_arm_recompile_delta_total"] == 0
    assert [list(s) for s in report["warmup"]["bucket_shapes"]]
    cons = report["fastpath_conservation"]
    assert cons["exact"] is True and cons["answered_tracker"] > 0
    assert report["quality_equal_all_scenes"] is True
    assert report["frames_failed_total"] == 0
    assert report["track_ids_stable_all_rounds"] is True
    with pytest.raises(SystemExit, match="JAX tool"):
        tbench.main(argv + ["--out", "STREAM_BENCH.json"])
    assert not os.path.exists(tmp_path / "STREAM_BENCH.json")


def test_stream_bench_cli_scaling_rounds_on_cpu(tmp_path, monkeypatch,
                                               capsys):
    """The bench's default mode: a round of the N-stream arm beside the
    serial 1-stream arm, its verdict block and ``CLI_REPORT``."""
    from improved_body_parts_torch.cli import parse_reports
    from improved_body_parts_torch.cli import stream_bench as tbench

    monkeypatch.chdir(tmp_path)
    report = tbench.main(["--config", "tiny", "--streams", "2", "--frames",
                          "4", "--size", "96", "--boxsize", "96",
                          "--rounds", "1", "--max-batch", "2",
                          "--out", "scaling.json", "--telemetry-sink",
                          "none", "--device", "cpu"])
    (rep,) = parse_reports(capsys.readouterr().out)
    assert rep["cli"] == "stream_bench" and rep["device"] == "cpu"
    rnd = report["rounds_detail"][0]
    assert rnd["multi"]["streams"] == 2 and rnd["single"]["streams"] == 1
    assert rnd["multi"]["frames_delivered"] == 8
    assert report["verdict"]["recompiles_post_warmup"] == 0
    assert report["all_streams_sustained"] is True
    assert report["median_scaling_ratio"] > 0
    assert json.loads((tmp_path / "scaling.json").read_text())[
        "verdict"] == report["verdict"]
    assert not os.path.exists(tmp_path / "scaling_events.jsonl")
