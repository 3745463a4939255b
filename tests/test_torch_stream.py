"""The port's streaming layer (``improved_body_parts_torch.stream``) held
to the JAX package's (``improved_body_parts_tpu.stream``), on the CPU.

Both packages' stream modules are NumPy, so equality is exact:

- ``SyntheticVideo``: frames (drawn and stamped), ground truth and seeded
  detections bit for bit, over the default, crossing, churn and scene
  protocols; ``read_stamp`` on full frames and crops;
- ``keypoint_similarity`` / ``greedy_match``, and ``Tracker`` +
  ``IdentitySwitchCounter`` over the same videos' noisy detections: the
  same tracked people frame by frame and the same switch counts;
- ``KeypointSmoother`` (one_euro, ema, with occlusion gaps) and the
  jitter functions;
- ``StreamSession`` over each package's ``DetectionEngine``: the same
  tracked people delivered, with and without smoothing and the fast
  path.

Over the port's ``DynamicBatcher`` with the stub predictor of
``tests/test_torch_serve.py`` (the event order is pinned, not the
wall clock: the port's dispatch holds its thread for the lane's host
work): ordered delivery, the drop_oldest and block policies, close
during a drain, migration off a wedged engine, and a pool replica
stopped mid-stream losing no frame.
"""
import sys
import threading
import time

import numpy as np
import pytest

import improved_body_parts_torch.stream as ts
import improved_body_parts_tpu.stream as js
from improved_body_parts_torch.stream import track as ttrack
from improved_body_parts_tpu.stream import track as jtrack

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

VIDEOS = [
    dict(seed=0, num_people=2, num_frames=12),
    dict(seed=1, num_people=3, size=(200, 260), num_frames=10),
    dict(seed=2, num_people=2, num_frames=10, crossing=True),
    dict(seed=3, num_people=3, num_frames=12, appear_at={2: 3},
         leave_at={0: 8}),
    dict(seed=4, num_people=2, num_frames=8, scene="static"),
    dict(seed=5, num_people=2, num_frames=8, scene="slow_pan"),
]


def _people(tracked):
    return [(p.track_id, p.keypoints, p.score, p.age) for p in tracked]


@pytest.mark.parametrize("kw", VIDEOS)
def test_synthetic_video_frames_gt_and_detections_bit_for_bit(kw):
    jv, tv = js.SyntheticVideo(**kw), ts.SyntheticVideo(**kw)
    for t in range(kw["num_frames"]):
        assert np.array_equal(tv.frame(t), jv.frame(t))
        assert tv.gt(t) == jv.gt(t)
        assert (tv.detections(t, noise=1.5, drop_joint_p=0.1)
                == jv.detections(t, noise=1.5, drop_joint_p=0.1))
        stamped = tv.stamped_frame(t)
        assert np.array_equal(stamped, jv.stamped_frame(t))
        crop = np.ascontiguousarray(stamped[:, 17:17 + 64])
        assert ts.read_stamp(crop) == js.read_stamp(crop) == (t, 17)
    assert ts.read_stamp(tv.stamped_frame(300)) == (300 & 0xFF, 0)


def test_read_stamp_rejects_unstamped_frames_as_jax():
    img = np.zeros((8, 8, 3), np.uint8)
    for mod in (ts, js):
        with pytest.raises(ValueError, match="stamped"):
            mod.read_stamp(img)
    for mod in (ts, js):
        with pytest.raises(ValueError, match="crossing"):
            mod.SyntheticVideo(num_people=3, crossing=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_similarity_and_greedy_match_equal(seed):
    rng = np.random.default_rng(seed)
    vid = js.SyntheticVideo(seed=seed, num_people=3, num_frames=4)
    refs = [jtrack._to_arrays(c) for _, c in vid.gt(0)]
    dets = [jtrack._to_arrays(k) for k, _ in vid.detections(
        1, noise=3.0, drop_joint_p=0.2)]
    for (gxy, gv) in refs:
        for (dxy, dv) in dets:
            area_j = jtrack._extent_area(gxy, gv)
            area_t = ttrack._extent_area(gxy, gv)
            assert area_t == area_j
            assert (ts.keypoint_similarity(gxy, gv, dxy, dv, area=area_t)
                    == js.keypoint_similarity(gxy, gv, dxy, dv,
                                              area=area_j))
    sim = rng.uniform(0, 1, (5, 4))
    sim[1, 2] = sim[3, 2] = sim.max()                     # a tie
    assert (ttrack.greedy_match(sim, 0.2)
            == jtrack.greedy_match(sim, 0.2))


@pytest.mark.parametrize("kw", VIDEOS[:4])
def test_tracker_and_identity_switches_equal(kw):
    jv = js.SyntheticVideo(**kw)
    trackers = (js.Tracker(max_age=3), ts.Tracker(max_age=3))
    counters = (js.IdentitySwitchCounter(), ts.IdentitySwitchCounter())
    for t in range(kw["num_frames"]):
        dets = jv.detections(t, noise=2.0, drop_joint_p=0.1)
        out = [tr.update(dets) for tr in trackers]
        assert _people(out[1]) == _people(out[0])
        for c, tracked in zip(counters, out):
            c.update(jv.gt(t), tracked)
        assert (trackers[1].predict_frame()
                == trackers[0].predict_frame())
        assert trackers[1].union_box() == trackers[0].union_box()
        assert trackers[1].confirmed == trackers[0].confirmed
    assert counters[1].switches == counters[0].switches
    assert trackers[1].snapshot() == trackers[0].snapshot()


@pytest.mark.parametrize("mode,kw", [
    ("one_euro", {}), ("ema", {"ema_alpha": 0.4}),
    ("one_euro", {"reset_after": 1, "min_cutoff": 0.5, "beta": 0.05})])
def test_smoother_and_jitter_equal(mode, kw):
    vid = js.SyntheticVideo(seed=7, num_people=2, num_frames=30)
    tracker = js.Tracker()
    sms = (js.KeypointSmoother(mode=mode, fps=30.0, **kw),
           ts.KeypointSmoother(mode=mode, fps=30.0, **kw))
    seqs = ([], [])
    raw = []
    for t in range(30):
        if t in (10, 11, 12):                     # an occlusion gap
            continue
        p = tracker.update(vid.detections(t, noise=2.0,
                                          drop_joint_p=0.15))[0]
        raw.append(p.keypoints)
        for sm, seq in zip(sms, seqs):
            seq.append(sm.apply(p.track_id, p.keypoints, t))
    assert seqs[1] == seqs[0]
    assert sms[1].tracked_joints == sms[0].tracked_joints
    assert (ts.keypoint_sequence_jitter(raw)
            == js.keypoint_sequence_jitter(raw))
    xy = np.asarray([kps[5] for kps in seqs[0] if kps[5] is not None],
                    np.float64)
    assert ts.jitter_rms(xy) == js.jitter_rms(xy)


@pytest.mark.parametrize("smoothing,fastpath", [
    (None, None), ("one_euro", None), ("ema", None),
    ("one_euro", dict(max_skip_run=2, min_stable=1, roi_width=160,
                      roi_margin=8, full_refresh_every=3))])
def test_session_over_detection_engine_equal(smoothing, fastpath):
    """The same stamped stream through each package's session over its
    ``DetectionEngine``: the same tracked people, frame by frame, the
    same engine calls and the same accounting."""
    out = []
    for mod in (js, ts):
        vid = mod.SyntheticVideo(seed=11, num_people=2, size=(240, 320),
                                 num_frames=16, scene="slow_pan")
        eng = mod.DetectionEngine(vid, noise=1.0, drop_joint_p=0.05)
        fp = (mod.FastPathConfig(**fastpath) if fastpath is not None
              else None)
        mgr = mod.SessionManager(eng, smoothing=smoothing,
                                 max_in_flight=1)
        session = mgr.open("cam", fastpath=fp)
        frames = [_people(session.submit_frame(vid.stamped_frame(t))
                          .result(timeout=60)) for t in range(16)]
        snap = session.snapshot()
        mgr.close_all(timeout_s=30)
        out.append((frames, eng.calls, snap["frames_delivered"],
                    snap["tracker"], snap.get("fastpath", {}).get("exact"),
                    {k: snap.get("fastpath", {}).get(k) for k in (
                        "answered_tracker", "answered_roi",
                        "escalated_full", "escalations")}))
    assert out[1] == out[0]


# --------------------------------------------------------------------- #
# sessions over the port's DynamicBatcher (stub predictor)              #
# --------------------------------------------------------------------- #
SIZE = (256, 256)


@pytest.fixture(scope="module")
def stub_preds():
    """Two stub predictors of ``tests/test_torch_serve.py`` (one planted
    person on every forward lane)."""
    from test_torch_serve import _make_pred, _person_maps

    maps = _person_maps()
    return _make_pred(maps), _make_pred(maps)


def _img():
    return np.zeros((*SIZE, 3), np.uint8)


class Gated:
    """The stub predictor with every dispatch held at ``gate``
    (``tests/test_torch_serve.py``'s ``GatedPredictor``), counting the
    dispatches inside it: a batcher stopped with a dispatch parked here
    leaves its dispatcher thread there until :meth:`release` opens the
    gate and waits until that dispatch has left the predictor, so no
    thread is inside a torch call when the test ends."""

    def __init__(self, inner):
        from test_torch_serve import GatedPredictor

        self.gate = threading.Event()
        self._inner = GatedPredictor(inner, self.gate)
        self._cond = threading.Condition()
        self.inside = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _held(self, fn, *a, **kw):
        with self._cond:
            self.inside += 1
        try:
            return fn(*a, **kw)
        finally:
            with self._cond:
                self.inside -= 1
                self._cond.notify_all()

    def predict_decoded_async(self, *a, **kw):
        return self._held(self._inner.predict_decoded_async, *a, **kw)

    def predict_decoded_batch_async(self, *a, **kw):
        return self._held(self._inner.predict_decoded_batch_async, *a,
                          **kw)

    def release(self, timeout_s=60.0):
        self.gate.set()
        with self._cond:
            assert self._cond.wait_for(lambda: self.inside == 0,
                                       timeout=timeout_s)


def test_session_in_order_tracked_delivery(stub_preds):
    """Frames deliver strictly in submit order with the same track id
    for the planted person, and the stream signals ride the registry
    labelled by stream."""
    from improved_body_parts_torch.obs import Registry
    from improved_body_parts_torch.serve import DynamicBatcher

    reg = Registry()
    order = []
    with DynamicBatcher(stub_preds[0], max_batch=2, max_wait_ms=20,
                        use_native=False, registry=reg) as server:
        with ts.SessionManager(server, registry=reg,
                               max_in_flight=3) as mgr:
            session = mgr.open("cam0")
            futs = [session.submit_frame(_img()) for _ in range(6)]
            for i, f in enumerate(futs):
                f.add_done_callback(lambda _, i=i: order.append(i))
            results = [f.result(timeout=120) for f in futs]
            snap = session.snapshot()
            exposition = reg.prometheus()
    assert order == list(range(6))
    ids0 = sorted(p.track_id for p in results[0])
    assert len(ids0) >= 1
    for i, r in enumerate(results):
        assert sorted(p.track_id for p in r) == ids0
        assert all(p.age == i for p in r)
    assert snap["frames_delivered"] == 6 and snap["frames_dropped"] == 0
    assert snap["tracker"]["births"] == len(ids0)
    assert ('stream_frames_delivered_total{stream="cam0"} 6.0'
            in exposition)


def test_drop_oldest_backpressure_semantics(stub_preds):
    """With the pipeline full, drop_oldest fails the stalest undelivered
    frames with FrameDropped and the newest deliver."""
    from improved_body_parts_torch.serve import DynamicBatcher

    gated = Gated(stub_preds[0])
    gate = gated.gate
    with DynamicBatcher(gated, max_batch=1,
                        max_wait_ms=5, use_native=False) as server:
        with ts.SessionManager(server, max_in_flight=2,
                               policy="drop_oldest") as mgr:
            session = mgr.open("live")
            futs = [session.submit_frame(_img()) for _ in range(4)]
            gate.set()
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(("ok", len(f.result(timeout=120))))
                except ts.FrameDropped:
                    outcomes.append(("dropped", None))
            snap = session.snapshot()
    assert [o for o, _ in outcomes] == ["dropped", "dropped", "ok", "ok"]
    assert snap["frames_dropped"] == 2 and snap["frames_delivered"] == 2
    assert snap["frames_submitted"] == 4
    assert snap["tracker"]["frames"] == 2


def test_block_backpressure_holds_the_producer(stub_preds):
    """policy='block' parks the producer at max_in_flight until the
    engine delivers; nothing is dropped.  The order is pinned with
    events: the third submit returns only after the gate opens."""
    from test_torch_serve import GatedPredictor

    from improved_body_parts_torch.serve import DynamicBatcher

    gate = threading.Event()
    events = []
    with DynamicBatcher(GatedPredictor(stub_preds[0], gate), max_batch=1,
                        max_wait_ms=5, use_native=False) as server:
        with ts.SessionManager(server, max_in_flight=2,
                               policy="block") as mgr:
            session = mgr.open("vod")
            f1 = session.submit_frame(_img())
            f2 = session.submit_frame(_img())
            state = {}

            def third():
                state["future"] = session.submit_frame(_img())
                events.append("third admitted")

            th = threading.Thread(target=third, daemon=True)
            th.start()
            th.join(timeout=0.3)
            assert th.is_alive()                     # still parked
            events.append("gate opened")
            gate.set()
            th.join(timeout=120)
            assert not th.is_alive()
            for f in (f1, f2, state["future"]):
                assert len(f.result(timeout=120)) >= 1
            assert session.snapshot()["frames_dropped"] == 0
    assert events == ["gate opened", "third admitted"]


def test_session_close_during_batcher_drain(stub_preds):
    """A session closed while its batcher drains toward shutdown strands
    nothing: every submitted future completes and close() returns
    drained."""
    from improved_body_parts_torch.serve import DynamicBatcher

    gated = Gated(stub_preds[0])                 # wedged
    server = DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                            use_native=False).start()
    session = ts.SessionManager(server, max_in_flight=4).open("dying")
    futs = [session.submit_frame(_img()) for _ in range(3)]
    stopper = threading.Thread(
        target=lambda: server.stop(drain_timeout_s=1.0), daemon=True)
    stopper.start()
    assert session.close(timeout_s=120)
    stopper.join(timeout=120)
    assert not stopper.is_alive()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=0)
    snap = session.snapshot()
    assert snap["frames_failed"] == 3 and snap["in_flight"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        session.submit_frame(_img())
    gated.release()


def test_session_migrate_preserves_frame_order(stub_preds):
    """Frames in flight on a wedged engine re-submit to a healthy one on
    migrate(); every future resolves, in frame order, and the wedged
    engine's late drain errors are discarded as stale."""
    from improved_body_parts_torch.serve import DynamicBatcher

    gated = Gated(stub_preds[1])
    a = DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                       use_native=False).start()
    with DynamicBatcher(stub_preds[0], max_batch=2, max_wait_ms=20,
                        use_native=False) as b:
        session = ts.SessionManager(a, max_in_flight=4).open("cam0")
        futs = [session.submit_frame(_img()) for _ in range(3)]
        assert not any(f.done() for f in futs)
        assert session.migrate(b) == 3
        results = [f.result(timeout=120) for f in futs]
        a.stop(drain_timeout_s=0.5)
        ids0 = sorted(p.track_id for p in results[0])
        for i, r in enumerate(results):
            assert sorted(p.track_id for p in r) == ids0
            assert len(r) >= 1 and all(p.age == i for p in r)
        snap = session.snapshot()
        assert snap["frames_delivered"] == 3
        assert snap["frames_failed"] == 0 and snap["frames_dropped"] == 0
        assert session.close(timeout_s=60)
    gated.release()


def test_pool_replica_stopped_mid_stream_loses_no_frame(stub_preds):
    """A stream through an ``EnginePool`` whose replica 0 is wedged and
    then stopped mid-stream: the pool re-submits the stranded frames to
    replica 1, every frame delivers in order, none fails, and the pool's
    ledger balances."""
    from improved_body_parts_torch.serve import DynamicBatcher, EnginePool

    gated = Gated(stub_preds[1])
    engines = [DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                              use_native=False),
               DynamicBatcher(stub_preds[0], max_batch=2, max_wait_ms=20,
                              use_native=False)]
    with EnginePool(engines, probe_interval_s=0.05, wedge_timeout_s=30.0,
                    drain_timeout_s=0.5) as pool:
        session = ts.SessionManager(pool, max_in_flight=6).open("cam0")
        futs = [session.submit_frame(_img()) for _ in range(6)]
        deadline = time.time() + 60
        while engines[0].metrics.depth == 0 and time.time() < deadline:
            time.sleep(0.002)              # some frames wait on replica 0
        engines[0].stop(drain_timeout_s=0.1)
        results = [f.result(timeout=120) for f in futs]
        gated.release()
        ids0 = sorted(p.track_id for p in results[0])
        for i, r in enumerate(results):
            assert sorted(p.track_id for p in r) == ids0
            assert len(r) >= 1 and all(p.age == i for p in r)
        snap = session.snapshot()
        assert snap["frames_delivered"] == 6 and snap["frames_failed"] == 0
        assert pool.counters()["resubmitted"] >= 1
        m = pool.metrics
        assert m.submitted == m.completed + m.failed + m.depth
        assert session.close(timeout_s=60)


# ------------------------------------------- cli.stream_bench --devices
def test_stream_bench_serves_across_two_cpu_replicas(tmp_path, monkeypatch):
    """``--devices 2 --device cpu``: the batcher serves across two
    ``Predictor.device_replica`` copies (the JAX tool's virtual host
    devices), both of them serving, and the artifact says so."""
    from improved_body_parts_torch.cli import stream_bench as tbench

    monkeypatch.chdir(tmp_path)
    report = tbench.main(["--config", "tiny", "--streams", "2", "--frames",
                          "8", "--size", "96", "--boxsize", "96",
                          "--rounds", "1", "--max-batch", "2",
                          "--devices", "2", "--telemetry-sink", "none",
                          "--device", "cpu"])
    assert report["serve_devices"] == 2
    done = report["serve_replica_completed"]
    assert sorted(done) == ["0", "1"] and min(done.values()) > 0, done
    assert report["frames_delivered_total"] == 16
    assert report["frames_failed_total"] == 0


@pytest.mark.parametrize("count,device,visible,want", [
    (0, "cpu", 0, ["cpu"]),
    (3, "cpu", 0, ["cpu"] * 3),
    (0, "cuda", 2, ["cuda:0", "cuda:1"]),
    (1, "cuda", 2, ["cuda:0"]),
])
def test_stream_bench_devices_resolve(monkeypatch, count, device, visible,
                                      want):
    import torch

    from improved_body_parts_torch.cli.stream_bench import serve_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    got = serve_devices(count, torch.device(device))
    assert [str(d) for d in got] == want


def test_stream_bench_refuses_more_cards_than_visible(monkeypatch):
    import torch

    from improved_body_parts_torch.cli.stream_bench import serve_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--devices 99: only 1 CUDA"):
        serve_devices(99, torch.device("cuda"))
