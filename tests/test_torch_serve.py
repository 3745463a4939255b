"""Serving engine of the port (``improved_body_parts_torch.serve``), on the
CPU, where the kernels' plain versions run.

Mirrors ``tests/test_serve.py`` on the port: a torch stub network that
returns the planted maps of that file (``_person_maps``: one person on a
256 px canvas, the same maps on every forward lane) isolates the
batcher's own machinery — shape-bucket coalescing, deadline flush,
admission and load-shedding, warmup, result routing, the overflow
fallbacks, the hop waterfall, draining — from network weights.  Beside
it: two CPU replicas; the same images through the JAX package's
``DynamicBatcher`` and the port's give the same people; and on the tiny
IMHN with converted weights, ``predict_compact_batch`` records equal the
JAX package's and ``predict_fast`` peak masks are equal.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from improved_body_parts_torch import config as tconfig
from improved_body_parts_torch.infer import (
    Predictor,
    decode,
    decode_compact,
)
from improved_body_parts_torch.serve import (
    HOPS,
    DeadlineExceeded,
    DynamicBatcher,
    ServerOverloaded,
    pow2_batch_sizes,
)
from improved_body_parts_torch.utils import PercentileMeter

sys.path.insert(0, "tests")
from test_serve import SIZE_A, SIZE_B, _assert_same_people  # noqa: E402
from test_serve import _make_pred as _jax_make_pred  # noqa: E402
from test_serve import _person_maps  # noqa: E402

SK = tconfig.get_config("canonical").skeleton
INT_FIELDS = {"xs", "ys", "valid", "count", "slot_a", "slot_b"}


class StubModel(torch.nn.Module):
    """Ignores the input image; returns fixed stride-4 maps for whatever
    spatial size it is given (every forward lane sees the same maps), as
    ``tests/test_serve.py``'s ``StubModel`` does for the JAX package."""

    def __init__(self, maps):
        super().__init__()
        self.register_buffer("maps", torch.from_numpy(maps))

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        m = self.maps[:h // SK.stride, :w // SK.stride]
        return [[m.expand(n, *m.shape)]]


def _make_pred(maps, **kw):
    params, _ = tconfig.default_inference_params()
    model_params = tconfig.InferenceModelParams(boxsize=256,
                                                max_downsample=64)
    return Predictor(StubModel(maps), SK, params, model_params, bucket=64,
                     device="cpu", **kw)


@pytest.fixture(scope="module")
def person_maps():
    return _person_maps()


@pytest.fixture(scope="module")
def warm_pred(person_maps):
    """One predictor shared by the routing/flush tests."""
    return _make_pred(person_maps)


def _img(size):
    return np.zeros((*size, 3), np.uint8)


def _reference(pred, img):
    return decode_compact(pred.predict_compact(img), pred.params, SK,
                          use_native=False)


class GatedPredictor:
    """Delegates to a real predictor but holds every device dispatch at a
    gate — deterministic control of 'device busy' for shed tests."""

    def __init__(self, inner, gate):
        self._inner, self._gate = inner, gate

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict_compact_async(self, *a, **kw):
        self._gate.wait()
        return self._inner.predict_compact_async(*a, **kw)

    def predict_compact_batch_async(self, *a, **kw):
        self._gate.wait()
        return self._inner.predict_compact_batch_async(*a, **kw)

    def predict_decoded_async(self, *a, **kw):
        self._gate.wait()
        return self._inner.predict_decoded_async(*a, **kw)

    def predict_decoded_batch_async(self, *a, **kw):
        self._gate.wait()
        return self._inner.predict_decoded_batch_async(*a, **kw)


class HeldResolve:
    """Delegates to a replica, but every ``resolve()`` waits at a gate:
    the batch stays in flight on its replica until the gate opens."""

    def __init__(self, inner, gate):
        self._inner, self._gate = inner, gate

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict_decoded_async(self, *a, **kw):
        resolve = self._inner.predict_decoded_async(*a, **kw)

        def held():
            self._gate.wait()
            return resolve()

        return held


# --------------------------------------------------------------------- #
def test_pow2_batch_sizes():
    assert pow2_batch_sizes(1) == (1,)
    assert pow2_batch_sizes(6) == (1, 2, 4)
    assert pow2_batch_sizes(8) == (1, 2, 4, 8)
    with pytest.raises(ValueError):
        pow2_batch_sizes(0)


def test_percentile_meter_matches_jax():
    from improved_body_parts_tpu.utils import PercentileMeter as JMeter

    m = PercentileMeter(capacity=1000)
    for v in range(1, 101):
        m.update(float(v))
    assert m.count == 100
    assert m.avg == pytest.approx(50.5)
    assert m.percentile(50) == pytest.approx(50.5)
    assert m.percentile(99) == pytest.approx(99.01)
    assert m.summary(scale=10.0)["p95"] == pytest.approx(950.5)

    # the reservoir: same seeded sampling as the JAX package's
    stream = np.random.default_rng(0).exponential(1.0, 5000)
    a, b = PercentileMeter(capacity=64), JMeter(capacity=64)
    for v in stream:
        a.update(float(v))
        b.update(float(v))
    assert len(a._samples) == 64 and a.count == 5000
    assert a.summary() == b.summary()


def test_batcher_rejects_grid_params(warm_pred):
    with pytest.raises(ValueError, match="single-scale"):
        DynamicBatcher(warm_pred,
                       tconfig.InferenceParams(scale_search=(0.5, 1.0)))


def test_concurrent_submitters_get_their_own_results(warm_pred):
    """4 threads × mixed sizes: every future must resolve to ITS image's
    skeletons (sizes decode at different coordinate scales, so routing
    mixups are visible), across two shape buckets."""
    imgs = {s: _img(s) for s in (SIZE_A, SIZE_B)}
    refs = {s: _reference(warm_pred, im) for s, im in imgs.items()}
    nose_a = max(refs[SIZE_A], key=lambda r: r[1])[0][0]
    nose_b = max(refs[SIZE_B], key=lambda r: r[1])[0][0]
    assert abs(nose_a[0] - nose_b[0]) > 5

    with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=30,
                        max_queue=64, use_native=False) as server:
        server.warmup([SIZE_A, SIZE_B], batch_sizes=(1, 2))
        results = {}

        def client(tid):
            out = []
            for i in range(3):
                size = (SIZE_A, SIZE_B)[(tid + i) % 2]
                out.append((size, server.submit(imgs[size])))
            results[tid] = [(s, f.result(timeout=60)) for s, f in out]

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        snap = server.metrics.snapshot()

    assert len(results) == 4
    for tid, pairs in results.items():
        for size, got in pairs:
            _assert_same_people(got, refs[size])
    assert snap["submitted"] == snap["completed"] == 12
    assert snap["failed"] == snap["rejected"] == 0


def test_deadline_flush_single_straggler(warm_pred):
    """One lone request must not wait for a full batch: with occupancy 1
    and max_batch 8 the deadline flush serves it."""
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    with DynamicBatcher(warm_pred, max_batch=8, max_wait_ms=50,
                        use_native=False,
                        eager_idle_flush=False) as server:
        server.warmup([SIZE_A], batch_sizes=(1,))
        t0 = time.perf_counter()
        got = server.submit(img).result(timeout=60)
        waited = time.perf_counter() - t0
        snap = server.metrics.snapshot()
    _assert_same_people(got, ref)
    assert waited < 10.0
    assert snap["occupancy_histogram"] == {"1": 1}


def test_request_deadline_fails_fast(warm_pred):
    """A non-positive deadline is refused at the door; one that expires
    while its bucket waits fails with DeadlineExceeded at dispatch."""
    img = _img(SIZE_A)
    with DynamicBatcher(warm_pred, max_batch=4, max_wait_ms=200,
                        use_native=False,
                        eager_idle_flush=False) as server:
        with pytest.raises(DeadlineExceeded):
            server.submit(img, deadline_s=0)
        fut = server.submit(img, deadline_s=0.02)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)
        snap = server.metrics.snapshot()
    assert snap["expired"] == 2 and snap["failed"] == 1
    assert snap["submitted"] == 1 and snap["queue_depth"] == 0


def test_occupancy_accounting_two_buckets(warm_pred):
    """4 size-A + 3 size-B requests, max_batch=4, deterministic flushes:
    bucket A flushes full (occupancy 4), bucket B on the deadline
    (occupancy 3) — the histogram and mean must say exactly that."""
    imgs = {s: _img(s) for s in (SIZE_A, SIZE_B)}
    with DynamicBatcher(warm_pred, max_batch=4, max_wait_ms=300,
                        use_native=False,
                        eager_idle_flush=False) as server:
        futs = [server.submit(imgs[SIZE_A]) for _ in range(4)]
        futs += [server.submit(imgs[SIZE_B]) for _ in range(3)]
        for f in futs:
            f.result(timeout=120)
        snap = server.metrics.snapshot()
    assert snap["occupancy_histogram"] == {"3": 1, "4": 1}
    assert snap["mean_batch_occupancy"] == pytest.approx(3.5)
    assert snap["completed"] == 7


def test_load_shed_fails_fast_and_keeps_serving(warm_pred):
    """With the admission queue full, submit() must raise
    ServerOverloaded immediately while everything already admitted still
    completes."""
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    gate = threading.Event()
    gated = GatedPredictor(warm_pred, gate)
    server = DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                            max_queue=2, use_native=False)
    with server:
        f1 = server.submit(img)
        f2 = server.submit(img)
        time.sleep(0.05)  # let the dispatcher park on the gate
        t0 = time.perf_counter()
        with pytest.raises(ServerOverloaded):
            server.submit(img)
        assert time.perf_counter() - t0 < 0.5
        assert server.metrics.rejected == 1
        gate.set()
        _assert_same_people(f1.result(timeout=60), ref)
        _assert_same_people(f2.result(timeout=60), ref)
        _assert_same_people(server.submit(img).result(timeout=60), ref)
    snap = server.metrics.snapshot()
    assert snap["completed"] == 3 and snap["rejected"] == 1
    assert snap["queue_depth"] == 0


def test_compact_overflow_falls_back_to_full_maps(person_maps):
    """A request whose peak count overflows the top-K capacity must still
    yield correct skeletons: the fused result's flag demotes it to the
    host decode of its compact records, which overflow too, so it is
    re-run through ``predict_fast`` and decoded from the full maps."""
    pred = _make_pred(person_maps, compact_topk=1)
    img = _img(SIZE_A)
    res = pred.predict_compact(img)
    assert bool((res.peaks.count > res.peaks.valid.shape[1]).any())

    heat, paf, mask, scale = pred.predict_fast(img)
    want = decode(heat, paf, pred.params, SK, peak_mask=mask,
                  coord_scale=scale, use_native=False)

    with DynamicBatcher(pred, max_batch=2, max_wait_ms=20,
                        use_native=False) as server:
        server.warmup([SIZE_A], batch_sizes=(1, 2))
        got = server.submit(img).result(timeout=120)
        snap = server.metrics.snapshot()
    _assert_same_people(got, want)
    assert snap["decode_host_fallback"] == 1
    assert snap["decode_fused"] == 0


@pytest.mark.parametrize("use_native", [False, True])
def test_person_overflow_falls_back_to_host_compact_decode(person_maps,
                                                           use_native):
    """A person table too small for the image (p_max 1) sets the
    person-overflow flag: the request is decoded on the host from the
    compact records the fused buffer shipped (no second forward)."""
    pred = _make_pred(person_maps, assembly_pmax=1)
    img = _img(SIZE_A)
    dev = pred.predict_decoded(img)
    assert dev.person_overflow and not dev.peak_overflow
    want = decode_compact(pred.predict_compact(img), pred.params, SK,
                          use_native=use_native)
    calls = []
    fast = pred.predict_fast_async
    pred.predict_fast_async = lambda *a, **kw: calls.append(1) or fast(
        *a, **kw)
    with DynamicBatcher(pred, max_batch=2, max_wait_ms=20,
                        use_native=use_native) as server:
        got = server.submit(img).result(timeout=120)
        snap = server.metrics.snapshot()
    _assert_same_people(got, want)
    assert snap["decode_host_fallback"] == 1 and not calls


def test_device_decode_is_the_default_lane(warm_pred):
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=20,
                        use_native=False) as server:
        assert server.device_decode
        server.warmup([SIZE_A], batch_sizes=(1, 2))
        futs = [server.submit(img) for _ in range(4)]
        for f in futs:
            _assert_same_people(f.result(timeout=120), ref)
        snap = server.metrics.snapshot()
    assert snap["decode_fused"] == 4
    assert snap["decode_host_fallback"] == 0
    assert snap["completed"] == 4


def test_hop_waterfall_conserves_e2e_on_warm_batcher(warm_pred):
    """The five hops partition each request's submit → finish window:
    per request they sum to its e2e latency within 1 µs, and the
    aggregate reservoirs conserve too, on the batch and singleton
    paths."""
    from improved_body_parts_torch.obs import reqtrace

    img = _img(SIZE_A)
    rec = reqtrace.ReqTrace(sample=1, emit_to_sink=False)
    with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=20,
                        use_native=False) as server:
        server.warmup([SIZE_A], batch_sizes=(1, 2))
        prev = reqtrace.set_reqtrace(rec)
        try:
            futs = [server.submit(img) for _ in range(6)]
            for f in futs:
                f.result(timeout=120)
        finally:
            reqtrace.set_reqtrace(prev)
        metrics = server.metrics
        snap = metrics.snapshot()
    records = rec.records()
    assert snap["completed"] == 6 and len(records) == 6
    for r in records:
        hops = r["nodes"][0]["hops_ms"]
        assert tuple(hops) == HOPS
        assert min(hops.values()) >= 0
    hop_sum = sum(m.sum for m in metrics.hops.values())
    assert abs(hop_sum - metrics.latency.sum) < 1e-6
    for hop in HOPS:
        assert snap["hops_ms"][hop]["count"] == 6
    assert snap["hop_conservation_frac"] >= 0.95
    hop_total = sum(snap["hops_ms"][h]["sum"] for h in HOPS)
    e2e_total = snap["latency_ms"]["mean"] * snap["latency_ms"]["count"]
    assert hop_total == pytest.approx(e2e_total, rel=0.05)


def test_reqtrace_records_each_request(warm_pred):
    """With a request recorder installed, every request's node carries
    the five hops, and emit_signals hands back the escalation signals."""
    from improved_body_parts_torch.obs import reqtrace

    rec = reqtrace.ReqTrace(sample=1, emit_to_sink=False)
    prev = reqtrace.set_reqtrace(rec)
    img = _img(SIZE_A)
    try:
        with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=20,
                            use_native=False, emit_signals=True) as server:
            outs = [server.submit(img).result(timeout=120) for _ in range(3)]
    finally:
        reqtrace.set_reqtrace(prev)
    records = rec.records()
    assert len(records) == 3
    for r in records:
        assert r["status"] == "ok"
        assert list(r["nodes"][0]["hops_ms"]) == list(HOPS)
    for people, signals in outs:
        assert signals.fused and signals.n_people >= len(people) >= 1


def test_host_pool_lane_still_serves(warm_pred):
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=20,
                        use_native=False,
                        device_decode=False) as server:
        server.warmup([SIZE_A], batch_sizes=(1, 2))
        _assert_same_people(server.submit(img).result(timeout=120), ref)
        snap = server.metrics.snapshot()
    assert snap["decode_fused"] == 0
    assert snap["decode_host_fallback"] == 1
    with pytest.raises(ValueError, match="emit_signals"):
        DynamicBatcher(warm_pred, device_decode=False, emit_signals=True)


def test_warmup_warms_every_bucket_program(person_maps):
    """After warmup, serving traffic over every configured bucket (full
    batches, pow2 splits, singleton stragglers) runs only warmed
    programs; a second warmup reports nothing new."""
    pred = _make_pred(person_maps)
    imgs = {s: _img(s) for s in (SIZE_A, SIZE_B)}
    with DynamicBatcher(pred, max_batch=2, max_wait_ms=30,
                        use_native=False) as server:
        info = server.warmup([SIZE_A, SIZE_B])
        assert info["bucket_shapes"] == [(256, 256), (256, 384)]
        assert info["batch_sizes"] == (1, 2)
        assert info["newly_compiled"] == 4
        keys = set(pred._warmed)
        assert server.warmup([SIZE_A, SIZE_B])["newly_compiled"] == 0
        futs = [server.submit(imgs[(SIZE_A, SIZE_B)[i % 2]])
                for i in range(7)]
        for f in futs:
            f.result(timeout=120)
    assert set(pred._warmed) == keys


def test_registry_collects_batcher_metrics(warm_pred):
    """register_into takes any object with register_collector: the
    collected samples carry the batcher's counters after load."""
    class Registry:
        def __init__(self):
            self.collectors = []

        def register_collector(self, fn):
            self.collectors.append(fn)

        def samples(self):
            return {(name, tuple(sorted(labels.items()))): value
                    for fn in self.collectors
                    for name, labels, _kind, value in fn()}

    reg = Registry()
    img = _img(SIZE_A)
    with DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=30,
                        use_native=False, registry=reg) as server:
        threads = [threading.Thread(target=lambda: [
            server.submit(img).result(timeout=60) for _ in range(2)])
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    s = reg.samples()
    assert s[("serve_submitted_total", ())] == 6.0
    assert s[("serve_completed_total", ())] == 6.0
    assert (("serve_latency_seconds", (("quantile", "0.99"),)) in s)
    assert s[("serve_hop_conservation_frac", ())] == pytest.approx(1.0)


def test_two_cpu_replicas_share_the_traffic(warm_pred):
    """devices=["cpu", "cpu"]: each replica owns a copy of the model;
    while replica 0 holds a batch in flight the next one goes to
    replica 1, and both return correct people."""
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    gate = threading.Event()
    server = DynamicBatcher(warm_pred, max_batch=1, max_wait_ms=5,
                            use_native=False, devices=["cpu", "cpu"])
    reps = server._replicas
    assert len(reps) == 2 and reps[0].model is not reps[1].model
    assert all(r.device == torch.device("cpu") for r in reps)
    assert reps[0].model.maps is not warm_pred.model.maps
    assert server.warmup([SIZE_A], batch_sizes=(1,))["newly_compiled"] == 2
    server._replicas = [HeldResolve(r, gate) for r in reps]
    with server:
        f1 = server.submit(img)
        deadline = time.time() + 30
        while server.health()["batches_in_flight"] < 1:
            assert time.time() < deadline
            time.sleep(0.005)
        f2 = server.submit(img)
        while server.health()["batches_in_flight"] < 2:
            assert time.time() < deadline
            time.sleep(0.005)
        gate.set()
        for f in (f1, f2):
            _assert_same_people(f.result(timeout=60), ref)
        replicas = sorted(server.metrics._hops_by_replica)
    assert replicas == [0, 1]


def test_graceful_drain_flushes_queued_and_rejects_new(warm_pred):
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    gate = threading.Event()
    gated = GatedPredictor(warm_pred, gate)
    server = DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                            max_queue=8, use_native=False).start()
    f1 = server.submit(img)
    f2 = server.submit(img)
    time.sleep(0.05)
    stopper = threading.Thread(target=lambda: server.stop(
        drain_timeout_s=120.0))
    stopper.start()
    deadline = time.time() + 10
    while not server.draining and time.time() < deadline:
        time.sleep(0.005)
    assert server.draining
    with pytest.raises(ServerOverloaded, match="draining"):
        server.submit(img)
    gate.set()
    stopper.join(timeout=120)
    assert not stopper.is_alive()
    _assert_same_people(f1.result(timeout=0), ref)
    _assert_same_people(f2.result(timeout=0), ref)
    health = server.health()
    assert not health["running"] and not health["draining"]


def test_drain_deadline_fails_stranded_futures(warm_pred):
    img = _img(SIZE_A)
    gate = threading.Event()
    gated = GatedPredictor(warm_pred, gate)
    server = DynamicBatcher(gated, max_batch=1, max_wait_ms=5,
                            max_queue=8, use_native=False).start()
    f1 = server.submit(img)
    time.sleep(0.05)
    t0 = time.perf_counter()
    server.stop(drain_timeout_s=1.5)
    assert time.perf_counter() - t0 < 30.0
    with pytest.raises(RuntimeError, match="drain deadline"):
        f1.result(timeout=0)
    gate.set()


class CountingGate(GatedPredictor):
    """A ``GatedPredictor`` that counts the dispatches that reach it."""

    def __init__(self, inner, gate):
        super().__init__(inner, gate)
        self.calls = 0

    def predict_decoded_async(self, *a, **kw):
        self.calls += 1
        return super().predict_decoded_async(*a, **kw)

    def predict_decoded_batch_async(self, *a, **kw):
        self.calls += 1
        return super().predict_decoded_batch_async(*a, **kw)


def test_abrupt_stop_lets_the_dispatcher_leave(warm_pred):
    """``stop(drain_timeout_s=0)`` while a dispatch is parked on the
    device and another bucket still waits: every future fails at once,
    and when the device returns the dispatcher reads the sentinel the
    stop handed back and leaves, flushing the waiting bucket without a
    second dispatch (its request already failed)."""
    gate = threading.Event()
    gated = CountingGate(warm_pred, gate)
    server = DynamicBatcher(gated, max_batch=2, max_wait_ms=60_000,
                            use_native=False,
                            eager_idle_flush=False).start()
    futs = [server.submit(_img(SIZE_B))]               # waits in bucket B
    futs += [server.submit(_img(SIZE_A)) for _ in range(2)]  # A fills
    deadline = time.perf_counter() + 30
    while gated.calls < 1 and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert gated.calls == 1                            # A parked
    dispatcher = server._dispatcher
    server.stop(drain_timeout_s=0.0)
    for f in futs:
        with pytest.raises(RuntimeError, match="drain deadline"):
            f.result(timeout=0)
    assert dispatcher.is_alive()
    gate.set()
    dispatcher.join(timeout=30)
    assert not dispatcher.is_alive()
    assert gated.calls == 1


def test_stop_without_deadline_still_drains_everything(warm_pred):
    img = _img(SIZE_A)
    ref = _reference(warm_pred, img)
    server = DynamicBatcher(warm_pred, max_batch=2, max_wait_ms=20,
                            use_native=False).start()
    server.warmup([SIZE_A], batch_sizes=(1, 2))
    futs = [server.submit(img) for _ in range(4)]
    server.stop()
    for f in futs:
        _assert_same_people(f.result(timeout=0), ref)
    snap = server.metrics.snapshot()
    assert snap["completed"] == 4 and snap["failed"] == 0


# --------------------------------------------------------------------- #
# across the two packages                                               #
# --------------------------------------------------------------------- #
def test_jax_and_port_batchers_give_the_same_people(person_maps):
    """The same requests (two sizes, two buckets) through the JAX
    package's DynamicBatcher and the port's: the same people, at
    ``_assert_same_people``'s 0.05 px."""
    from improved_body_parts_tpu.serve import DynamicBatcher as JBatcher

    images = [_img(s) for s in (SIZE_A, SIZE_B, SIZE_A, SIZE_B)]
    outs = []
    for batcher, pred in ((JBatcher, _jax_make_pred(person_maps)),
                          (DynamicBatcher, _make_pred(person_maps))):
        with batcher(pred, max_batch=4, max_wait_ms=50, use_native=False,
                     eager_idle_flush=False) as server:
            futs = [server.submit(im) for im in images]
            outs.append([f.result(timeout=300) for f in futs])
            assert server.metrics.snapshot()["decode_fused"] == 4
    for want, got in zip(*outs):
        assert len(got) >= 1
        _assert_same_people(got, want)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX predictor, port predictor) on the same seeded tiny IMHN
    weights (``tests/test_torch_models.py``'s ``_seeded_flax``)."""
    from improved_body_parts_tpu.config import InferenceModelParams
    from improved_body_parts_tpu.infer import Predictor as JPredictor
    from test_torch_models import _seeded_flax

    from improved_body_parts_torch.models import (
        build_model,
        load_flax_variables,
    )

    cfg = tconfig.get_config("tiny")
    jmodel, variables = _seeded_flax(cfg, 128, 128, seed=3)
    jpred = JPredictor(jmodel, variables, SK, model_params=(
        InferenceModelParams(boxsize=128, max_downsample=64)), bucket=64,
        compact_topk=16, assembly_pmax=16)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    tpred = Predictor(model, SK, model_params=tconfig.InferenceModelParams(
        boxsize=128, max_downsample=64), bucket=64, compact_topk=16,
        assembly_pmax=16, device="cpu")
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
              for h, w in ((128, 128), (96, 128), (100, 70))]
    return jpred, tpred, images


def test_compact_batch_records_match_jax(tiny_pair):
    """Two shape groups, chunks 2 + 1: every image's compact records
    equal the JAX package's, integer fields exactly, floats within 1e-5
    (relative for the pixel-valued coordinates and lengths, which reach
    128: the two ×4 upsamples agree within 3e-7, not bit for bit)."""
    jpred, tpred, images = tiny_pair
    want = jpred.predict_compact_batch(images)
    got = tpred.predict_compact_batch(images)
    assert len(got) == len(want) == len(images)
    n_peaks = n_cands = 0
    for w, g in zip(want, got):
        assert (g.image_size, g.coord_scale) == (w.image_size,
                                                 w.coord_scale)
        for wrec, grec in ((w.peaks, g.peaks), (w.stats, g.stats)):
            for name, a, b in zip(wrec._fields, wrec, grec):
                a = np.asarray(a)
                if name in INT_FIELDS:
                    np.testing.assert_array_equal(b, a, err_msg=name)
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                               err_msg=name)
        n_peaks += int(np.asarray(w.peaks.valid).sum())
        n_cands += int(np.asarray(w.stats.valid).sum())
    assert n_peaks > 100 and n_cands > 100


def test_predict_fast_peak_masks_match_jax(tiny_pair):
    jpred, tpred, images = tiny_pair
    for img in images[1:2]:
        wh, wp, wmask, wscale = jpred.predict_fast(img)
        th, tp, tmask, tscale = tpred.predict_fast(img)
        assert tmask.shape == wmask.shape and tmask.dtype == bool
        np.testing.assert_array_equal(tmask, wmask)
        assert tmask.any() and tscale == wscale
        np.testing.assert_allclose(th, wh, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tp, wp, atol=1e-5, rtol=0)


def test_pipelined_inference_lanes_agree(warm_pred):
    """The pipelined stream over the compact, batched-compact and fused
    lanes yields the same people per image, in input order, for the
    single-scale protocol and for a scale grid."""
    from improved_body_parts_torch.infer import pipelined_inference

    images = [_img(s) for s in (SIZE_A, SIZE_B, SIZE_A)]
    want = [_reference(warm_pred, im) for im in images]
    for kw in (dict(compact=True), dict(compact_batch=2),
               dict(device_decode=True)):
        got = list(pipelined_inference(warm_pred, images, use_native=False,
                                       **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_people(g, w)
    # a scale grid streams through the grid dispatch on every lane, each
    # image with the people of its own grid dispatch (the stub's mirror
    # ghosts come in pairs of equal score: ordered by their keypoints)
    def canonical(people):
        return sorted(people, key=lambda r: (-round(r[1], 3), [
            (-1.0, -1.0) if p is None else (round(p[0]), round(p[1]))
            for p in r[0]]))

    grid = dataclasses.replace(warm_pred.params, scale_search=(0.5, 1.0))
    want = [decode_compact(warm_pred.predict_compact_ms(im, params=grid),
                           grid, SK, use_native=False) for im in images]
    for kw in (dict(compact=True), dict(compact_batch=2),
               dict(device_decode=True)):
        got = list(pipelined_inference(warm_pred, images, grid,
                                       use_native=False, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert len(w) >= 1
            _assert_same_people(canonical(g), canonical(w))
