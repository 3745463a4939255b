"""The port's process-isolated serving (``improved_body_parts_torch.serve
.{worker,router}``) on the CPU, held to the JAX package.

- **Wire**: ``wire_format`` / ``region_size`` equal the JAX package's;
  ``encode_people`` writes the JAX package's bytes and ``decode_people``
  reads them back bit for bit (signals, missing parts, truncation).
- **One worker process** behind the engine contract, over the JAX
  package's ``constant_predictor`` semantics (its answers equal the JAX
  predictor's, called in-process): refusals, overload shedding, a
  deadline that lapses at the worker, error delivery, SIGKILL ->
  ``WorkerDied`` -> respawn with a new pid, the crash budget; a worker
  whose factory builds the ``tiny`` IMHN on the CPU serves the
  in-process predictor's people bit for bit; a worker over planted maps
  serves the JAX package's people within 1e-4; a worker asked for the
  card on a host without one does not serve.
- **Router**: bit identity against a thread ``EnginePool``, a SIGKILL
  mid-flight with zero lost futures, a fresh pid serving again, a
  verified postmortem and a fleet scrape with both ``worker`` labels;
  a drain resolves every future.

Workers are spawned processes that import torch (~2 s each here).
"""
import os
import signal
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import improved_body_parts_torch.serve as tserve
import improved_body_parts_torch.serve.worker as tworker
from improved_body_parts_torch.data.shm_ring import WorkerDied

SPEC = "improved_body_parts_torch.serve.worker:constant_predictor"
NUM_PARTS = 6
ENGINE_KW = dict(max_image_hw=(64, 64), num_parts=NUM_PARTS,
                 max_people=8, slots=8)


def _img(value: int, hw=(32, 32)) -> np.ndarray:
    return np.full((*hw, 3), value, np.uint8)


def _conserved(m) -> bool:
    return m.submitted == m.completed + m.failed + m.depth


def _jworker():
    """The JAX package's worker module, imported on first use: spawned
    workers import this module for :func:`planted_predictor` and must
    not pay for JAX."""
    import improved_body_parts_tpu.serve.worker as jworker

    return jworker


def _jax_answer(image, **pred_kw):
    """The JAX package's constant predictor on ``image``, in-process."""
    people, sig = _jworker().constant_predictor(
        **dict(dict(num_parts=NUM_PARTS), **pred_kw)).serve_one(image)
    return people, tuple(sig)


# --------------------------------------------------------------------- #
# wire                                                                  #
# --------------------------------------------------------------------- #
def _views(w, max_people=8):
    _, shapes, _ = w.wire_format((64, 64), NUM_PARTS, max_people)
    return [np.zeros(s, np.float64) for s in shapes[2:6]]


PEOPLE = [
    ([(1.5, 2.25), None, (-3.0, 4.125), (0.1, 0.2), None, (7.0, 8.0)],
     3.375),
    ([None, (10.5, 11.0), (12.0, 13.5), None, (1e-9, 2e9),
      (0.0625, 0.03125)], -1.5),
]


class TestWire:
    def test_wire_layout_equals_jax(self):
        jworker = _jworker()
        for hw, parts, people in (((64, 64), 6, 8), ((512, 640), 18, 32)):
            want = jworker.wire_format(hw, parts, people)
            got = tworker.wire_format(hw, parts, people)
            assert got == want
            for slots in (1, 8):
                assert tworker.region_size(slots, *got[1:]) == \
                    jworker.region_size(slots, *want[1:])
        assert (tworker.WIRE_VERSION, tworker.HB_FLOATS,
                tworker.ERR_BYTES) == (jworker.WIRE_VERSION,
                                       jworker.HB_FLOATS, jworker.ERR_BYTES)
        assert (tworker.STATUS_OK, tworker.STATUS_ERROR,
                tworker.STATUS_EXPIRED) == (jworker.STATUS_OK,
                                            jworker.STATUS_ERROR,
                                            jworker.STATUS_EXPIRED)

    @pytest.mark.parametrize("case", ["signals", "none", "empty",
                                      "truncated"])
    def test_roundtrip_bit_identity(self, case):
        from improved_body_parts_torch.infer.decode import EscalationSignals
        from improved_body_parts_tpu.infer.decode import (
            EscalationSignals as JSignals,
        )

        people = PEOPLE
        if case == "empty":
            people = []
        if case == "truncated":
            people = [([(float(p), 1.0)] + [None] * (NUM_PARTS - 1), 1.0)
                      for p in range(1, 12)]
        raw = (2, False, True, False, float("inf"), True)
        sigs = ((EscalationSignals(*raw), JSignals(*raw))
                if case == "signals" else (None, None))
        out = []
        for w, sig in zip((tworker, _jworker()), sigs):
            views = _views(w)
            w.encode_people(people, sig, *views)
            out.append(([v.tobytes() for v in views],
                        w.decode_people(*views[:3])))
        (tbytes, (tpeople, tsig)), (jbytes, (jpeople, jsig)) = out
        assert tbytes == jbytes
        assert tpeople == jpeople == people[:8]
        assert (tsig is None) == (jsig is None)
        if tsig is not None:
            assert tuple(tsig) == tuple(jsig) == raw


# --------------------------------------------------------------------- #
# one worker process                                                    #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def slow_engine():
    """One worker holding each request 0.4 s, with 2 slots."""
    with tserve.ProcessWorkerEngine(
            SPEC, {"num_parts": NUM_PARTS, "delay_s": 0.4},
            **dict(ENGINE_KW, slots=2)) as eng:
        yield eng


class TestProcessWorkerEngine:
    def test_serve_and_contract_refusals(self):
        with tserve.ProcessWorkerEngine(SPEC, {"num_parts": NUM_PARTS},
                                        **ENGINE_KW) as eng:
            with pytest.raises(tserve.DeadlineExceeded):
                eng.submit(_img(1), deadline_s=0.0)
            with pytest.raises(ValueError, match="wire"):
                eng.submit(_img(1, (96, 32)))
            people, signals = eng.submit(
                _img(3), deadline_s=30.0).result(timeout=60)
            assert (people, tuple(signals)) == _jax_answer(_img(3))
            assert people[0][0][0] == (3.0, 32.0)
            h = eng.health()
            assert h["running"] and h["dispatcher_alive"]
            assert h["fetchers_alive"] == h["fetchers_expected"] == 1
            info = eng.worker_info()
            assert info["submitted"] == 1 and info["alive"]
            assert _conserved(eng.metrics)
        with pytest.raises(RuntimeError, match="not running"):
            eng.submit(_img(1))

    @pytest.mark.parametrize("case", ["overload", "deadline"])
    def test_overload_sheds(self, slow_engine, case):
        """Past its slots the engine sheds; a request whose deadline
        lapses while the worker is busy expires AT the worker (the JAX
        package's ``test_deadline_expired_at_worker``).  Both cases on
        one worker (0.4 s a request, 2 slots)."""
        eng = slow_engine
        rejected, expired = eng.metrics.rejected, eng.metrics.expired
        if case == "overload":
            futs = [eng.submit(_img(1)) for _ in range(2)]
            with pytest.raises(tserve.ServerOverloaded, match="in flight"):
                eng.submit(_img(1))
            assert eng.metrics.rejected == rejected + 1
        else:
            futs = [eng.submit(_img(1), deadline_s=30.0)]
            doa = eng.submit(_img(2), deadline_s=0.05)
            with pytest.raises(tserve.DeadlineExceeded):
                doa.result(timeout=60)
            assert eng.metrics.expired == expired + 1
        for f in futs:
            people, _ = f.result(timeout=60)
            assert people == _jax_answer(_img(1))[0]
        assert _conserved(eng.metrics)

    def test_worker_error_delivered_and_engine_survives(self):
        with tserve.ProcessWorkerEngine(SPEC, {"num_parts": NUM_PARTS,
                                               "fail_every": 2},
                                        **ENGINE_KW) as eng:
            eng.submit(_img(1)).result(timeout=60)
            with pytest.raises(RuntimeError,
                               match="injected predictor failure"):
                eng.submit(_img(1)).result(timeout=60)
            eng.submit(_img(1)).result(timeout=60)
            assert eng.metrics.failed == 1
            assert _conserved(eng.metrics)

    def test_sigkill_fails_inflight_and_respawn_serves(self):
        with tserve.ProcessWorkerEngine(SPEC, {"num_parts": NUM_PARTS,
                                               "delay_s": 0.4},
                                        **ENGINE_KW) as eng:
            eng.submit(_img(0)).result(timeout=60)   # worker is up
            fut = eng.submit(_img(1), deadline_s=30.0)
            time.sleep(0.05)
            pid = eng.worker_stats()["pid"]
            os.kill(pid, signal.SIGKILL)
            with pytest.raises(WorkerDied):
                fut.result(timeout=60)
            assert not eng.health()["running"]
            assert eng.consecutive_failures == 1
            pm = eng.last_postmortem
            assert pm["exitcode"] == -signal.SIGKILL
            assert pm["in_flight"]
            eng.start()
            assert eng.health()["running"]
            eng.submit(_img(4)).result(timeout=60)
            assert eng.worker_stats()["pid"] != pid
            assert eng.consecutive_failures == 0
            assert eng.restarts == 2
            assert _conserved(eng.metrics)

    def test_postmortem_when_a_stop_beats_the_fetcher(self):
        """The router's probe can see a SIGKILLed worker's process dead
        and fence it (``stop``) before the fetcher reports the death; the
        fetcher then finds the engine stopped.  The postmortem must not
        depend on that order: the stop exhumes the ring of a worker it
        finds dead.  The fetcher's report is held here until the stop
        returns, the order under which ``last_postmortem`` stayed None
        (``test_kill_mid_flight_fails_over_and_respawns``, once under
        load)."""
        import threading

        from improved_body_parts_torch.obs.fleet import verify_postmortem

        eng = tserve.ProcessWorkerEngine(SPEC, {"num_parts": NUM_PARTS,
                                                "delay_s": 0.5},
                                         **ENGINE_KW)
        late = threading.Event()
        report = eng._on_worker_death

        def after_the_stop(gen):
            late.wait(30)
            report(gen)

        eng._on_worker_death = after_the_stop
        try:
            eng.start()
            eng.submit(_img(0)).result(timeout=60)   # worker is up
            fut = eng.submit(_img(1), deadline_s=30.0)
            assert _wait(lambda: any(
                r["kind"] == "pickup" and r["seq"] == 4
                for r in eng.flight_records()["records"]))
            pid = eng.worker_stats()["pid"]
            os.kill(pid, signal.SIGKILL)
            assert _wait(lambda: not eng.health()["dispatcher_alive"])
            eng.stop(drain_timeout_s=1.0)       # the probe's fence drain
        finally:
            late.set()
            eng.stop()
        with pytest.raises(Exception):
            fut.result(timeout=60)
        pm = eng.last_postmortem
        ok, problems = verify_postmortem(pm)
        assert ok, problems
        assert (pm["pid"], pm["exitcode"]) == (pid, -signal.SIGKILL)
        assert [e["seq"] for e in pm["in_flight"]] == [4]
        assert eng.consecutive_failures == 1

    def test_crash_budget_stops_the_respawn_loop(self):
        eng = tserve.ProcessWorkerEngine(SPEC, {"num_parts": NUM_PARTS},
                                         crash_budget=2, backoff_base_s=0.0,
                                         **ENGINE_KW)
        eng.consecutive_failures = 2
        eng.start()
        assert eng.gave_up and not eng.health()["running"]
        eng.stop()

    def test_real_predictor_worker_on_the_cpu(self, tmp_path):
        """A worker whose factory builds the ``tiny`` IMHN with
        ``device="cpu"`` (``serve.artifacts:checkpoint_predictor`` from a
        JSON spec) warms up and serves the in-process predictor's people
        bit for bit; a worker asked for the card on a host without one
        fails to start instead of serving on the CPU.

        This holds the transport only, on the port's seeded init: the
        in-process predictor it equals is held to the JAX package on
        converted weights in ``test_torch_serve.py`` and
        ``test_torch_slice.py``, and a worker's people are held to the
        JAX package's in the planted-maps test below."""
        from improved_body_parts_torch.infer.decode import device_signals
        from improved_body_parts_torch.infer.pipeline import device_decode_fn

        spec = "improved_body_parts_torch.serve.artifacts:checkpoint_predictor"
        kw = {"config": "tiny", "boxsize": 128, "bucket": 64, "seed": 3,
              "device": "cpu"}
        img = np.random.default_rng(2).integers(0, 255, (128, 96, 3),
                                                dtype=np.uint8)
        pred = tserve.checkpoint_predictor(**kw)
        dev = pred.predict_decoded(img)
        want = device_decode_fn(pred)(dev, img)
        with tserve.ProcessWorkerEngine(
                spec, kw, max_image_hw=(128, 128), num_parts=18,
                max_people=32, slots=2, warmup_timeout_s=120.0) as eng:
            info = eng.warmup([(128, 96)], batch_sizes=[1])
            assert info["newly_compiled"] >= 1
            people, signals = eng.submit(img).result(timeout=120)
        assert people == want
        assert tuple(signals) == tuple(device_signals(dev))
        if not torch.cuda.is_available():
            eng = tserve.ProcessWorkerEngine(
                spec, dict(kw, device="cuda"), max_image_hw=(128, 128),
                num_parts=18, max_people=32, slots=2)
            eng.start()
            assert _wait(lambda: not eng.health()["running"], 60)
            assert eng.consecutive_failures == 1
            eng.stop()


UNIT_POSE = {
    "nose": (0.50, 0.10), "neck": (0.50, 0.25),
    "Rsho": (0.35, 0.25), "Relb": (0.30, 0.42), "Rwri": (0.28, 0.58),
    "Lsho": (0.65, 0.25), "Lelb": (0.70, 0.42), "Lwri": (0.72, 0.58),
    "Rhip": (0.40, 0.55), "Rkne": (0.40, 0.75), "Rank": (0.40, 0.95),
    "Lhip": (0.60, 0.55), "Lkne": (0.60, 0.75), "Lank": (0.60, 0.95),
    "Reye": (0.45, 0.07), "Leye": (0.55, 0.07),
    "Rear": (0.40, 0.09), "Lear": (0.60, 0.09),
}


class MirrorStub(torch.nn.Module):
    """Returns fixed stride-4 maps on the image lanes and their exact
    mirror on the mirror lanes, so the flip merge returns them."""

    def __init__(self, maps, sk):
        super().__init__()
        self.maps = torch.from_numpy(maps)
        self.perm = list(sk.flip_paf_ord) + [sk.paf_layers + i
                                             for i in sk.flip_heat_ord]

    def forward(self, imgs):
        n, h, w, _ = imgs.shape
        m = self.maps[:h // 4, :w // 4]
        mirror = m.flip(1)[..., self.perm]
        return [[torch.stack([m] * (n // 2) + [mirror] * (n // 2))]]


def _planted_maps():
    """Stride-4 maps of two planted people on a 128x128 canvas (the
    port's ``Heatmapper``, plus 1e-3 of seeded noise), as numpy."""
    import dataclasses

    from improved_body_parts_torch import config as tconfig
    from improved_body_parts_torch.data.heatmapper import Heatmapper

    sk = tconfig.get_config("canonical").skeleton
    small = dataclasses.replace(sk, width=128, height=128)
    joints = np.zeros((2, sk.num_parts, 3), np.float32)
    joints[..., 2] = 1
    for p, x0 in enumerate((10.0, 70.0)):
        for j, part in enumerate(sk.parts):
            ux, uy = UNIT_POSE[part]
            joints[p, j, :2] = (x0 + ux * 45.0, 15.0 + uy * 100.0)
    maps = Heatmapper(small).create_heatmaps(
        joints, np.ones(small.grid_shape, np.float32))
    maps = maps + np.random.default_rng(0).uniform(0, 1e-3, maps.shape)
    return maps.astype(np.float32)


def planted_predictor():
    """Factory spec target: a CPU ``Predictor`` over a stub network whose
    maps are :func:`_planted_maps`."""
    from improved_body_parts_torch import config as tconfig
    from improved_body_parts_torch.infer import Predictor

    sk = tconfig.get_config("canonical").skeleton
    return Predictor(MirrorStub(_planted_maps(), sk), sk,
                     model_params=tconfig.InferenceModelParams(
                         boxsize=128, max_downsample=64),
                     bucket=64, device="cpu")


def _jax_planted_people(images):
    """The JAX package's in-process batcher over a JAX ``Predictor`` whose
    stub network returns the same planted maps (mirrored on the mirror
    lanes, as :class:`MirrorStub` does)."""
    import jax.numpy as jnp

    import improved_body_parts_tpu.serve as jserve
    from improved_body_parts_tpu import config as jconfig
    from improved_body_parts_tpu.infer import Predictor as JPredictor

    sk = jconfig.get_config("canonical").skeleton
    maps = _planted_maps()
    perm = np.asarray(list(sk.flip_paf_ord)
                      + [sk.paf_layers + i for i in sk.flip_heat_ord])

    class JaxMirrorStub:
        def apply(self, variables, imgs, train=False):
            n, h, w, _ = imgs.shape
            m = jnp.asarray(maps[:h // 4, :w // 4])
            mirror = m[:, ::-1][..., perm]
            return [[jnp.stack([m] * (n // 2) + [mirror] * (n // 2))]]

    pred = JPredictor(JaxMirrorStub(), {}, sk,
                      model_params=jconfig.InferenceModelParams(
                          boxsize=128, max_downsample=64), bucket=64)
    with jserve.DynamicBatcher(pred, max_batch=1,
                               use_native=False) as server:
        return [server.submit(im).result(timeout=120) for im in images]


def test_planted_people_through_the_wire_equal_in_process():
    """A worker over planted maps returns the in-process batcher's person
    tables bit for bit when the wire is as wide as a table (COCO's 17
    keypoints), and the JAX package's in-process batcher's over the same
    maps within 1e-4 (counts, scores and visibility exact, coordinates
    and scores within 1e-4); at the wire's default width (18, the
    skeleton's part count, as in the JAX package) each person gains an
    18th ``None``, in both packages' encoding."""
    spec = "test_torch_serve_proc:planted_predictor"
    images = [np.zeros((128, w, 3), np.uint8) for w in (128, 112)]
    with tserve.DynamicBatcher(planted_predictor(), max_batch=1,
                               use_native=False) as server:
        want = [server.submit(im).result(timeout=60) for im in images]
    assert [len(people) for people in want] == [2, 2]
    with tserve.ProcessWorkerEngine(spec, {}, max_image_hw=(128, 128),
                                    num_parts=17, max_people=32,
                                    slots=2) as eng:
        got = [eng.submit(im).result(timeout=60)[0] for im in images]
    assert got == want
    for g, j in zip(got, _jax_planted_people(images)):
        assert len(g) == len(j)
        for (gk, gs), (jk, js) in zip(g, j):
            assert abs(gs - js) <= 1e-4 and len(gk) == len(jk)
            for a, b in zip(gk, jk):
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a[0] - b[0]) <= 1e-4
                    assert abs(a[1] - b[1]) <= 1e-4
                    assert a[2:] == b[2:]
    for w in (tworker, _jworker()):
        _, shapes, _ = w.wire_format((128, 128), 18, 32)
        views = [np.zeros(sh, np.float64) for sh in shapes[2:6]]
        w.encode_people(want[0], None, *views)
        wide, _ = w.decode_people(*views[:3])
        assert [(kps[:17], sc) for kps, sc in wide] == want[0]
        assert all(kps[17] is None for kps, _ in wide)


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


# --------------------------------------------------------------------- #
# thread arm and router                                                 #
# --------------------------------------------------------------------- #
class InlineEngine:
    """The same constant predictor served in-process on threads — the
    thread-pool arm of the bit-identity check."""

    def __init__(self, **pred_kw):
        self.pred = tworker.constant_predictor(**pred_kw)
        self.metrics = tserve.ServeMetrics()
        self._running = False
        self._draining = False

    @property
    def draining(self):
        return self._draining

    def start(self):
        self._running = True
        return self

    def stop(self, drain_timeout_s=None):
        self._running = False

    def warmup(self, image_sizes, batch_sizes=None):
        return {}

    def submit(self, image, *, deadline_s=None):
        if not self._running:
            raise RuntimeError("not running")
        self.metrics.on_submit()
        f = Future()
        f.set_result(self.pred.serve_one(image))
        self.metrics.on_complete(0.001)
        return f

    def health(self):
        return {"running": self._running, "draining": self._draining,
                "dispatcher_alive": self._running, "fetchers_alive": 1,
                "fetchers_expected": 1, "queue_depth": self.metrics.depth,
                "batches_in_flight": 0,
                "stall_age_s": self.metrics.stall_age_s()}


class TestProcessRouter:
    def test_bit_identity_thread_vs_process_pool(self):
        pred_kw = {"num_parts": NUM_PARTS, "n_people": 3}
        images = [_img(v, (32, 48)) for v in (0, 7, 19, 255)]
        with tserve.EnginePool([InlineEngine(**pred_kw),
                                InlineEngine(**pred_kw)]) as tpool:
            thread_res = [tpool.submit(im).result(timeout=10)
                          for im in images]
        with tserve.ProcessRouter(SPEC, num_workers=2,
                                  spec_kwargs=pred_kw,
                                  **ENGINE_KW) as router:
            proc_res = [router.submit(im).result(timeout=60)
                        for im in images]
        assert thread_res == proc_res
        assert [(p, tuple(s)) for p, s in proc_res] == [
            _jax_answer(im, n_people=3) for im in images]

    def test_kill_mid_flight_fails_over_and_respawns(self):
        """SIGKILL worker 0 with work in flight: every future resolves
        with a result, the pool fences and fails over, a fresh pid serves
        again, the postmortem verifies and the fleet scrape carries both
        ``worker`` labels."""
        from improved_body_parts_torch.obs import Registry
        from improved_body_parts_torch.obs.fleet import verify_postmortem

        reg = Registry()
        with tserve.ProcessRouter(SPEC, num_workers=2,
                                  spec_kwargs={"num_parts": NUM_PARTS,
                                               "delay_s": 0.25},
                                  restart_after_s=0.3,
                                  probe_interval_s=0.05,
                                  **ENGINE_KW) as router:
            router.register_into(reg)
            for v in (0, 1):
                router.submit(_img(v)).result(timeout=60)
            pid = router.workers[0].worker_stats()["pid"]
            futs = [router.submit(_img(v), deadline_s=60.0)
                    for v in range(6)]
            time.sleep(0.05)
            os.kill(pid, signal.SIGKILL)
            for v, f in enumerate(futs):
                people, _ = f.result(timeout=60)
                assert people == _jax_answer(_img(v))[0]
            c = router.counters()
            assert c["fenced"] >= 1 and c["failovers"] >= 1
            assert _wait(lambda: router.counters()["restarts"] >= 1
                         and router.workers[0].health()["running"])
            router.submit(_img(9)).result(timeout=60)
            assert router.workers[0].worker_stats()["pid"] not in (None,
                                                                   pid)
            m = router.metrics
            assert _conserved(m) and m.failed == 0
            pm = router.last_postmortems()[0]
            ok, problems = verify_postmortem(pm)
            assert ok, problems
            assert _wait(lambda: all(
                r["telemetry"].get("published")
                for r in router.fleet._rows()))
            text = reg.prometheus()
            assert router.counters()["worker_respawns"] >= 1
        for w in ("0", "1"):
            assert f'worker="{w}"' in text
        assert "fleet_worker_served_total" in text

    def test_drain_resolves_every_future(self):
        router = tserve.ProcessRouter(SPEC, num_workers=2,
                                      spec_kwargs={"num_parts": NUM_PARTS,
                                                   "delay_s": 0.15},
                                      **ENGINE_KW).start()
        futs = [router.submit(_img(v), deadline_s=60.0) for v in range(8)]
        router.stop(drain_timeout_s=30.0)
        for f in futs:
            assert f.done()
            f.exception(timeout=0)
        assert _conserved(router.metrics)
