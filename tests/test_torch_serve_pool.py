"""The port's circuit breaker, client policy and replica pool
(``improved_body_parts_torch.serve.{breaker,policy,pool}``) held to the
JAX package's, on the CPU.

- **Breaker / policy units**: the same outcome script under the same
  ``FakeClock`` gives the same state trace in both packages; the same
  seeded ``random.Random`` gives the same backoff delays (exactly).
- **Pool and policy logic on fake engines**: the cases of
  ``tests/test_serve_pool.py``, each run through both packages' classes
  with the package's own ``ServeMetrics`` inside the fakes; the
  deterministic parts of the outcome (results, counters, metric
  snapshots, replica states) must be equal, and the JAX test's own
  assertions hold on the port.
- **The slice as a whole**: a two-replica ``EnginePool`` over the port's
  CPU ``Predictor``s on the ``tiny`` IMHN with weights converted from a
  seeded Flax tree, wrapped so that its maps are planted people (plus
  1e-3 of seeded noise and 1e-3 x the network's own output), against
  the JAX ``EnginePool`` over JAX ``Predictor``s on the same weights and
  maps: the same images give the same people, equal counts and
  coordinates within 1e-4 px.
"""
import random
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import improved_body_parts_torch.serve as tserve
import improved_body_parts_tpu.serve as jserve

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

PKGS = (("jax", jserve), ("torch", tserve))


# --------------------------------------------------------------------- #
# circuit breaker                                                       #
# --------------------------------------------------------------------- #
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_trace(serve, script, **kw):
    """Run ``script`` (a list of ops) on a breaker of ``serve`` under a
    FakeClock; returns [(op, result, state, trips)] after every op."""
    clock = FakeClock()
    b = serve.CircuitBreaker(clock=clock, **kw)
    trace = []
    for op in script:
        name = op[0]
        if name == "clock":
            clock.t = op[1]
            res = None
        elif name == "fail":
            res = b.record_failure()
        elif name == "ok":
            res = b.record_success()
        elif name == "allow":
            res = b.allow()
        elif name == "release":
            res = b.release_probe()
        elif name == "probation":
            res = b.probation()
        elif name == "reset":
            res = b.reset()
        else:
            raise ValueError(name)
        trace.append((name, res, b.state, b.trips, b.state_code,
                      b.failure_rate()))
    return trace


def _both_breakers(script, **kw):
    want = _breaker_trace(jserve, script, **kw)
    got = _breaker_trace(tserve, script, **kw)
    assert got == want
    return got


class TestCircuitBreaker:
    def test_stays_closed_below_volume_floor(self):
        tr = _both_breakers([("fail",)] * 7 + [("allow",)],
                            failure_threshold=0.5, min_requests=8)
        assert tr[-1][1:3] == (True, "closed")

    def test_trips_at_threshold_and_blocks(self):
        tr = _both_breakers([("ok",), ("ok",), ("fail",), ("fail",),
                             ("allow",)], failure_threshold=0.5,
                            min_requests=4, window=8)
        assert tr[-1][1:4] == (False, "open", 1)

    def test_cooldown_half_open_probes_then_close(self):
        tr = _both_breakers(
            [("fail",), ("fail",), ("clock", 4.9), ("allow",),
             ("clock", 5.1), ("allow",), ("allow",), ("allow",), ("ok",),
             ("ok",), ("allow",)],
            failure_threshold=0.5, min_requests=2, cooldown_s=5.0,
            half_open_probes=2)
        assert [t[1] for t in tr[5:8]] == [True, True, False]
        assert tr[8][2] == "half_open" and tr[9][2] == "closed"

    def test_half_open_failure_reopens_with_fresh_cooldown(self):
        tr = _both_breakers(
            [("fail",), ("fail",), ("clock", 6.0), ("allow",), ("fail",),
             ("clock", 10.0), ("allow",), ("clock", 11.5), ("allow",)],
            failure_threshold=0.5, min_requests=2, cooldown_s=5.0)
        assert tr[4][2:4] == ("open", 2)
        assert tr[6][1] is False and tr[8][2] == "half_open"

    def test_release_probe_returns_the_slot(self):
        tr = _both_breakers(
            [("fail",), ("fail",), ("clock", 2.0), ("allow",), ("allow",),
             ("release",), ("allow",)],
            failure_threshold=0.5, min_requests=2, cooldown_s=1.0,
            half_open_probes=1)
        assert [t[1] for t in tr[3:]] == [True, False, None, True]

    def test_probation_enters_half_open_directly(self):
        tr = _both_breakers([("probation",), ("allow",), ("allow",)],
                            min_requests=2, half_open_probes=1)
        assert tr[0][2] == "half_open" and [tr[1][1], tr[2][1]] == [True,
                                                                      False]

    def test_reset_closes(self):
        tr = _both_breakers([("fail",), ("reset",), ("allow",)],
                            min_requests=1, failure_threshold=1.0)
        assert tr[0][2] == "open" and tr[2][1:3] == (True, "closed")

    @pytest.mark.parametrize("kw", [dict(failure_threshold=0.0),
                                    dict(min_requests=4, window=2),
                                    dict(half_open_probes=0)])
    def test_knob_validation(self, kw):
        for _, serve in PKGS:
            with pytest.raises(ValueError):
                serve.CircuitBreaker(**kw)


# --------------------------------------------------------------------- #
# policy: backoff / retry                                               #
# --------------------------------------------------------------------- #
def test_jittered_backoff_bounds():
    """Equal delays from equal seeded generators, inside the JAX test's
    bounds (exact equality: the same float arithmetic)."""
    delays = {}
    for name, serve in PKGS:
        rng = random.Random(0)
        delays[name] = [serve.jittered_backoff(a, base_s=0.002, max_s=0.25,
                                               jitter=0.5, rng=rng)
                        for a in range(1, 12)]
    assert delays["torch"] == delays["jax"]
    for attempt, d in enumerate(delays["torch"], start=1):
        nominal = min(0.002 * 2 ** (attempt - 1), 0.25)
        assert 0.5 * nominal <= d <= 1.5 * nominal
    assert tserve.jittered_backoff(20, base_s=0.002, max_s=0.25,
                                   jitter=0.0) == pytest.approx(0.25)
    with pytest.raises(ValueError):
        tserve.jittered_backoff(0)


def test_submit_with_retry_counts_and_bounds():
    out = {}
    for name, serve in PKGS:
        calls = {"n": 0}

        def shed_twice(img):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise serve.ServerOverloaded("shed")
            f = Future()
            f.set_result(img)
            return f

        fut, retries = serve.submit_with_retry(shed_twice, "img",
                                               base_s=1e-4,
                                               rng=random.Random(1))
        always = {"n": 0}

        def always_shed(img):
            always["n"] += 1
            raise serve.ServerOverloaded("shed")

        with pytest.raises(serve.ServerOverloaded):
            serve.submit_with_retry(always_shed, "img", max_attempts=3,
                                    base_s=1e-4)
        with pytest.raises(serve.ServerOverloaded):
            serve.submit_with_retry(always_shed, "img",
                                    should_abort=lambda: True)
        out[name] = (fut.result(), retries, always["n"])
    assert out["torch"] == out["jax"] == ("img", 2, 4)


# --------------------------------------------------------------------- #
# fake engines                                                          #
# --------------------------------------------------------------------- #
class FakeEngine:
    """The deadline-/overload-capable stand-in for a DynamicBatcher of
    ``tests/test_serve_pool.py``, over the package's own ServeMetrics and
    exceptions: futures resolve only when the test says so."""

    def __init__(self, serve):
        self.serve = serve
        self.metrics = serve.ServeMetrics()
        self._running = True
        self._draining = False
        self._lock = threading.Lock()
        self.pending = []
        self.mode = "hold"          # hold | ok | fail | shed
        self.result_value = "ok"
        self.fail_with = RuntimeError("replica exploded")
        self.submits = 0
        self.stop_delay_s = 0.0

    @property
    def draining(self):
        return self._draining

    def start(self):
        self._running = True
        return self

    def submit(self, image, *, deadline_s=None):
        s = self.serve
        with self._lock:
            if self._draining:
                self.metrics.on_reject()
                raise s.ServerOverloaded("draining")
            if not self._running:
                raise RuntimeError("not running")
            if self.mode == "shed":
                self.metrics.on_reject()
                raise s.ServerOverloaded("shed")
            if deadline_s is not None and deadline_s <= 0:
                self.metrics.on_expire_rejected()
                raise s.DeadlineExceeded("expired at submit")
            self.submits += 1
            f = Future()
            self.metrics.on_submit()
            if self.mode == "ok":
                self.metrics.on_complete(0.001)
                f.set_result(self.result_value)
            elif self.mode == "fail":
                self.metrics.on_fail()
                f.set_exception(self.fail_with)
            else:
                self.pending.append((image, f))
            return f

    def stop(self, drain_timeout_s=None):
        if self.stop_delay_s:
            time.sleep(self.stop_delay_s)
        with self._lock:
            self._running = False
            pending, self.pending = self.pending, []
        for _, f in pending:
            self.metrics.on_fail()
            try:
                f.set_exception(RuntimeError(
                    "batcher stopped before completion (drain deadline "
                    f"{drain_timeout_s}s exceeded)"))
            except Exception:  # noqa: BLE001
                pass

    def health(self):
        return {"running": self._running, "draining": self._draining,
                "dispatcher_alive": self._running, "fetchers_alive": 1,
                "fetchers_expected": 1,
                "queue_depth": self.metrics.depth,
                "batches_in_flight": 0,
                "stall_age_s": self.metrics.stall_age_s()}

    def complete_all(self, value=None):
        with self._lock:
            pending, self.pending = self.pending, []
        for _, f in pending:
            self.metrics.on_complete(0.001)
            f.set_result(value if value is not None else self.result_value)

    def expire_all(self):
        with self._lock:
            pending, self.pending = self.pending, []
        for _, f in pending:
            self.metrics.on_fail(expired=True)
            f.set_exception(self.serve.DeadlineExceeded("deadline passed"))


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.005)
    return cond()


def _counts(m):
    s = m.snapshot()
    return {k: s[k] for k in ("submitted", "completed", "failed",
                              "rejected", "expired", "queue_depth")}


def _both(scenario):
    """Run ``scenario(serve)`` for each package; the port's outcome must
    equal the JAX package's."""
    want = scenario(jserve)
    got = scenario(tserve)
    assert got == want
    return got


# --------------------------------------------------------------------- #
# PolicyClient on fake engines                                          #
# --------------------------------------------------------------------- #
class TestPolicyClient:
    def test_result_passthrough_and_admission_retry(self):
        def run(serve):
            eng = FakeEngine(serve)
            eng.mode = "shed"
            client = serve.PolicyClient(eng, max_attempts=3,
                                        backoff_base_s=1e-4)
            with pytest.raises(serve.ServerOverloaded):
                client.submit("img")
            eng.mode = "ok"
            res = client.submit("img").result(timeout=5)
            return res, client.stats.snapshot()

        res, stats = _both(run)
        assert res == "ok" and stats["admission_retries"] == 2
        assert stats["submitted"] == 1

    @pytest.mark.parametrize("case", ["client_deadline", "admission"])
    def test_client_deadline_fails_wedged_engine(self, case):
        """A held engine fails the caller at the client deadline; an
        engine that sheds past the deadline fails the admission."""
        def run(serve):
            eng = FakeEngine(serve)
            if case == "client_deadline":
                client = serve.PolicyClient(eng, deadline_s=0.15)
                with pytest.raises(serve.DeadlineExceeded):
                    client.submit("img").result(timeout=5)
            else:
                eng.mode = "shed"
                client = serve.PolicyClient(
                    eng, deadline_s=0.05, max_attempts=1000,
                    backoff_base_s=0.02, backoff_max_s=0.02)
                with pytest.raises(serve.DeadlineExceeded):
                    client.submit("img")
            snap = client.stats.snapshot()
            snap.pop("admission_retries")   # the clock decides how many
            return snap

        stats = _both(run)
        assert stats["deadline_expired"] == 1

    def test_hedge_second_dispatch_first_result_wins(self):
        def run(serve):
            eng = FakeEngine(serve)
            client = serve.PolicyClient(eng, hedge_after_s=0.05)
            fut = client.submit("img")
            assert _wait(lambda: eng.submits >= 2)
            eng.complete_all("late-pair")
            res = fut.result(timeout=5)
            snap = client.stats.snapshot()
            return res, eng.submits, snap["hedges"], snap["submitted"]

        assert _both(run) == ("late-pair", 2, 1, 1)

    def test_fast_result_never_hedges(self):
        def run(serve):
            eng = FakeEngine(serve)
            eng.mode = "ok"
            client = serve.PolicyClient(eng, hedge_after_s=0.2)
            res = client.submit("img").result(timeout=5)
            time.sleep(0.3)
            return res, client.stats.snapshot()["hedges"], eng.submits

        assert _both(run) == ("ok", 0, 1)

    def test_error_waits_for_all_attempts(self):
        def run(serve):
            eng = FakeEngine(serve)
            client = serve.PolicyClient(eng, hedge_after_s=0.05)
            fut = client.submit("img")
            assert _wait(lambda: eng.submits >= 2)
            _, f0 = eng.pending.pop(0)
            eng.metrics.on_fail()
            f0.set_exception(RuntimeError("first attempt died"))
            time.sleep(0.05)
            waited = not fut.done()
            eng.complete_all("rescued")
            return waited, fut.result(timeout=5), \
                client.stats.snapshot()["hedge_wins"]

        assert _both(run) == (True, "rescued", 1)


# --------------------------------------------------------------------- #
# EnginePool on fake engines                                            #
# --------------------------------------------------------------------- #
def _mk_pool(serve, engines, **kw):
    kw.setdefault("probe_interval_s", 0.03)
    kw.setdefault("wedge_timeout_s", 30.0)
    kw.setdefault("drain_timeout_s", 0.5)
    return serve.EnginePool(engines, **kw)


def _states(pool):
    return [(s["state"], s["fence_reason"], s["breaker"])
            for s in pool.replica_states()]


class TestEnginePoolLogic:
    def test_least_loaded_routing(self):
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            with _mk_pool(serve, [a, b]) as pool:
                f1 = pool.submit("x")
                first = (a.submits, b.submits)
                f2 = pool.submit("y")
                second = (a.submits, b.submits)
                a.complete_all()
                b.complete_all()
                res = (f1.result(timeout=5), f2.result(timeout=5))
            return first, second, res, _counts(pool.metrics)

        first, second, res, m = _both(run)
        assert first == (1, 0) and second == (1, 1)
        assert m["submitted"] == m["completed"] == 2

    @pytest.mark.parametrize("modes,want", [
        (("fail", "ok"), ["ok"] * 3),
        (("fail", "fail"), ["RuntimeError"] * 3)])
    def test_failover_on_replica_failure(self, modes, want):
        """One failing replica: every request fails over to the healthy
        one, the callers never see it; both failing: the typed replica
        error after failover exhaustion (the JAX package's
        ``test_failover_exhaustion_delivers_typed_error``)."""
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.mode, b.mode = modes
            with _mk_pool(serve, [a, b]) as pool:
                futs = [pool.submit(f"img{i}") for i in range(3)]
                out = []
                for f in futs:
                    try:
                        out.append(f.result(timeout=5))
                    except RuntimeError as e:
                        assert "replica exploded" in str(e)
                        out.append(type(e).__name__)
                c = pool.counters()
            return out, c, _counts(pool.metrics)

        out, c, m = _both(run)
        assert out == want
        assert c["failovers"] >= 3
        assert m["submitted"] == 3 and m["failed"] == (
            0 if want[0] == "ok" else 3)

    def test_all_replicas_shedding_raises_overloaded(self):
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.mode = b.mode = "shed"
            with _mk_pool(serve, [a, b]) as pool:
                with pytest.raises(serve.ServerOverloaded,
                                   match="no healthy"):
                    pool.submit("img")
                return _counts(pool.metrics)

        m = _both(run)
        assert m["rejected"] == 1 and m["submitted"] == 0

    def test_breaker_trip_fences_and_drains(self):
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.mode, b.mode = "fail", "ok"
            with _mk_pool(serve, [a, b], breaker_kw=dict(
                    failure_threshold=0.5, min_requests=2,
                    cooldown_s=60.0)) as pool:
                res = [pool.submit(f"i{i}").result(timeout=5)
                       for i in range(4)]
                assert _wait(lambda: _states(pool)[0][0] == "fenced")
                states = _states(pool)
                before = a.submits
                late = pool.submit("late").result(timeout=5)
                after = a.submits
            return res, states, late, before == after, \
                pool.counters()["fenced"]

        res, states, late, untouched, fenced = _both(run)
        assert res == ["ok"] * 4 and late == "ok" and untouched
        assert states[0][:2] == ("fenced", "breaker_open") and fenced == 1

    @pytest.mark.parametrize("restart", [False, True])
    def test_stopped_replica_is_fenced_and_pool_keeps_serving(self,
                                                              restart):
        """A replica stopped out from under the pool is fenced as
        ``stopped`` and the pool keeps serving; with ``restart`` it
        rejoins routing (the JAX package's
        ``test_restart_after_fence_rejoins_routing``)."""
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.mode = b.mode = "ok"
            with _mk_pool(serve, [a, b]) as pool:
                assert pool.submit("x").result(timeout=5) == "ok"
                a.stop()
                assert _wait(lambda: _states(pool)[0][0] == "fenced")
                fenced = _states(pool)[0]
                if restart:
                    assert pool.restart(0)
                    again = pool.restart(0)
                else:
                    again = None
                res = [pool.submit(f"y{i}").result(timeout=5)
                       for i in range(3)]
                states = _states(pool)
            return fenced, again, res, states, pool.counters()["restarts"]

        fenced, again, res, states, restarts = _both(run)
        assert fenced[:2] == ("fenced", "stopped") and res == ["ok"] * 3
        if restart:
            assert again is False and states[0][0] == "live"
            assert restarts == 1

    @pytest.mark.parametrize("deadline", [False, True])
    def test_in_flight_resubmitted_when_replica_hard_stops(self,
                                                           deadline):
        """Requests in flight on a replica that hard-stops land on the
        healthy one: zero lost futures; with a door-rejected deadline
        first, conservation holds exactly across the cycle (the JAX
        package's ``test_pool_deadline_and_conservation_across_failure_
        cycle``)."""
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            with _mk_pool(serve, [a, b]) as pool:
                if deadline:
                    with pytest.raises(serve.DeadlineExceeded):
                        pool.submit("dead", deadline_s=0.0)
                futs = [pool.submit(f"r{i}") for i in range(4)]
                on_a = a.submits
                a.stop(drain_timeout_s=0.0)
                deadline_t = time.time() + 5
                while time.time() < deadline_t and \
                        not all(f.done() for f in futs):
                    b.complete_all("moved")
                    time.sleep(0.01)
                res = sorted(f.result(timeout=5) for f in futs)
                m = pool.metrics
                conserved = m.submitted == m.completed + m.failed + m.depth
            return on_a, res, conserved, _counts(pool.metrics), \
                pool.counters()["resubmitted"]

        on_a, res, conserved, m, resubmitted = _both(run)
        assert on_a == 2 and res == ["moved"] * 4 and conserved
        assert m["submitted"] == m["completed"] == 4 and m["failed"] == 0
        assert m["expired"] == int(deadline) and resubmitted == 2

    def test_pool_draining_rejects_and_resolves_everything(self):
        def run(serve):
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.stop_delay_s = b.stop_delay_s = 0.5
            pool = _mk_pool(serve, [a, b]).start()
            futs = [pool.submit(f"p{i}") for i in range(4)]
            stopper = threading.Thread(
                target=lambda: pool.stop(drain_timeout_s=5.0))
            stopper.start()
            assert _wait(lambda: pool.draining)
            with pytest.raises(serve.ServerOverloaded, match="draining"):
                pool.submit("late")
            stopper.join(timeout=30)
            assert not stopper.is_alive()
            outcomes = []
            for f in futs:
                assert f.done()
                outcomes.append(type(f.exception(timeout=0)).__name__)
            return outcomes, _counts(pool.metrics)

        outcomes, m = _both(run)
        assert outcomes == ["RuntimeError"] * 4 and m["failed"] == 4

    def test_expiring_probe_releases_the_half_open_slot(self):
        def run(serve):
            a = FakeEngine(serve)
            with _mk_pool(serve, [a], breaker_kw=dict(
                    min_requests=2, half_open_probes=1)) as pool:
                r = pool._replicas[0]
                r.breaker.probation()
                fut = pool.submit("probe", deadline_s=0.05)
                a.expire_all()
                with pytest.raises(serve.DeadlineExceeded):
                    fut.result(timeout=5)
                allowed = r.breaker.allow()
            return allowed, _counts(pool.metrics)

        allowed, m = _both(run)
        assert allowed and m["expired"] == 1
        assert m["submitted"] == m["completed"] + m["failed"] \
            + m["queue_depth"]

    def test_registry_exposition_with_replica_labels(self):
        """The port's pool through the port's own Registry renders the
        same exposition text as the JAX pair, byte for byte, apart from
        the rate and latency samples the wall clock decides."""
        def run(serve):
            from importlib import import_module

            obs = import_module(serve.__name__.rsplit(".", 1)[0] + ".obs")
            reg = obs.Registry()
            a, b = FakeEngine(serve), FakeEngine(serve)
            a.mode = b.mode = "ok"
            with _mk_pool(serve, [a, b], registry=reg) as pool:
                pool.submit("x").result(timeout=5)
                text = reg.prometheus()
            timed = ("latency", "imgs_per_sec", "stall_age", "_hop_")
            return [ln for ln in text.splitlines()
                    if not any(t in ln for t in timed)]

        lines = _both(run)
        for want in ("pool_submitted_total 1.0",
                     'pool_replica_state_code{replica="0"} 0.0',
                     'pool_breaker_state_code{replica="1"} 0.0',
                     "pool_failovers_total 0.0",
                     'pool_engine_submitted_total{replica="0"} 1.0'):
            assert want in lines

    def test_needs_at_least_one_engine(self):
        for _, serve in PKGS:
            with pytest.raises(ValueError):
                serve.EnginePool([])


# --------------------------------------------------------------------- #
# the slice as a whole: a two-replica pool of tiny CPU predictors       #
# --------------------------------------------------------------------- #
SIZE = 128


@pytest.fixture(scope="module")
def tiny_planted(one_torch_thread):
    """(JAX predictors, port predictors, images): two replicas each of
    the ``tiny`` IMHN on one seeded weight tree, behind the planted-maps
    wrapper of ``test_torch_cascade`` (easy = hard = two planted people,
    so every frame carries them)."""
    from test_torch_cascade import tier_predictors

    rng = np.random.default_rng(11)
    preds = tier_predictors(("two", "two"), replicas=2)
    images = [rng.integers(0, 50, (SIZE, SIZE, 3)).astype(np.uint8)
              for _ in range(3)]
    images += [rng.integers(205, 255, (SIZE, SIZE, 3)).astype(np.uint8)
               for _ in range(3)]
    return preds, images


def _people_close(got, want, atol):
    assert len(got) == len(want)
    for (gk, gs), (wk, ws) in zip(got, want):
        assert abs(gs - ws) <= atol
        assert len(gk) == len(wk)
        for a, b in zip(gk, wk):
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(a[0] - b[0]) <= atol and abs(a[1] - b[1]) <= atol
                assert a[2:] == b[2:]


def test_two_replica_pool_serves_the_jax_pools_people(tiny_planted):
    """Six frames through a two-replica pool in each package (max_batch
    1, so both run the same batch composition): each frame's people
    equal the JAX pool's, counts exactly, coordinates and scores within
    1e-4; both replicas served."""
    (jpreds, tpreds), images = tiny_planted

    def serve_all(serve, preds):
        engines = [serve.DynamicBatcher(p, max_batch=1, max_wait_ms=1,
                                        use_native=False) for p in preds]
        with serve.EnginePool(engines, wedge_timeout_s=60.0) as pool:
            pool.warmup([(SIZE, SIZE)], batch_sizes=(1,))
            futs = [pool.submit(im) for im in images]
            out = [f.result(timeout=120) for f in futs]
            served = [e.metrics.completed for e in pool.engines]
            counters = pool.counters()
        return out, served, counters, _counts(pool.metrics)

    want, jserved, jcounters, jm = serve_all(jserve, jpreds)
    got, tserved, tcounters, tm = serve_all(tserve, tpreds)
    assert tcounters == jcounters and tm["completed"] == jm["completed"] \
        == len(images)
    assert all(n > 0 for n in tserved)
    assert all(len(people) == 2 for people in got)
    for g, w in zip(got, want):
        _people_close(g, w, atol=1e-4)
