"""The port's registry, SLO tracker and metrics endpoint
(``improved_body_parts_torch.obs.{registry,slo,http}``) held to the JAX
package's, on the CPU.

- ``Registry.prometheus()``, ``iter_samples()`` and ``snapshot()`` of the
  same recorded series (counters, gauges, span timers, seeded histogram
  reservoirs, 4- and 5-tuple collectors, a dead collector) are equal,
  the exposition text byte for byte.
- ``SLOTracker``: the same outcomes under one fake clock give the same
  ``/slo`` document after every record (burn rates, budgets, alarm
  transitions), and the same ``slo_alarm`` events; the scenarios are
  those of ``tests/test_slo.py``.
- ``MetricsServer``: the route table and the unknown-route 404 body are
  the JAX package's; ``/slo`` answers 200 / 503 / 404 and HEAD as there;
  ``/fleet`` answers 404 until wired; ``/history`` and ``/query`` answer
  over a wired history store as the JAX package's do (the codes and
  bodies of each package's server over the same ticks), and 404 when
  none is wired.
"""
import json
import urllib.error
import urllib.request

import pytest

import improved_body_parts_torch.obs as tobs
import improved_body_parts_tpu.obs as jobs

PKGS = (("jax", jobs), ("torch", tobs))


def _both(scenario):
    want = scenario(jobs)
    got = scenario(tobs)
    assert got == want
    return got


# --------------------------------------------------------------------- #
# registry                                                              #
# --------------------------------------------------------------------- #
def _recorded(obs):
    """One registry with every kind of series recorded the same way."""
    import numpy as np

    reg = obs.Registry()
    rng = np.random.default_rng(0)
    reg.counter("requests_total", "requests seen").inc(3)
    reg.counter("requests_total", labels={"lane": "fused"}).inc(2.5)
    reg.gauge("queue_depth", "admitted, not done").set(7)
    reg.gauge("live_fn", fn=lambda: 4.25)
    reg.gauge("dead_fn", fn=lambda: 1 / 0)
    h = reg.histogram("latency_seconds", "e2e", labels={"model": "s"},
                      capacity=64, seed=3)
    for v in rng.exponential(0.05, 300):
        h.observe(float(v))
    reg.histogram("empty_seconds")
    reg.counter("weird-name.9", labels={"q\"uote": 'a"b\\c\nd'}).inc()  # graftlint: disable=JGL006 -- exercises the exposition's name sanitizer
    reg.register_collector(lambda: [
        ("coll_total", {"worker": "0"}, "counter", 5.0),
        ("coll_gauge", {}, "gauge", 0.5, "with help text")])
    reg.register_collector(lambda: 1 / 0)
    phases = obs.StepPhases(reg, prefix="train")
    for _ in phases.attribute(range(3)):
        pass
    return reg


def test_registry_exposition_equals_jax_byte_for_byte():
    def run(obs):
        reg = _recorded(obs)
        text = reg.prometheus()
        samples = [(n, lab, k, v, hp) for n, lab, k, v, hp
                   in reg.iter_samples()
                   if not n.startswith("train_")]   # wall-clock splits
        snap = {k: v for k, v in reg.snapshot().items()
                if not k.startswith("train_")}
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith("train_")]
        return lines, samples, json.dumps(snap, sort_keys=True,
                                          default=str, allow_nan=False)

    lines, samples, _ = _both(run)
    assert 'latency_seconds{model="s",quantile="0.99"}' in "\n".join(lines)
    assert "# HELP coll_gauge with help text" in lines
    assert any(s[0] == "dead_fn" and s[3] == 0.0 for s in samples)
    assert "train_batches_total 3.0" in _recorded(tobs).prometheus()


def test_registry_name_kind_clash_raises():
    for _, obs in PKGS:
        reg = obs.Registry()
        reg.counter("x_total")
        with pytest.raises(TypeError):
            reg.gauge("x_total")
        assert reg.counter("x_total") is reg.counter("x_total")
    assert tobs.get_registry() is tobs.get_registry()
    assert tobs.INPUT_BOUND_FRAC == jobs.INPUT_BOUND_FRAC


# --------------------------------------------------------------------- #
# SLO tracker                                                           #
# --------------------------------------------------------------------- #
class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _track(obs, script, target=0.9, latency_ms=100.0,
           windows=(10.0, 100.0), burn_alarm=2.0, min_requests=5, **kw):
    """Run ``script`` — (latency_s, error) records and ("advance", dt)
    steps — on a tracker of ``obs``; the ``/slo`` document after every
    record."""
    clock = FakeClock()
    tracker = obs.SLOTracker(
        [obs.Objective("interactive", latency_ms=latency_ms,
                       target=target, windows_s=windows,
                       burn_alarm=burn_alarm, min_requests=min_requests)],
        clock=clock, **kw)
    docs = []
    for step in script:
        if step[0] == "advance":
            clock.advance(step[1])
            continue
        tracker.record(*step)
        docs.append(tracker.state())
    return docs, tracker


def _slo_scenario(script, **kw):
    return _both(lambda obs: _track(obs, script, **kw)[0])


class TestBurnRate:
    def test_good_traffic_burns_nothing(self):
        docs = _slo_scenario([("interactive", 0.01), ("advance", 0.1)]
                             * 20)
        cls = docs[-1]["classes"]["interactive"]
        assert cls["error_budget_remaining"] == 1.0 and not cls["alarm"]

    def test_slow_success_is_bad(self):
        docs = _slo_scenario([("interactive", 0.5)])
        assert docs[-1]["classes"]["interactive"]["good_total"] == 0

    def test_burn_rate_math(self):
        script = []
        for i in range(10):
            script += [("interactive", 0.01, i < 2), ("advance", 0.1)]
        docs = _slo_scenario(script)
        cls = docs[-1]["classes"]["interactive"]
        for win in cls["windows"].values():
            assert win["burn_rate"] == pytest.approx(2.0)
        assert cls["error_budget_remaining"] == 0.0

    def test_windows_forget_at_different_rates(self):
        script = [("interactive", 0.01, True), ("advance", 0.1)] * 5
        script += [("advance", 15.0)]
        script += [("interactive", 0.01), ("advance", 0.1)] * 20
        wins = _slo_scenario(script)[-1]["classes"]["interactive"][
            "windows"]
        assert wins["10s"]["burn_rate"] == 0.0
        assert wins["100s"]["burn_rate"] > 0.0

    def test_alarm_needs_every_window_and_volume(self):
        docs = _slo_scenario([("interactive", 0.01, True)] * 7)
        alarms = [d["classes"]["interactive"]["alarm"] for d in docs]
        assert alarms == [False] * 4 + [True] * 3

    def test_alarm_transitions_emit_sink_events(self, tmp_path):
        script = [("interactive", 0.01, True), ("advance", 0.1)] * 8
        script += [("advance", 30.0)]
        script += [("interactive", 0.01), ("advance", 0.1)] * 20
        events = {}
        for name, obs in PKGS:
            path = str(tmp_path / f"{name}.jsonl")
            sink = obs.EventSink(path)
            prev = obs.set_sink(sink)
            try:
                docs, _ = _track(obs, script, windows=(10.0, 20.0))
            finally:
                obs.set_sink(prev)
                sink.close()
            events[name] = ([{k: v for k, v in e.items() if k != "t"}
                             for e in obs.read_events(path)
                             if e["event"] == "slo_alarm"], docs)
        assert events["torch"] == events["jax"]
        assert [a["state"] for a in events["torch"][0]] == ["firing",
                                                            "resolved"]
        assert events["torch"][1][-1]["classes"]["interactive"][
            "alarm_transitions"] == 1

    def test_unclassified_counted_or_defaulted(self):
        docs = _slo_scenario([("typo_class", 0.01)])
        assert docs[-1]["unclassified_requests"] == 1
        docs = _slo_scenario([("typo_class", 0.01)],
                             default_class="interactive")
        assert docs[-1]["classes"]["interactive"]["requests_total"] == 1
        for _, obs in PKGS:
            with pytest.raises(ValueError):
                _track(obs, [], default_class="nope")


class TestObjective:
    def test_declarative_round_trip(self):
        spec = {"latency_ms": 250.0, "target": 0.99,
                "windows_s": [60.0, 600.0], "burn_alarm": 2.0,
                "min_requests": 10}
        for _, obs in PKGS:
            assert obs.Objective.from_dict("i", spec).to_dict() == spec
        assert [o.to_dict() for o in tobs.default_objectives()] == [
            o.to_dict() for o in jobs.default_objectives()]

    @pytest.mark.parametrize("bad", [
        dict(latency_ms=10, target=1.0), dict(latency_ms=0),
        dict(latency_ms=10, windows_s=())])
    def test_degenerate_targets_refused(self, bad):
        for _, obs in PKGS:
            with pytest.raises(ValueError):
                obs.Objective("x", **bad)
            with pytest.raises(ValueError, match="unknown keys"):
                obs.Objective.from_dict("x", {"latency_ms": 1,
                                              "latencyms": 2})


def test_collector_exposition_equals_jax():
    def run(obs):
        _, tracker = _track(obs, [("interactive", 0.01),
                                  ("interactive", 0.5, False),
                                  ("interactive", 0.01, True)])
        reg = obs.Registry()
        tracker.register_into(reg)
        return reg.prometheus()

    text = _both(run)
    for name in ("slo_requests_total", "slo_good_total",
                 "slo_error_budget_remaining", "slo_alarm",
                 'slo_burn_rate{class="interactive",window="10s"}'):
        assert name in text


# --------------------------------------------------------------------- #
# metrics endpoint                                                      #
# --------------------------------------------------------------------- #
def _get(url, method="GET"):
    try:
        resp = urllib.request.urlopen(
            urllib.request.Request(url, method=method), timeout=10)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _unknown_route_body(routes):
    paths = [p for p, _ in routes]
    return ("use " + ", ".join(paths[:-1]) + " or " + paths[-1]).encode()


def test_routes_table_and_404_body_equal_jax():
    assert tobs.ROUTES == jobs.ROUTES
    bodies = {}
    for name, obs in PKGS:
        with obs.MetricsServer(obs.Registry(), port=0) as srv:
            bodies[name] = [_get(srv.url + p)
                            for p in ("/nope", "/slo", "/fleet")]
            bodies[name].append(_get(srv.url + "/nope", method="HEAD"))
    assert bodies["torch"] == bodies["jax"]
    assert [c for c, _ in bodies["torch"]] == [404] * 4
    assert _unknown_route_body(tobs.ROUTES) in bodies["torch"][0][1]


class _Clock:
    """A settable clock for the history store's sampler."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _history_answers(obs, paths, wired=True):
    """Each path's (code, body) from a server over a history store that
    folded the same six ticks of one counter and one gauge; the store's
    creation and tick times come from a fake clock, so the documents of
    both packages can be compared byte for byte."""
    reg = obs.Registry()
    hits = reg.counter("hits_total")
    depth = reg.gauge("queue_depth", labels={"lane": "fused"})
    clock = _Clock()
    store = obs.HistoryStore(reg, cadence_s=1.0, raw_capacity=4,
                             levels=((2.0, 8),), clock=clock)
    for i in range(6):
        clock.t += 1.0
        hits.inc(i + 1)
        depth.set(float(i % 3))
        store.sample_now()
    out = []
    with obs.MetricsServer(reg, port=0,
                           history=store if wired else None) as srv:
        for path, method in paths:
            out.append(_get(srv.url + path, method=method))
    store.close()
    return out


@pytest.mark.parametrize("path", [
    "/history", "/query?series=hits_total",
    "/query?series=hits_total&step=2&limit=2",
    '/query?series=queue_depth%7Blane%3D%22fused%22%7D&since=1003'])
def test_history_routes_answer_as_jax(path):
    """``/history`` and ``/query`` over a wired store answer 200 with
    the JAX package's documents, to GET and (without a body) to HEAD."""
    paths = [(path, "GET"), (path, "HEAD")]
    got = _history_answers(tobs, paths)
    assert got == _history_answers(jobs, paths)
    assert got[0][0] == 200 and json.loads(got[0][1])
    assert got[1] == (200, b"")


@pytest.mark.parametrize("path,wired,code", [
    ("/query", True, 400), ("/query?series=x&since=a", True, 400),
    ("/query?series=nope", True, 404), ("/history", False, 404),
    ("/query?series=x", False, 404)])
def test_history_route_errors_answer_as_jax(path, wired, code):
    """Malformed and unknown-series queries, and the routes without a
    wired store, give the JAX package's codes and bodies."""
    got = _history_answers(tobs, [(path, "GET")], wired=wired)
    assert got == _history_answers(jobs, [(path, "GET")], wired=wired)
    assert got[0][0] == code


def test_slo_route_ok_alarm_head_and_404():
    out = {}
    for name, obs in PKGS:
        clock = FakeClock()
        tracker = obs.SLOTracker([obs.Objective(
            "interactive", latency_ms=100.0, target=0.9,
            windows_s=(10.0, 20.0), min_requests=5)], clock=clock)
        reg = obs.Registry()
        reg.counter("hits_total").inc(3)
        seen = []
        with obs.MetricsServer(reg, port=0, slo=tracker.state,
                               fleet=lambda: {"workers": []},
                               extra=lambda: {"run": "x"}) as srv:
            tracker.record("interactive", 0.01)
            seen.append(_get(srv.url + "/slo"))
            seen.append(_get(srv.url + "/slo", method="HEAD"))
            for _ in range(8):
                tracker.record("interactive", 0.01, error=True)
                clock.advance(0.1)
            code, body = _get(srv.url + "/slo")
            seen.append((code, json.loads(body)["status"]))
            for route in ("/metrics", "/snapshot", "/healthz", "/fleet"):
                seen.append(_get(srv.url + route))
        out[name] = seen
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0] == 200 and out["torch"][1] == (200, b"")
    assert out["torch"][2] == (503, "alarm")
