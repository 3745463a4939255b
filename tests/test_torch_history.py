"""The port's telemetry history (``improved_body_parts_torch.obs.history``),
capacity model (``serve.capacity``) and history routes held to the JAX
package's, on the CPU.

Both packages' history code is host Python over their registries, and
every sample is folded on an injected clock, so equality is exact:

- the same ticks folded (a registry's counters, labelled gauges and
  histogram quantiles, the pool/SLO source families, a sampler blackout
  and a ``max_series`` bound) give equal stores: the raw and aggregate
  rings (``query``), the gap records, ``rate``, ``trend``,
  ``window_quantiles``, ``integrate_rate``, ``burn_rate``, ``signals``
  and the ``/history`` document;
- shards written by either package replay in the other bit for bit, on
  every derived signal; the port's own shards are strict JSON, rotate
  like the JAX package's and carry values read from torch as Python
  floats;
- ``CapacityModel``: the same points, and the same history store, fit
  the same model, ``replicas_needed`` and registry gauges;
- ``MetricsServer(history=)`` serves ``/history`` and ``/query`` over a
  store the sampler thread fills (``start``/``close`` joined).
"""
import json
import math
import sys
import urllib.request

import numpy as np
import pytest
import torch

import improved_body_parts_torch.obs as tobs
import improved_body_parts_tpu.obs as jobs
from improved_body_parts_torch.serve import capacity as tcap
from improved_body_parts_tpu.serve import capacity as jcap

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

PKGS = (("jax", jobs), ("torch", tobs))


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _fold(obs, n=60, persist_path=None, shard_records=4096,
          max_series=512):
    """One store over a registry and a pool/SLO source, folded over ``n``
    seeded ticks with one sampler blackout; returns the store (closed)."""
    rng = np.random.default_rng(0)
    clock = FakeClock()
    reg = obs.Registry()
    done = reg.counter("serve_completed_total")
    depth = reg.gauge("serve_queue_depth", labels={"replica": "0"})
    lat = reg.histogram("serve_e2e_latency_seconds", capacity=64, seed=2)
    state = {"pool": 0.0}

    def source():
        return [
            ("pool_completed_total", {}, "counter", state["pool"]),
            ("pool_engine_hop_latency_seconds",
             {"replica": "0", "hop": "queue", "quantile": "0.99"},
             "gauge", 0.01 + 0.001 * (state["pool"] % 7)),
            ("pool_hop_conservation_frac", {}, "gauge", 0.99),
            ("slo_burn_rate", {"class": "interactive", "window": "5m"},
             "gauge", state["pool"] / 100.0),
        ] + [(f"extra_{i}", {}, "gauge", float(i)) for i in range(8)]

    store = obs.HistoryStore(reg, cadence_s=0.25, raw_capacity=32,
                             levels=((1.0, 16), (5.0, 8)),
                             max_series=max_series, sources=[source],
                             clock=clock, persist_path=persist_path,
                             shard_records=shard_records, run_id="run-x")
    store.register_into(reg)
    for i in range(n):
        done.inc(float(rng.integers(0, 5)))
        depth.set(float(rng.integers(0, 9)))
        lat.observe(float(rng.exponential(0.05)))
        state["pool"] += float(rng.integers(1, 4))
        clock.t += 2.0 if i == 30 else 0.25          # a blackout
        store.sample_now()
    store.close()
    return store


def _feed(st):
    """Every reader of a store, as one comparable document."""
    keys = st.keys()
    out = {"keys": keys, "signals": st.signals(),
           "signals_at": st.signals(now=104.0, rate_window_s=3.0),
           "burn": st.burn_rate("interactive", "5m"),
           "burn_absent": st.burn_rate("batch", "1h")}
    doc = st.doc()
    doc.pop("persist")
    doc.pop("sampler_alive")
    out["doc"] = doc
    for k in keys:
        out[k] = {
            "latest": st.latest(k), "rate": st.rate(k, 5.0),
            "rate_at": st.rate(k, 2.0, now=103.0),
            "trend": st.trend(k, 5.0),
            "quantiles": st.window_quantiles(k, 5.0,
                                             qs=(50.0, 95.0, 99.9)),
            "integral": st.integrate_rate(k),
            "raw": st.query(k), "agg1": st.query(k, step=1.0),
            "agg5": st.query(k, step=4.0, since=105.0, limit=3),
        }
    return out


def test_folded_ticks_equal_jax():
    want = _feed(_fold(jobs))
    got = _feed(_fold(tobs))
    assert got == want                                   # no tolerance
    assert got["doc"]["gaps"]["count"] >= 1
    assert got["signals"]["hop_conservation_frac"] == 0.99


@pytest.mark.parametrize("max_series", [6, 512])
def test_series_bound_and_keys_equal_jax(max_series):
    st = {name: _fold(obs, n=12, max_series=max_series)
          for name, obs in PKGS}
    assert st["torch"].doc() == st["jax"].doc()
    assert (st["torch"].doc()["series_dropped"] > 0) == (max_series == 6)
    for labels in ({}, {"b": "2", "a": "x\"y"}):
        assert (tobs.series_key("m_total", labels)
                == jobs.series_key("m_total", labels))
    assert (tobs.history_path_for("/x/events.jsonl")
            == jobs.history_path_for("/x/events.jsonl"))
    assert tobs.HISTORY_SCHEMA == jobs.HISTORY_SCHEMA


@pytest.mark.parametrize("writer,reader", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_shards_replay_across_packages_bit_for_bit(tmp_path, writer,
                                                   reader):
    obs = dict(PKGS)
    path = str(tmp_path / "events_history.jsonl")
    live = _fold(obs[writer], n=30, persist_path=path, shard_records=8)
    shards = obs[reader].discover_history_shards(path)
    assert shards == obs[writer].discover_history_shards(path)
    assert len(shards) == 4 and shards[1].endswith(".p1")
    for p in shards:
        with open(p) as f:
            for line in f:
                json.loads(line, parse_constant=pytest.fail)  # strict
    replayed = obs[reader].HistoryStore.replay(path)
    assert _feed(replayed) == _feed(live)


def test_torch_gauges_reach_history_as_python_floats(tmp_path):
    """Values read from torch (a loss, the allocator) are converted where
    they are read: the shard holds the same numbers as a float-fed store
    and replays bit for bit."""
    path = str(tmp_path / "h.jsonl")
    clock = FakeClock()
    reg = tobs.Registry()
    loss = reg.gauge("train_loss")
    st = tobs.HistoryStore(reg, clock=clock, persist_path=path)
    vals = torch.tensor([0.1, 1 / 3, 2.5e-8, 7.0], dtype=torch.float32)
    for v in vals:
        loss.set(float(v))
        clock.t += 0.25
        st.sample_now()
    st.close()
    got = [p[1] for p in tobs.HistoryStore.replay(path).query(
        tobs.series_key("train_loss"))["points"]]
    assert got == vals.tolist()
    assert all(type(v) is float for v in got)


POINTS = [(10.0, 20.0), (20.0, 22.0), (40.0, 30.0), (80.0, 45.0),
          (100.0, 140.0)]


def _cap_doc(m):
    return {"points": m.points, "knee": m.knee_qps,
            "per_replica": m.per_replica_qps(),
            "need": [m.replicas_needed(q, headroom=h)
                     for q in (5.0, 68.0, 500.0) for h in (0.85, 1.0)],
            "tight": m.replicas_needed(30.0, objective_ms=21.0),
            "occ": m.occupancy_headroom(), "meta": m.meta,
            "measured_max": m.measured_max_qps}


def test_capacity_model_equal_jax():
    for points, kw in ((POINTS, {"replicas": 2}),
                       ([(10.0, 50.0), (20.0, 80.0)],
                        {"objective_ms": 10.0}), ([], {})):
        assert (_cap_doc(tcap.CapacityModel.fit_from_points(points, **kw))
                == _cap_doc(jcap.CapacityModel.fit_from_points(points,
                                                               **kw)))
    regs = {}
    for name, cap, obs in (("jax", jcap, jobs), ("torch", tcap, tobs)):
        reg = obs.Registry()
        cap.CapacityModel.fit_from_points(POINTS, replicas=2)\
            .register_into(reg)
        regs[name] = reg.snapshot()
    assert regs["torch"] == regs["jax"]


def _ramp_store(obs):
    clock = FakeClock(0.0)
    state = {"done": 0.0, "lat": 0.0, "qps": 10.0, "ms": 10.0}

    def src():
        return [("pool_completed_total", {}, "counter", state["done"]),
                ("pool_latency_seconds_sum", {}, "counter", state["lat"]),
                ("pool_latency_seconds_count", {}, "counter",
                 state["done"]),
                ("pool_batch_occupancy_mean", {}, "gauge", 4.0)]

    st = obs.HistoryStore(None, cadence_s=0.25, clock=clock, sources=[src])
    for i in range(17):
        if i == 8:
            state["qps"], state["ms"] = 40.0, 35.0
        state["done"] += state["qps"] * 0.25
        state["lat"] += state["qps"] * 0.25 * state["ms"] / 1e3
        clock.t += 0.25
        st.sample_now()
    return st


@pytest.mark.parametrize("prefix", ["pool", "serve"])
def test_capacity_fit_from_history_equal_jax(prefix):
    got = tcap.CapacityModel.fit(_ramp_store(tobs), window_s=1.0,
                                 prefix=prefix)
    want = jcap.CapacityModel.fit(_ramp_store(jobs), window_s=1.0,
                                  prefix=prefix)
    assert _cap_doc(got) == _cap_doc(want)
    assert bool(got.points) == (prefix == "pool")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_history_routes_served_from_the_sampler_thread():
    """A started store samples on its own thread; ``/history`` and
    ``/query`` answer over it, and ``close`` joins the sampler."""
    reg = tobs.Registry()
    reg.counter("hits_total").inc(5)
    st = tobs.HistoryStore(reg, cadence_s=0.01).register_into(reg)
    with tobs.MetricsServer(reg, port=0, history=st) as srv:
        st.start()
        try:
            deadline = 200
            while st.doc()["samples"] < 3 and deadline:
                deadline -= 1
                st._stop_evt.wait(0.01)
            code, doc = _get(srv.url + "/history")
            assert code == 200 and doc["sampler_alive"] is True
            assert doc["samples"] >= 3 and "hits_total" in doc["keys"]
            code, q = _get(srv.url + "/query?series=hits_total&limit=2")
            assert code == 200 and q["series"] == "hits_total"
            assert len(q["points"]) == 2
            assert all(v == 5.0 for _, v in q["points"])
            code, q = _get(srv.url + "/query?series=history_samples_total")
            assert code == 200 and not math.isnan(q["points"][-1][1])
        finally:
            st.close()
    assert st.doc()["sampler_alive"] is False
