"""Port parity of the telemetry copies: ``improved_body_parts_torch.obs``
``events``, ``trace`` and ``reqtrace`` against the JAX package's modules.

Each test drives the same call sequence through both packages under one
fake monotonic clock (every read advances it by 1 ms), so the records
must be EQUAL: the strict-JSON event lines, the span trace's events, and
the request trees with their hop waterfalls.
"""
import json
import math
import sys
import threading
import time

import numpy as np
import pytest

from improved_body_parts_torch.obs import events as tevents
from improved_body_parts_torch.obs import reqtrace as treq
from improved_body_parts_torch.obs import trace as ttrace
from improved_body_parts_tpu.obs import events as jevents
from improved_body_parts_tpu.obs import reqtrace as jreq
from improved_body_parts_tpu.obs import trace as jtrace


@pytest.fixture
def fake_clock(monkeypatch):
    """Replace the monotonic and wall clocks with one deterministic
    counter; ``reset()`` starts it over for the second package."""
    state = {"t": 1000.0}

    def tick():
        state["t"] += 0.001
        return state["t"]

    def reset():
        state["t"] = 1000.0

    monkeypatch.setattr(time, "monotonic", tick)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    return reset


def _run_sink(events_mod, path):
    with events_mod.EventSink(str(path), run_meta={"run_id": "r1",
                                                   "model": "tiny"}) as sink:
        sink.emit("step", loss=0.25, arr=np.arange(3),
                  scalar=np.float32(1.5))
        sink.emit("diverged", loss=float("nan"), grad=float("inf"),
                  nested={"v": [float("-inf"), 2]})
    return path.read_text().splitlines()


def test_event_sink_writes_the_same_lines(tmp_path, fake_clock):
    want = _run_sink(jevents, tmp_path / "jax.jsonl")
    fake_clock()
    got = _run_sink(tevents, tmp_path / "port.jsonl")
    assert got == want and len(got) == 3
    for line in got:
        json.loads(line)   # strict JSON: no bare NaN / Infinity tokens
    assert "NaN" not in got[2] and '"nan"' in got[2]
    assert (tevents.read_events(str(tmp_path / "port.jsonl"))
            == jevents.read_events(str(tmp_path / "jax.jsonl")))


@pytest.mark.parametrize("obj", [
    {"a": 1.0, "b": [1, 2]},
    {"loss": float("nan"), "x": [float("inf"), {"y": -math.inf}]},
    {"arr": np.array([1.5, np.nan]), "g": np.int64(3)},
])
def test_strict_dumps_equal(obj, tmp_path):
    assert (tevents.strict_dumps(obj, sort_keys=True)
            == jevents.strict_dumps(obj, sort_keys=True))
    with open(tmp_path / "t.json", "w") as f:
        tevents.strict_dump(obj, f)
    json.loads((tmp_path / "t.json").read_text())


def test_default_sink_install_and_restore(tmp_path):
    assert not tevents.get_sink().enabled
    sink = tevents.EventSink(str(tmp_path / "s.jsonl"))
    prev = tevents.set_sink(sink)
    try:
        assert tevents.get_sink() is sink
    finally:
        assert tevents.set_sink(prev) is sink
        sink.close()
    assert not tevents.get_sink().enabled


def _run_tracer(trace_mod, path):
    rec = trace_mod.TraceRecorder(capacity=8, t0=1000.0)
    with rec.span("render", args={"i": 1}):
        rec.instant("dispatch", track="dispatcher", args={"batch": 2})
    rec.async_begin("request", 7, cat="serve", args={"shape": [4, 4, 3]})
    rec.flow_start("serve_req", 7)
    rec.flow_step("reqpath", 1, cat="reqpath")
    t = rec.now()
    rec.add_span_rel("execute", t, 0.004, track="fetcher",
                     args={"loss": float("nan")})
    rec.flow_finish("serve_req", 7, ts=t)
    rec.add_span_abs("worker", 1000.5, 0.002, track="w0")
    rec.async_end("request", 7, cat="serve", args={"error": False})
    for i in range(3):  # 12 events into a ring of 8: the 4 oldest drop
        rec.instant(f"tick{i}")
    rec.save(str(path))
    return rec


def test_trace_records_the_same_events(tmp_path, fake_clock):
    want = _run_tracer(jtrace, tmp_path / "jax.json")
    fake_clock()
    got = _run_tracer(ttrace, tmp_path / "port.json")
    # through strict JSON: the span args carry a NaN (NaN != NaN)
    assert (tevents.strict_dumps(got.events())
            == jevents.strict_dumps(want.events()))
    assert got.recorded == want.recorded == 8
    assert got.dropped == want.dropped == 4
    exp_got = json.loads((tmp_path / "port.json").read_text())
    exp_want = json.loads((tmp_path / "jax.json").read_text())
    assert exp_got["otherData"] == exp_want["otherData"]
    names = [e["args"]["name"] for e in exp_got["traceEvents"]
             if e["name"] == "process_name"]
    assert names == ["improved_body_parts_torch"]
    assert ([e for e in exp_got["traceEvents"] if e["name"] != "process_name"]
            == [e for e in exp_want["traceEvents"]
                if e["name"] != "process_name"])


def test_null_recorders_are_inert():
    null = ttrace.get_tracer()
    assert not null.enabled and null.events() == []
    with null.span("x"):
        null.instant("y")
    assert treq.get_reqtrace().begin("batcher") is treq.NULL_NODE
    treq.NULL_NODE.finish("ok", hops=[("queue", 1.0)])


class _Collector:
    def __init__(self):
        self.fns = []

    def register_collector(self, fn):
        self.fns.append(fn)


def _run_reqtrace(req_mod, events_mod, trace_mod, path):
    """A root batcher node with one sampled child, an unsampled request,
    an errored request; emitted through a sink and a tracer."""
    sink = events_mod.EventSink(str(path))
    tracer = trace_mod.TraceRecorder(t0=1000.0)
    prev_sink, prev_tr = events_mod.set_sink(sink), trace_mod.set_tracer(
        tracer)
    try:
        rt = req_mod.ReqTrace(sample=2, t0=1000.0)
        reg = _Collector()
        rt.attach_registry(reg)
        skipped = rt.begin("batcher")                 # request 1: unsampled
        root = rt.begin("pool", model="m")            # request 2: sampled
        with root.child_scope("failover", reason="ServerOverloaded") as sc:
            child = rt.begin("batcher", replica=1)
        child.finish("ok", hops=[("queue", 0.001), ("batch_formation", 0.0),
                                 ("device", 0.010), ("decode", 0.002),
                                 ("deliver", 0.0)], replica=1)
        root.finish("ok", hops=[("route", 0.001)], won_by=sc.node)
        rt.begin("batcher")                           # request 3: unsampled
        bad = rt.begin("batcher")                     # request 4: sampled
        bad.finish("error:DeadlineExceeded", hops=[("queue", 0.003)])
        samples = [s for fn in reg.fns for s in fn()]
    finally:
        events_mod.set_sink(prev_sink)
        trace_mod.set_tracer(prev_tr)
        sink.close()
    assert skipped is req_mod.NULL_NODE
    return rt, samples, path.read_text().splitlines(), tracer.events()


def test_reqtrace_records_the_same_trees(tmp_path, fake_clock):
    want = _run_reqtrace(jreq, jevents, jtrace, tmp_path / "jax.jsonl")
    fake_clock()
    got = _run_reqtrace(treq, tevents, ttrace, tmp_path / "port.jsonl")
    rt_got, rt_want = got[0], want[0]
    assert rt_got.records() == rt_want.records()
    assert len(rt_got.records()) == 2 and rt_got.live == 0
    rec = rt_got.records()[0]
    assert rec["chain"] == [rec["nodes"][0]["node"], rec["nodes"][1]["node"]]
    assert rec["nodes"][1]["kind"] == "failover"
    assert rec["nodes"][1]["hops_ms"]["device"] == 10.0
    assert got[1] == want[1]            # registry samples
    assert got[2] == want[2]            # the sink's request events
    assert got[3] == want[3]            # the tracer's reqpath flows
    assert ([json.loads(line)["event"] for line in got[2]]
            == ["run_start", "request", "request"])


def test_reqtrace_is_thread_safe_under_contention():
    """Many threads open and finish sampled requests at once: every tree
    is emitted exactly once, none left live."""
    rt = treq.ReqTrace(sample=1, emit_to_sink=False)
    n_threads, per_thread = 8, 50

    def worker():
        for _ in range(per_thread):
            node = rt.begin("batcher")
            with node.child_scope("retry"):
                child = rt.begin("inner")
            child.finish("ok", hops=[("device", 0.0)])
            node.finish("ok", won_by=child)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert rt.emitted == n_threads * per_thread
    assert rt.live == 0 and rt.dropped == 0
