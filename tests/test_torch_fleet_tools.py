"""The port's fleet tools (``improved_body_parts_torch.cli.{fleet_audit,
trace_report,request_report}``) and the worker telemetry knobs they set,
held to the JAX package on the CPU:

- a live 2-worker ``ProcessRouter`` of ``constant_predictor`` with
  ``telemetry=True`` and ``trace_path=`` writes ``.p1`` / ``.p2`` span
  and sink shards (the sink shards stamped with the parent's ``run_id``);
  the port's and the JAX ``trace_report`` (``tools/trace_report.py``,
  loaded by path) stitch them to the same flow counts and span
  aggregates.  With ``telemetry=False`` only the heartbeat moves and no
  shard is written;
- ``trace_report``: ``stitch_shards`` and ``summarize`` equal the JAX
  functions' on the same synthetic parent and shard files (a shard
  without ``t0_mono`` skipped, a damaged one skipped, a damaged parent
  refused); the JAX package's stitch test run through both CLIs gives
  the same text and the same Perfetto file, with and without
  ``--no-shards``;
- ``request_report``: ``verify`` equals the JAX one on records with an
  orphan, a duplicate node id, a duplicate request id, a chain under
  coverage, a deadline-resolved interior node and the other rules;
  ``--strict`` and ``--no-shards`` behave as the JAX tool's on the same
  streams, and both input forms load;
- ``fleet_audit --predictor constant`` once (module fixture): the JAX
  tool's report keys (read from its source), the conservation, compiles,
  scrape, trace-stitch and chaos gates ok, the overhead verdict equal to
  its rule on the printed per-round numbers (its outcome on a loaded CPU
  is not asserted), the exit code and ``CLI_REPORT`` line following
  ``ok``; ``FLEET_OBS.json`` refused and ``--predictor model`` without a
  card raising, both before any worker process starts.

Workers are spawned processes that import torch (~2 s each here); the
routers start only in module fixtures.
"""
import ast
import contextlib
import importlib.util
import io
import json
import os
import statistics
import sys

import numpy as np
import pytest
import torch

from improved_body_parts_torch.cli import (
    REPORT_PREFIX,
    fleet_audit,
    request_report,
    trace_report,
)
from improved_body_parts_torch.obs.events import (
    EventSink,
    NullSink,
    read_events,
    set_sink,
)
from improved_body_parts_torch.obs.trace import (
    NullTraceRecorder,
    TraceRecorder,
    set_tracer,
)
from improved_body_parts_torch.serve import ProcessRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_trace = _jax_tool("trace_report")
jax_request = _jax_tool("request_report")


def _run(main, argv):
    """(main's return or its SystemExit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            result = main(argv)
        except SystemExit as e:
            result = e.code
    return result, out.getvalue(), err.getvalue()


def _run_jax(main, argv, monkeypatch):
    """The JAX tool's ``main()`` (it parses ``sys.argv``) in-process."""
    monkeypatch.setattr(sys, "argv", ["tool"] + list(argv))
    return _run(lambda _: main(), None)


# --------------------------------------------------------------------- #
# a live 2-worker router with the knobs on and off                      #
# --------------------------------------------------------------------- #
SPEC_KW = {"num_parts": 18, "n_people": 2, "delay_s": 0.003}
REQUESTS = 6


def _router(telemetry, trace_path, sink_path):
    return ProcessRouter(fleet_audit.CONSTANT_SPEC, num_workers=2,
                         spec_kwargs=SPEC_KW, slots=8,
                         max_image_hw=(64, 64), num_parts=18, max_people=8,
                         probe_interval_s=0.05, telemetry=telemetry,
                         trace_path=trace_path, sink_path=sink_path)


def _serve(router, n):
    rng = np.random.default_rng(3)
    futs = [router.submit(rng.integers(0, 255, (48, 48, 3), np.uint8))
            for _ in range(n)]
    return [f.result(timeout=60) for f in futs]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """An ON router (telemetry, trace and sink shards, the parent's sink
    carrying ``run_id``) and an OFF one (``telemetry=False`` with the same
    paths given), their workers started together, ``REQUESTS`` requests
    each; their fleet readouts at quiescence and the files they left."""
    d = str(tmp_path_factory.mktemp("live"))
    paths = {k: os.path.join(d, k) for k in (
        "on_trace.json", "on_events.jsonl", "off_trace.json",
        "off_events.jsonl")}
    sink = EventSink(paths["on_events.jsonl"],
                     run_meta={"run_id": "live-run"})
    tracer = TraceRecorder(capacity=4096, t0=sink.t0)
    prev = set_sink(sink), set_tracer(tracer)
    on = _router(True, paths["on_trace.json"], paths["on_events.jsonl"])
    off = _router(False, paths["off_trace.json"], paths["off_events.jsonl"])
    try:
        on.start()
        set_sink(NullSink())
        off.start()
        on.warmup([(64, 64)])
        off.warmup([(64, 64)])
        set_sink(sink)
        set_tracer(tracer)
        _serve(on, REQUESTS)
        set_sink(NullSink())
        set_tracer(NullTraceRecorder())
        _serve(off, REQUESTS)
        state = {"on": on.fleet_state(), "off": off.fleet_state(),
                 "off_stats": off.worker_stats(),
                 "on_cons": on.fleet.conservation(),
                 "off_cons": off.fleet.conservation()}
    finally:
        on.stop()
        off.stop()
        set_sink(prev[0])
        set_tracer(prev[1])
    tracer.save(paths["on_trace.json"])
    sink.close()
    return {"paths": paths, **state}


def test_on_router_writes_its_shards(live):
    """Worker *i* flushes its span ring to ``<trace_path>.p{i+1}`` (with
    the ``t0_mono`` anchor) and writes its sink shard, whose header
    carries the parent run's ``run_id``."""
    p = live["paths"]
    served = 0
    for i in (1, 2):
        with open(f"{p['on_trace.json']}.p{i}") as f:
            shard = json.load(f)
        assert isinstance(shard["otherData"]["t0_mono"], float)
        names = [e["name"] for e in shard["traceEvents"]]
        served += names.count("serve")
        assert names.count("serve") == names.count("device") \
            == names.count("decode")
        head = read_events(f"{p['on_events.jsonl']}.p{i}")[0]
        assert head["event"] == "run_start"
        assert (head["run_id"], head["role"], head["worker"]) == (
            "live-run", "serve_worker", i - 1)
    assert served == REQUESTS
    assert trace_report.discover_shards(p["on_trace.json"]) == [
        f"{p['on_trace.json']}.p1", f"{p['on_trace.json']}.p2"]


def test_off_router_moves_only_the_heartbeat(live):
    """``telemetry=False``: the workers never publish their block (the
    fleet document reads them unpublished), the heartbeat counts every
    request, conservation falls back to it, and no span or sink shard
    is written although both paths were given."""
    for w in live["off"]["workers"]:
        assert not w["telemetry"]["published"]
    assert all(w["telemetry"]["published"] for w in live["on"]["workers"])
    assert sum(s["served"] for s in live["off_stats"]) == REQUESTS
    assert live["off_cons"]["workers_served"] == REQUESTS
    assert live["off_cons"]["frac"] == live["on_cons"]["frac"] == 1.0
    p = live["paths"]
    for path in (p["off_trace.json"], p["off_events.jsonl"]):
        assert trace_report.discover_shards(path) == []
        assert not os.path.exists(path)


def _stitch(mod, path):
    events, invalid, other = mod._load_events(path)
    shard_events, infos = mod.stitch_shards(other, mod.discover_shards(path))
    return mod.summarize(events + shard_events, other), infos, invalid


def test_live_shards_stitch_as_in_the_jax_tool(live):
    """The port's and the JAX package's ``trace_report`` give the same
    flow counts, span aggregates and shard infos on the live router's
    files; every request is one arc (submit, worker step, deliver)."""
    path = live["paths"]["on_trace.json"]
    got, want = _stitch(trace_report, path), _stitch(jax_trace, path)
    assert got == want
    summary, infos, invalid = got
    assert invalid == 0 and [s["worker"] for s in infos] == [0, 1]
    n = REQUESTS                # the warmup sends no request
    assert summary["proc_flows"] == {"starts": n, "steps": n,
                                     "finishes": n}
    assert summary["by_name"]["serve"]["count"] == n
    assert summary["by_name"]["proc_submit"]["count"] == n


# --------------------------------------------------------------------- #
# trace_report on synthetic files                                       #
# --------------------------------------------------------------------- #
def _write_pair(d, shard_case="anchored", parent_case="anchored"):
    """The JAX package's stitch fixture (``tests/test_fleet.py``): a
    parent ring with one router arc and a worker ring anchored 2 ms
    later, saved as ``trace.json`` / ``trace.json.p1`` (plus a second
    shard per ``shard_case``)."""
    parent = TraceRecorder(capacity=256)
    parent.add_span_rel("proc_submit", 0.001, 0.0005, track="router-w0",
                        args={"slot": 0})
    parent.flow_start("req", 99, track="router-w0", cat="proc", ts=0.0012)
    parent.add_span_rel("proc_deliver", 0.009, 0.0005, track="router-w0")
    parent.flow_finish("req", 99, track="router-w0", cat="proc",
                       ts=0.0092)
    worker = TraceRecorder(capacity=256, t0=parent.t0 + 0.002)
    worker.add_span_rel("serve", 0.001, 0.005, track="worker0-serve")
    worker.flow_step("req", 99, track="worker0-serve", cat="proc",
                     ts=0.003)
    p = os.path.join(d, "trace.json")
    parent.save(p)
    worker.save(p + ".p1")
    if parent_case == "no_t0":
        with open(p) as f:
            doc = json.load(f)
        del doc["otherData"]["t0_mono"]
        with open(p, "w") as f:
            json.dump(doc, f, allow_nan=False)
    if shard_case == "no_t0":
        doc = worker.export()
        del doc["otherData"]["t0_mono"]
        with open(p + ".p3", "w") as f:
            json.dump(doc, f, allow_nan=False)
    elif shard_case == "damaged":
        with open(p + ".p3", "w") as f:
            json.dump({"traceEvents": [{"ph": "X", "name": "x"}]}, f,
                      allow_nan=False)
    elif shard_case == "lossy":
        lossy = TraceRecorder(capacity=2, t0=parent.t0 - 0.001)
        for i in range(5):
            lossy.add_span_rel("serve", 0.001 * i, 0.0005,
                               track="worker2-serve")
        lossy.save(p + ".p3")
    return p


@pytest.mark.parametrize("shard_case,parent_case", [
    ("anchored", "anchored"), ("no_t0", "anchored"),
    ("damaged", "anchored"), ("lossy", "anchored"),
    ("anchored", "no_t0")])
def test_stitch_and_summarize_equal_jax(tmp_path, shard_case, parent_case):
    """Same parent and shards, same ``(events, infos)`` and summary: a
    shard without ``t0_mono`` (or under a parent without it) and a shard
    with no valid event are skipped, a lossy one counted."""
    p = _write_pair(str(tmp_path), shard_case, parent_case)
    outs = []
    for mod in (trace_report, jax_trace):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            events, _, other = mod._load_events(p)
            stitched = mod.stitch_shards(other, mod.discover_shards(p))
            summary = mod.summarize(events + stitched[0], other)
        outs.append((stitched, summary, err.getvalue()))
    assert outs[0] == outs[1]
    (events, infos), summary, err = outs[0]
    if parent_case == "no_t0":
        assert infos == [] and "both exports" in err
        return
    workers = {"anchored": [0], "no_t0": [0], "damaged": [0],
               "lossy": [0, 2]}[shard_case]
    assert [s["worker"] for s in infos] == workers
    assert infos[0]["shift_ms"] == 2.0
    if shard_case in ("no_t0", "damaged"):
        assert "skipping trace shard" in err
    if shard_case == "lossy":
        assert infos[1]["dropped_events"] == 3


@pytest.mark.parametrize("doc", [
    {"otherData": {}},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "pid": 1,
                      "tid": 1, "dur": -1.0}, {"ph": "M"}, 7]},
    [{"name": "a", "ph": "X"}]],
    ids=["no_events_array", "no_valid_event", "bare_list_invalid"])
def test_damaged_trace_is_refused(tmp_path, doc):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        json.dump(doc, f, allow_nan=False)
    msgs = []
    for mod in (trace_report, jax_trace):
        with pytest.raises(SystemExit) as exc:
            mod._load_events(p)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    code, _, _ = _run(trace_report.main, [p])
    assert "refusing to report" in code or "not a Chrome" in code


@pytest.mark.parametrize("flags", [[], ["--no-shards"]],
                         ids=["stitched", "no_shards"])
def test_cli_text_and_perfetto_equal_jax(tmp_path, monkeypatch, flags):
    """The JAX package's stitch test through both CLIs: the same text
    (the stitched shard at +2.0 ms, one arc through the worker) and the
    same normalized Perfetto file; under ``--no-shards`` the shard stays
    out and the arc has no worker step."""
    p = _write_pair(str(tmp_path))
    port_out, jax_out = str(tmp_path / "port.pf.json"), \
        str(tmp_path / "jax.pf.json")
    summary, text, _ = _run(trace_report.main, [p, "--out", port_out,
                                                 "--json", str(tmp_path / "s.json")]
                            + flags)
    _, jtext, _ = _run_jax(jax_trace.main, [p, "--out", jax_out] + flags,
                           monkeypatch)
    assert text.replace(port_out, "OUT") == jtext.replace(jax_out, "OUT")
    with open(port_out) as f, open(jax_out) as g:
        assert json.load(f) == json.load(g)
    with open(tmp_path / "s.json") as f:
        assert json.load(f) == summary
    if flags:
        assert summary["shards"] == [] and "stitched worker" not in text
        assert summary["proc_flows"] == {"starts": 1, "steps": 0,
                                         "finishes": 1}
    else:
        assert "stitched worker shards: worker 0" in text
        assert "+2.0 ms" in text
        assert ("cross-process flow arcs: 1 submits → 1 worker serves → "
                "1 delivers") in text


def test_default_perfetto_path_strips_only_a_trailing_json(tmp_path):
    p = _write_pair(str(tmp_path))
    summary, _, _ = _run(trace_report.main, [p])
    assert summary["perfetto"] == p[:-5] + ".perfetto.json"
    assert os.path.exists(summary["perfetto"])
    shard = p + ".p1"
    summary, _, _ = _run(trace_report.main, [shard, "--no-shards"])
    assert summary["perfetto"] == shard + ".perfetto.json"


# --------------------------------------------------------------------- #
# request_report                                                        #
# --------------------------------------------------------------------- #
def _node(node, parent=None, comp="pool", kind="submit", won_by=None,
          status="OK", hops=None, dur=10.0):
    return {"node": node, "parent": parent, "comp": comp, "kind": kind,
            "t0_ms": 0.0, "dur_ms": dur, "status": status,
            "won_by": won_by, "hops_ms": hops or {}}


def _rec(req, nodes, e2e=10.0):
    return {"event": "request", "req": req, "e2e_ms": e2e, "status": "OK",
            "hop_coverage": 1.0, "chain": [n["node"] for n in nodes],
            "nodes": nodes}


def _good(req="r1"):
    return _rec(req, [
        _node(f"{req}-root", won_by=f"{req}-leaf", hops={"queue": 1.0}),
        _node(f"{req}-leaf", parent=f"{req}-root", comp="batcher",
              hops={"device": 8.0, "deliver": 1.0})])


RECORD_CASES = {
    "complete": ([_good("a"), _good("b")], None),
    "orphan": ([_rec("o", [
        _node("o-root", won_by="o-leaf", hops={"queue": 10.0}),
        _node("o-leaf", parent="o-root"),
        _node("o-stray", parent="gone")])], "orphan node"),
    "duplicate_node": ([_rec("d", [
        _node("d-root", won_by="d-leaf", hops={"queue": 10.0}),
        _node("d-leaf", parent="d-root"),
        _node("d-leaf", parent="d-root", kind="hedge")])],
        "duplicate node id"),
    "duplicate_request": ([_good("same"), _good("same")],
                          "duplicate request id"),
    "under_coverage": ([_rec("c", [
        _node("c-root", won_by="c-leaf", hops={"queue": 1.0}),
        _node("c-leaf", parent="c-root", hops={"device": 2.0})],
        e2e=10.0)], "chain hops cover"),
    "deadline_interior": ([_rec("dl", [
        _node("dl-root", status="error:DeadlineExceeded",
              hops={"queue": 10.0}),
        _node("dl-child", parent="dl-root", status="ok")])], None),
    "interior_end": ([_rec("ie", [
        _node("ie-root", hops={"queue": 10.0}),
        _node("ie-child", parent="ie-root")])],
        "chain ends at interior node"),
    "won_by_missing": ([_rec("w", [
        _node("w-root", won_by="nobody", hops={"queue": 10.0})])],
        "not in tree"),
    "cycle": ([_rec("cy", [
        _node("cy-root", won_by="cy-a", hops={"queue": 10.0}),
        _node("cy-a", parent="cy-root", won_by="cy-b"),
        _node("cy-b", parent="cy-a", won_by="cy-a")])], "won_by cycle"),
    "two_roots": ([_rec("tr", [_node("tr-1"), _node("tr-2")])],
                  "2 roots"),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_verify_equals_jax(case):
    records, problem = RECORD_CASES[case]
    got = request_report.verify(records)
    assert got == jax_request.verify(records)
    assert got["complete"] == (problem is None)
    if problem is not None:
        assert any(problem in p for v in got["violations"]
                   for p in v["problems"])
    assert request_report.render_tree(records[0]) == \
        jax_request.render_tree(records[0])
    assert request_report.slowest(records, 1) == \
        jax_request.slowest(records, 1)


def test_verify_all_records_together_equals_jax():
    records = [r for recs, _ in RECORD_CASES.values() for r in recs]
    for cov in (0.5, request_report.MIN_COVERAGE, 0.999):
        got = request_report.verify(records, cov)
        assert got == jax_request.verify(records, cov)
    assert got["orphan_nodes"] == 1 and got["duplicate_nodes"] == 1
    assert got["duplicate_requests"] == 1


def _jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, allow_nan=False) + "\n")


def _run_start(run_id, **kw):
    return {"event": "run_start", "schema": 1, "t": 0.0,
            "run_id": run_id, **kw}


@pytest.mark.parametrize("flags,n", [
    (["--strict"], 2), (["--no-shards"], 1),
    (["--strict", "--no-shards", "--top", "1"], 1)],
    ids=["strict", "no_shards", "strict_no_shards"])
def test_shards_strict_and_no_shards_as_jax(tmp_path, monkeypatch, flags,
                                            n):
    """The JAX package's shard test: a matching shard's records join, a
    stale one (another ``run_id``) is skipped loudly; the same text as
    the JAX tool's."""
    p = str(tmp_path / "events.jsonl")
    _jsonl(p, [_run_start("run-a"), _good("r1")])
    _jsonl(p + ".p1", [_run_start("run-a", worker=0), _good("r2")])
    _jsonl(p + ".p2", [_run_start("run-stale", worker=1), _good("r3")])
    got, text, err = _run(request_report.main, [p] + flags)
    jcode, jtext, jerr = _run_jax(jax_request.main, [p] + flags,
                                  monkeypatch)
    assert (text, err) == (jtext, jerr)
    assert f"{n} request records" in text
    assert ("skipping stale shard" in err) == ("--no-shards" not in flags)
    assert got["requests"] == n and got["complete"]
    assert jcode is None        # a complete stream exits 0 either way


@pytest.mark.parametrize("form", ["jsonl", "records_json", "bare_list"])
def test_strict_exits_one_on_a_violation(tmp_path, monkeypatch, form):
    """Both input forms (and a bare list): a stream with an orphan exits
    1 under ``--strict``, 0 without it, as the JAX tool does."""
    records = RECORD_CASES["orphan"][0] + [_good("ok")]
    p = str(tmp_path / ("e.jsonl" if form == "jsonl" else "e.json"))
    if form == "jsonl":
        _jsonl(p, [_run_start("x")] + records)
    else:
        with open(p, "w") as f:
            json.dump({"records": records} if form == "records_json"
                      else records, f, allow_nan=False)
    assert request_report.load_records(p) == jax_request.load_records(p)
    for flags, want in ((["--strict"], 1), ([], None)):
        got, text, err = _run(request_report.main, [p] + flags)
        jgot, jtext, jerr = _run_jax(jax_request.main, [p] + flags,
                                     monkeypatch)
        assert (text, err) == (jtext, jerr) and "VIOLATION" in err
        assert jgot == want
        assert got == want if want is not None else got["orphan_nodes"] == 1


def test_empty_and_listless_inputs_refused(tmp_path):
    p = str(tmp_path / "none.jsonl")
    _jsonl(p, [_run_start("x")])
    code, _, _ = _run(request_report.main, [p])
    assert "0 request records" in code
    q = str(tmp_path / "doc.json")
    with open(q, "w") as f:
        json.dump({"summary": {}}, f, allow_nan=False)
    with pytest.raises(SystemExit, match="no 'records' list"):
        request_report.load_records(q)


# --------------------------------------------------------------------- #
# fleet_audit                                                           #
# --------------------------------------------------------------------- #
def _jax_report_keys():
    """The keys of ``tools/fleet_audit.py``'s report and of each of its
    sections, read from the JAX tool's source: ``report[k] = {...}``."""
    with open(os.path.join(REPO, "tools", "fleet_audit.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "report"):
            k = node.targets[0].slice.value
            keys[k] = ({kk.value for kk in node.value.keys
                        if isinstance(kk, ast.Constant)}
                       if isinstance(node.value, ast.Dict) else None)
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "report"
                and isinstance(node.value, ast.Dict)):
            for kk, vv in zip(node.value.keys, node.value.values):
                keys[kk.value] = ({x.value for x in vv.keys}
                                  if isinstance(vv, ast.Dict) else None)
    return keys


AUDIT_ARGV = ["--predictor", "constant", "--rounds", "1", "--requests",
              "4", "--clients", "2", "--keep-workdir"]


@pytest.fixture(scope="module")
def audit_run(tmp_path_factory):
    """``fleet_audit.main`` once: (exit code, report, stdout)."""
    out = str(tmp_path_factory.mktemp("audit") / "fleet_obs_torch.json")
    code, stdout, _ = _run(fleet_audit.main, AUDIT_ARGV + ["--out", out])
    with open(out) as f:
        report = json.load(f)
    return (code if not isinstance(code, dict) else 0), report, stdout


def test_audit_report_has_the_jax_keys(audit_run):
    _, report, _ = audit_run
    jax_keys = _jax_report_keys()
    assert {"overhead", "conservation", "compiles", "scrape",
            "trace_stitch", "chaos", "protocol", "ok"} <= set(jax_keys)
    assert set(jax_keys) | {"workdir"} <= set(report)
    for section, keys in jax_keys.items():
        if keys:
            assert keys <= set(report[section]), section
    assert {"router_submitted", "workers_served", "in_flight",
            "frac"} <= set(report["conservation"])
    assert report["protocol"]["off_arm"].startswith("explicit NullSink")


@pytest.mark.parametrize("gate", ["conservation", "compiles", "scrape",
                                  "trace_stitch", "chaos"])
def test_audit_gates_hold(audit_run, gate):
    _, report, _ = audit_run
    assert report[gate]["ok"], report[gate]


def test_audit_gate_details(audit_run):
    _, report, _ = audit_run
    assert report["conservation"]["frac"] == 1.0
    assert report["scrape"]["families_missing"] == []
    assert report["scrape"]["fleet_route_workers"] == 2
    assert len(report["trace_stitch"]["shards"]) == 2
    pf = report["trace_stitch"]["proc_flows"]
    assert pf["starts"] == pf["steps"] == pf["finishes"] > 0
    pm = report["chaos"]["postmortem"]
    assert pm["pid"] == report["chaos"]["killed_pid"]
    assert pm["in_flight"], "the kill landed on no request"
    assert sum(report["chaos"]["futures_resolved"].values()) == 6
    # the A/B's two ON workers stopped after serving; the chaos router's
    # killed worker never reached its stop
    on = [g for g in report["worker_generations"]
          if g["shard"].startswith("events.jsonl")]
    assert len(on) == 2 and all(g["stopped"] and g["served"] > 0
                                for g in on)
    assert not next(g for g in report["worker_generations"]
                    if g["pid"] == report["chaos"]["killed_pid"])["stopped"]
    assert report["worker_launches_after_warmup"] == {
        k: 0 for k in fleet_audit.DECODE_KERNELS}


def test_audit_overhead_verdict_is_its_rule(audit_run):
    """The verdict is ``median < 2.0`` of the per-round overheads, and
    those come from the printed per-round imgs/s (not asserted: the
    verdict itself, which a loaded CPU decides)."""
    _, report, stdout = audit_run
    ov = report["overhead"]
    rounds = [ln.split() for ln in stdout.splitlines()
              if ln.startswith("round ")]
    on = [float(r[3]) for r in rounds]
    off = [float(r[6]) for r in rounds]
    assert (on, off) == (ov["on_imgs_per_sec"], ov["off_imgs_per_sec"])
    per = [round((b - a) / b * 100.0, 3) for a, b in zip(on, off)]
    assert per == ov["per_round_overhead_pct"]
    med = round(statistics.median(per), 3)
    assert med == ov["paired_median_overhead_pct"]
    assert ov["ok"] == (med < fleet_audit.OVERHEAD_GATE_PCT == 2.0)


def test_audit_exit_code_follows_ok(audit_run):
    code, report, stdout = audit_run
    assert report["ok"] == all(report[k]["ok"] for k in (
        "overhead", "conservation", "compiles", "scrape", "trace_stitch",
        "chaos"))
    assert code == (0 if report["ok"] else 1)
    last = stdout.strip().splitlines()[-1]
    assert last.startswith(REPORT_PREFIX)
    cli = json.loads(last[len(REPORT_PREFIX):])
    assert (cli["cli"], cli["device"], cli["ok"]) == (
        "fleet_audit", "cpu", report["ok"])


def test_audit_workdir_reports_through_trace_report(audit_run):
    """The kept workdir's trace and its two worker shards through the
    port's CLI, and the JAX tool's functions, alike."""
    _, report, _ = audit_run
    path = os.path.join(report["workdir"], "trace.json")
    summary, text, _ = _run(trace_report.main, [path])
    assert len(summary["shards"]) == 2
    assert os.path.exists(summary["perfetto"])
    assert summary["proc_flows"] == report["trace_stitch"]["proc_flows"]
    assert _stitch(trace_report, path) == _stitch(jax_trace, path)


class _Reached(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--out", "FLEET_OBS.json"],
    ["--predictor", "constant", "--out", "FLEET_OBS.json"],
    ["--predictor", "constant", "--out", "sub/FLEET_OBS.json"]],
    ids=["model", "constant", "in_a_directory"])
def test_jax_artifact_refused_before_any_process(monkeypatch, tmp_path,
                                                 argv):
    def reached(*a, **k):
        raise _Reached
    monkeypatch.setattr(fleet_audit, "audit", reached)
    monkeypatch.setattr(ProcessRouter, "start", reached)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="FLEET_OBS.json is the JAX"):
        fleet_audit.main(argv)
    assert not os.path.exists(tmp_path / "FLEET_OBS.json")


def test_model_predictor_without_a_card_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU refusal is not reachable")

    def reached(*a, **k):
        raise _Reached
    monkeypatch.setattr(ProcessRouter, "start", reached)
    out = str(tmp_path / "f.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_audit.main(["--out", out])
    assert not os.path.exists(out)


def test_worker_generations_subtract_the_warmup(tmp_path):
    """A generation's launches and requests after its last warmup; one
    never warmed counts from its start; one killed before its stop has
    no counts; a shard that was never written is skipped."""
    def launches(n):
        return {k: n for k in fleet_audit.DECODE_KERNELS}

    p1, p2 = str(tmp_path / "e.jsonl.p1"), str(tmp_path / "e.jsonl.p2")
    _jsonl(p1, [_run_start("r"), {"event": "worker_start", "pid": 11},
                {"event": "worker_warm", "served": 1,
                 "kernel_launches": launches(3)},
                {"event": "worker_stop", "served": 6,
                 "kernel_launches": launches(8)},
                _run_start("r"), {"event": "worker_start", "pid": 12}])
    _jsonl(p2, [_run_start("r"), {"event": "worker_start", "pid": 13},
                {"event": "worker_stop", "served": 4,
                 "kernel_launches": launches(4)}])
    gens = fleet_audit.worker_generations(
        [p1, p2, str(tmp_path / "e.jsonl.p3")])
    assert [(g["pid"], g["stopped"], g.get("served"), g.get("launches"))
            for g in gens] == [(11, True, 5, launches(5)),
                               (12, False, None, None),
                               (13, True, 4, launches(4))]


def test_router_kwargs_of_each_predictor():
    """The constant predictor keeps the JAX tool's wire and lifecycle;
    the model builds ``checkpoint_predictor`` from a JSON spec with a
    17-part wire."""
    args = fleet_audit._parser().parse_args(["--predictor", "constant"])
    kw = fleet_audit.router_kwargs(args)
    assert (kw["spec_kwargs"]["delay_s"], kw["slots"], kw["max_image_hw"],
            kw["num_parts"], kw["max_people"]) == (
        fleet_audit.DELAY_S, 8, (64, 64), 18, 8)
    assert fleet_audit.router_kwargs(args, chaos=True)["spec_kwargs"][
        "delay_s"] == 0.2
    args = fleet_audit._parser().parse_args([])
    kw = fleet_audit.router_kwargs(args)
    assert kw["spec"] == fleet_audit.MODEL_SPEC
    assert kw["spec_kwargs"] == {"config": "canonical", "checkpoint": None,
                                 "params_dtype": "fp32", "boxsize": 256,
                                 "seed": 0, "device": "cuda"}
    assert (kw["max_image_hw"], kw["num_parts"]) == ((256, 256), 17)
    # the chaos round's router is the JAX tool's under either predictor
    assert fleet_audit.router_kwargs(args, chaos=True) == \
        fleet_audit.router_kwargs(
            fleet_audit._parser().parse_args(["--predictor", "constant"]),
            chaos=True)
    assert (args.rounds, args.clients, args.requests, args.out) == (
        6, 4, 50, "fleet_obs_torch.json")
    quick = fleet_audit._parser().parse_args(["--quick"])
    assert quick.quick
