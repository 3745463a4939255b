"""The port's offline telemetry readers
(``improved_body_parts_torch.cli.{telemetry_report,history_report}``)
held to the JAX package's ``tools/telemetry_report.py`` and
``tools/history_report.py`` (loaded by path) on the same files:

- ``telemetry_report.summarize`` on a stream the port's ``RunTelemetry``
  writes during a tiny CPU ``cli.train.train`` (with a ``HistoryStore``
  persisting beside it), and on the JAX tests' synthetic streams
  (compute- and input-bound runs with a first run after warmup, stacked
  runs, a future schema, same-run segments, a plain run): the summaries
  are equal (``==``, no tolerance: both tools do the same float
  arithmetic on the same parsed numbers);
- ``summarize_shard`` / ``summarize_history`` on ``.pN`` worker shards
  (one stale) and history companions (one stale), with the same loud
  stderr notes; ``main`` writes the same ``--json`` summary and the same
  text but for the port's wording of first runs and its tool names;
- ``history_report.verify_history`` and ``summarize`` on shards the
  port's ``HistoryStore`` wrote, healthy and tampered (a missing shard
  number, a non-increasing time, an undeclared key, a persisted gap that
  cannot be re-detected, a header that disagrees, an empty shard, no
  shard): ``(ok, problems, stats)`` equal; ``--strict`` exits 1 on an
  incomplete stream and 0 on a whole one, as the JAX tool does.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys

import pytest
import torch

import improved_body_parts_torch.obs as tobs
from improved_body_parts_torch.cli import (
    REPORT_PREFIX,
    history_report,
    telemetry_report,
)
from improved_body_parts_torch.obs.events import EventSink, strict_dumps

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tele = _jax_tool("telemetry_report")
jax_hist = _jax_tool("history_report")


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


def _strip_report(text):
    """The text without the port's closing ``CLI_REPORT`` line."""
    lines = text.rstrip("\n").split("\n")
    assert lines[-1].startswith(REPORT_PREFIX)
    return "\n".join(lines[:-1]) + "\n"


#: the JAX tool's wording -> the port's: the port's "recompile" events
#: are a predictor's first runs, and its tools are ``cli`` modules
REWORDS = (
    ("recompiles: warmup never marked", "first runs: warmup never marked"),
    ("recompiles after warmup: ", "first runs after warmup: "),
    (" — each one is a silent pipeline stall:",
     " — each a lane shape the warmup missed, a stall on the path:"),
    ("(tools/feed_rate.py sizes them, TRAINING.md 5b)",
     "(cli.feed_rate sizes them)"),
    ("(tools/train_bench.py / perf_audit.py)",
     "(cli.train_bench / cli.perf_audit)"),
    ("(tools/history_report.py renders it)", "(cli.history_report renders it)"),
)


def _reworded(text):
    for a, b in REWORDS:
        text = text.replace(a, b)
    return text


def _jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, allow_nan=False) + "\n")


# --------------------------------------------------------------------- #
# a stream the port writes: a tiny fit under RunTelemetry + history     #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fit_stream(tmp_path_factory):
    """``cli.train.train`` of ``tiny`` for one epoch on the CPU under
    ``obs.RunTelemetry`` (one step window a step) with an
    ``obs.HistoryStore`` persisting next to the events; returns (events
    path, the run's report, the store's sample count)."""
    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.data.fixture import fixture_records

    d = tmp_path_factory.mktemp("fit")
    sink = str(d / "events.jsonl")
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(d / "ck"), print_freq=1,
        keep_last_n=1))
    records = fixture_records(num_images=4, people_per_image=1,
                              image_size=128, seed=3, drawn=True)
    reg = tobs.Registry()
    store = tobs.HistoryStore(reg, cadence_s=0.05,
                              persist_path=tobs.history_path_for(sink),
                              run_id="fit-1")
    with tobs.RunTelemetry(sink, registry=reg, history=store, device="cpu",
                           run_meta={"tool": "train", "config": "tiny",
                                     "run_id": "fit-1"}) as tele:
        _, run = train(cfg, MemoryDataset(records, cfg, seed=0), 1,
                       device=torch.device("cpu"), log_fn=lambda s: None,
                       telemetry=tele)
    return sink, run, store.doc()["samples"]


def test_fit_stream_summary_equals_jax(fit_stream):
    sink, run, _ = fit_stream
    events = tobs.read_events(sink)
    got = telemetry_report.summarize(events)
    assert got == jax_tele.summarize(events)
    assert got["windows"] == run["steps"] > 0
    assert got["run_id"] == "fit-1" and got["run"]["tool"] == "train"
    assert got["verdict"] in ("input-bound", "mixed (input pressure)",
                              "compute-bound")
    assert got["attribution"]["compute_s"] > 0
    assert len(got["epochs"]) == 1


def test_fit_history_companion_equals_jax(fit_stream):
    sink, _, samples = fit_stream
    got = telemetry_report.summarize_history(sink, "fit-1")
    assert got == jax_tele.summarize_history(sink, "fit-1")
    assert got["ticks"] == samples > 0 and got["run_id"] == "fit-1"
    ok, problems, stats = history_report.verify_history(
        tobs.history_path_for(sink))
    assert ok, problems
    assert stats["ticks"] == samples


def test_fit_stream_cli_equals_jax(fit_stream, tmp_path, monkeypatch):
    sink, _, _ = fit_stream
    mine, theirs = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got, text, err = _run(telemetry_report.main, [sink, "--json", mine])
    jgot, jtext, jerr = _run_jax(jax_tele.main, [sink, "--json", theirs],
                                 monkeypatch)
    assert jgot is None and isinstance(got, dict)
    with open(mine) as f, open(theirs) as g:
        assert json.load(f) == json.load(g) == json.loads(
            strict_dumps(got))
    assert got["history"]["ticks"] > 0
    body = _strip_report(text)
    assert body.replace(mine, theirs) == _reworded(jtext) and err == jerr
    line = json.loads(text.strip().splitlines()[-1][len(REPORT_PREFIX):])
    assert line["cli"] == "telemetry_report" and line["device"] == "cpu"
    assert line["windows"] == got["windows"]


# --------------------------------------------------------------------- #
# the JAX tests' synthetic streams                                      #
# --------------------------------------------------------------------- #
def _write_stream(path, wait, hold, recompile=False):
    """``tests/test_obs.py``'s stream: 4 step windows, warmup, an
    optional first run after it, one epoch."""
    with EventSink(path, run_meta={"tool": "t", "config": "c"}) as s:
        for i in range(4):
            s.emit("train_step", epoch=0, step=(i + 1) * 10, loss=1.0,
                   loss_avg=1.0, step_s=0.1, imgs_per_sec=40.0,
                   data_wait_s=wait / 4, compute_s=hold / 4)
        s.emit("warmup_complete", label="t")
        if recompile:
            s.emit("recompile", duration_s=2.5, source="predictor")
        s.emit("epoch", epoch=0, train_loss=1.0, val_loss=2.0)


def _compute_bound(p):
    _write_stream(p, wait=0.02, hold=0.38)


def _input_bound(p):
    _write_stream(p, wait=0.3, hold=0.1, recompile=True)


def _stacked(p):
    _write_stream(p, wait=0.3, hold=0.1, recompile=True)
    _write_stream(p, wait=0.02, hold=0.38)


def _no_warmup(p):
    with EventSink(p, run_meta={"tool": "t"}) as s:
        s.emit("train_step", step_s=0.2, imgs_per_sec=10.0)


def _many_first_runs(p):
    with EventSink(p, run_meta={"tool": "serve"}) as s:
        s.emit("warmup_complete", label="w")
        for i in range(23):
            s.emit("recompile", duration_s=0.01 * i, source="predictor")
        s.emit("serve_snapshot", depth=0)
        s.emit("timed", name="x", seconds=0.1)


STREAMS = {"compute_bound": _compute_bound, "input_bound": _input_bound,
           "stacked": _stacked, "no_warmup": _no_warmup,
           "many_first_runs": _many_first_runs}


@pytest.mark.parametrize("case", list(STREAMS))
def test_synthetic_stream_equals_jax(tmp_path, monkeypatch, case):
    p = str(tmp_path / "ev.jsonl")
    STREAMS[case](p)
    events = tobs.read_events(p)
    got = telemetry_report.summarize(events)
    assert got == jax_tele.summarize(events)
    _, text, err = _run(telemetry_report.main, [p])
    _, jtext, jerr = _run_jax(jax_tele.main, [p], monkeypatch)
    assert _strip_report(text) == _reworded(jtext) and err == jerr
    if case == "compute_bound":
        assert got["verdict"] == "compute-bound" and got["windows"] == 4
        assert got["attribution"]["data_wait_frac"] == 0.05
        assert got["recompiles_post_warmup"] == 0
        assert "first runs after warmup: 0" in text
    elif case == "input_bound":
        assert got["verdict"] == "input-bound"
        assert got["recompiles_post_warmup"] == 1
        assert got["recompile_timeline"][0]["duration_s"] == 2.5
        assert got["epochs"][-1]["val_loss"] == 2.0
        assert "first runs after warmup: 1" in text
        assert "recompiles after warmup" in jtext
    elif case == "stacked":
        assert got["previous_runs_in_file"] == 1 and got["windows"] == 4
        assert got["verdict"] == "compute-bound"
        assert got["recompiles_post_warmup"] == 0 and "earlier run" in text
    elif case == "no_warmup":
        assert got["warmup_complete_t"] is None
        assert "first runs: warmup never marked" in text
    else:
        assert got["recompiles_post_warmup"] == 23
        assert got["serve_events"] == 1 and got["timed_spans"] == 1
        assert "... 3 more" in text


def test_future_schema_refused_as_jax(tmp_path):
    p = str(tmp_path / "ev.jsonl")
    _jsonl(p, [{"event": "run_start", "schema": tobs.SCHEMA_VERSION + 1,
                "t": 0.0}])
    events = tobs.read_events(p)
    with pytest.raises(SystemExit, match="schema") as mine:
        telemetry_report.summarize(events)
    with pytest.raises(SystemExit, match="schema") as theirs:
        jax_tele.summarize(events)
    assert str(mine.value) == str(theirs.value)


def test_empty_stream_refused(tmp_path):
    p = str(tmp_path / "ev.jsonl")
    open(p, "w").close()
    code, _, _ = _run(telemetry_report.main, [p])
    assert "no events parsed" in code


def _run_start(seg, rid="run-abc"):
    return {"event": "run_start", "schema": tobs.SCHEMA_VERSION,
            "run_id": rid, "segment": seg, "time_unix": seg}


#: ``tests/test_supervisor.py``'s same-run segments and plain run
SEGMENTS = [
    # an UNRELATED earlier run in the same file: not stitched
    {"event": "run_start", "schema": 1, "run_id": "run-old", "segment": 0},
    {"event": "train_step", "step_s": 9.0, "imgs_per_sec": 1.0},
    # segment 0 of the elastic run: fresh, dies mid-epoch-1
    _run_start(0),
    {"event": "segment_start", "previous_end": "fresh", "backoff_s": 0},
    {"event": "train_step", "step_s": 1.0, "imgs_per_sec": 8.0},
    {"event": "epoch", "epoch": 0, "train_loss": 1.0},
    # segment 1: killed -> resumed from epoch 0, completes
    _run_start(1),
    {"event": "segment_start", "previous_end": "killed", "backoff_s": 0.1},
    {"event": "resume", "found": True, "epoch": 0},
    {"event": "resume_eval", "epoch": 0, "loss": 0.625},
    {"event": "train_step", "step_s": 1.0, "imgs_per_sec": 8.0},
    {"event": "epoch", "epoch": 1, "train_loss": 0.5},
    {"event": "segment_end", "status": "completed", "epoch_committed": 1},
]
PLAIN = [{"event": "run_start", "schema": 1},
         {"event": "train_step", "step_s": 1.0, "imgs_per_sec": 4.0}]


def test_same_run_segments_stitch_as_jax(tmp_path, monkeypatch):
    s = telemetry_report.summarize(SEGMENTS)
    assert s == jax_tele.summarize(SEGMENTS)
    assert s["run_id"] == "run-abc" and s["previous_runs_in_file"] == 1
    assert s["windows"] == 2 and len(s["epochs"]) == 2
    segs = s["segments"]
    assert [g["segment"] for g in segs] == [0, 1]
    assert segs[0]["previous_end"] == "fresh"
    assert segs[0]["end"] == "died (no segment_end)"
    assert segs[1]["previous_end"] == "killed"
    assert segs[1]["resumed_from"] == 0
    assert segs[1]["resume_eval_loss"] == 0.625
    assert segs[1]["end"] == "completed"
    p = str(tmp_path / "ev.jsonl")
    _jsonl(p, SEGMENTS)
    _, text, _ = _run(telemetry_report.main, [p])
    _, jtext, _ = _run_jax(jax_tele.main, [p], monkeypatch)
    assert _strip_report(text) == _reworded(jtext)
    assert "2 segments stitched" in text


def test_plain_run_unchanged_as_jax():
    s = telemetry_report.summarize(PLAIN)
    assert s == jax_tele.summarize(PLAIN)
    assert s["segments"] is None and s["windows"] == 1


# --------------------------------------------------------------------- #
# worker shards and history companions                                 #
# --------------------------------------------------------------------- #
def _fleet_start(run_id, **kw):
    return {"event": "run_start", "schema": 1, "t": 0.0, "time_unix": 0.0,
            "pid": 1, "run_id": run_id, **kw}


def _shards(p):
    """``tests/test_fleet.py``'s files: a primary stream of run-a, a
    matching worker shard, a stale one, and a numbering hole (.p4)."""
    _jsonl(p, [_fleet_start("run-a", tool="serve")])
    _jsonl(p + ".p1", [
        _fleet_start("run-a", role="serve_worker", worker=0, pid=77),
        {"event": "worker_start", "t": 0.1, "worker": 0},
        {"event": "worker_stop", "t": 1.0, "worker": 0, "served": 12}])
    _jsonl(p + ".p2", [_fleet_start("run-stale", role="serve_worker",
                                    worker=1)])
    _jsonl(p + ".p4", [_fleet_start("run-a", role="serve_worker",
                                    worker=3, pid=79)])


def _history(path, run_id, ticks=6):
    """A port HistoryStore's shards at ``path`` on a fake clock."""
    clock = _FakeClock()
    reg = tobs.Registry()
    c = reg.counter("serve_completed_total")
    st = tobs.HistoryStore(reg, cadence_s=0.25, clock=clock,
                           persist_path=path, shard_records=4,
                           run_id=run_id)
    for i in range(ticks):
        c.inc()
        clock.t += 2.0 if i == 3 else 0.25
        st.sample_now()
    st.close()
    return st


class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("hist_run", [None, "run-a", "run-stale", "none"],
                         ids=["no_history", "history", "stale_history",
                              "history_without_run_id"])
@pytest.mark.parametrize("flags", [[], ["--no-shards"]],
                         ids=["shards", "no_shards"])
def test_shards_and_history_as_jax(tmp_path, monkeypatch, hist_run, flags):
    p = str(tmp_path / "events.jsonl")
    _shards(p)
    if hist_run is not None:
        _history(tobs.history_path_for(p),
                 None if hist_run == "none" else hist_run)
    assert (telemetry_report.discover_shards(p)
            == jax_tele.discover_shards(p) == [p + ".p1", p + ".p2",
                                               p + ".p4"])
    for sp in telemetry_report.discover_shards(p):
        assert (telemetry_report.summarize_shard(sp, "run-a")
                == jax_tele.summarize_shard(sp, "run-a"))
    assert (telemetry_report.summarize_history(p, "run-a")
            == jax_tele.summarize_history(p, "run-a"))
    mine, theirs = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got, text, err = _run(telemetry_report.main,
                          [p, "--json", mine] + flags)
    _, jtext, jerr = _run_jax(jax_tele.main, [p, "--json", theirs] + flags,
                              monkeypatch)
    with open(mine) as f, open(theirs) as g:
        assert json.load(f) == json.load(g)
    assert _strip_report(text).replace(mine, theirs) == _reworded(jtext)
    assert err == jerr
    if flags:
        assert "worker_shards" not in got and "history" not in got
        return
    assert [s["worker"] for s in got["worker_shards"]] == [0, 3]
    assert got["worker_shards"][0]["served"] == 12
    assert not got["worker_shards"][1]["clean_stop"]
    assert "skipping stale shard" in err and "run-stale" in err
    if hist_run in ("run-a", "none"):
        assert got["history"]["ticks"] == 6 and got["history"]["gaps"] == 1
        assert "cli.history_report renders it" in text
    else:
        assert "history" not in got
        assert ("skipping stale history" in err) == (hist_run == "run-stale")


# --------------------------------------------------------------------- #
# history_report                                                        #
# --------------------------------------------------------------------- #
@pytest.fixture
def healthy(tmp_path):
    """``tests/test_history.py``'s verifier seed, written by the port's
    store: 9 ticks with one blackout, 4 records a shard (3 shards)."""
    clock = _FakeClock()
    reg = tobs.Registry()
    c = reg.counter("done_total")
    path = str(tmp_path / "h" / "h.jsonl")
    os.makedirs(os.path.dirname(path))
    st = tobs.HistoryStore(reg, cadence_s=0.25, clock=clock,
                           persist_path=path, shard_records=4, run_id="vr")
    for i in range(9):
        c.inc()
        clock.t += 2.0 if i == 4 else 0.25
        st.sample_now()
    st.close()
    return path


def _append(path, rec):
    with open(path, "a") as f:
        f.write(strict_dumps(rec) + "\n")


def _last_t(path):
    return tobs.read_events(path)[-1]["t"]


def _drop_middle_shard(path):
    os.rename(path + ".p1", path + ".p1.bak")


def _non_increasing(path):
    _append(path + ".p2", {"event": "history_sample",
                           "t": _last_t(path + ".p2"),
                           "v": {"done_total": 1.0}})


def _undeclared(path):
    _append(path + ".p2", {"event": "history_sample",
                           "t": _last_t(path + ".p2") + 0.25,
                           "v": {"ghost": 1.0}})


def _phantom_gap(path):
    _append(path + ".p1", {"event": "history_gap", "t": 101.0,
                           "t_prev": 100.5, "missed": 1})


def _header_disagrees(path):
    recs = tobs.read_events(path + ".p1")
    recs[0]["cadence_s"] = 0.5
    _jsonl(path + ".p1", recs)


def _empty_shard(path):
    open(path + ".p1", "w").close()


def _no_shard(path):
    for p in tobs.discover_history_shards(path):
        os.remove(p)


TAMPERS = {"healthy": None, "missing_shard": _drop_middle_shard,
           "non_increasing_t": _non_increasing, "undeclared_key": _undeclared,
           "undetectable_gap": _phantom_gap,
           "header_disagrees": _header_disagrees,
           "empty_shard": _empty_shard, "no_shard": _no_shard}


@pytest.mark.parametrize("case", list(TAMPERS))
def test_verify_history_equals_jax(healthy, case):
    if TAMPERS[case] is not None:
        TAMPERS[case](healthy)
    got = history_report.verify_history(healthy)
    assert got == jax_hist.verify_history(healthy)
    ok, problems, stats = got
    assert ok == (case == "healthy")
    if case == "healthy":
        assert stats["ticks"] == 9 and stats["shards"] == 3
        assert stats["gaps_persisted"] == stats["gaps_redetected"] == 1
    elif case == "missing_shard":
        assert any("missing or reordered shard" in p for p in problems)
    elif case == "non_increasing_t":
        assert any("non-increasing t" in p for p in problems)
    elif case == "undeclared_key":
        assert any("undeclared" in p for p in problems)
    elif case == "undetectable_gap":
        assert any("gap accounting break" in p for p in problems)
    elif case == "header_disagrees":
        assert any("header cadence_s" in p for p in problems)
    elif case == "empty_shard":
        assert any("empty shard" in p for p in problems)
    else:
        assert problems == [f"no shards found at {healthy!r}"]


@pytest.mark.parametrize("series,window", [
    (None, 30.0), (["done_total"], 1.0), (["done_total", "nope"], 5.0)])
def test_history_summarize_equals_jax(healthy, series, window):
    got = history_report.summarize(healthy, series, window)
    assert got == jax_hist.summarize(healthy, series, window)
    assert got["doc"]["samples"] == 9
    assert [b["series"] for b in got["blocks"]] == (series or [])[:1]


@pytest.mark.parametrize("points", [[], [(1.0, 0.0)],
                                    [(float(i), float(i % 7 - 3))
                                     for i in range(60)]])
def test_render_curve_equals_jax(points):
    assert (history_report.render_curve(points)
            == jax_hist.render_curve(points))


@pytest.mark.parametrize("case,code", [
    ("healthy", None), ("missing_shard", 1), ("undetectable_gap", 1),
    ("no_shard", 1)])
@pytest.mark.parametrize("flags", [
    ["--strict"], ["--strict", "--json"],
    ["--strict", "--series", "done_total", "--window", "2"], []],
    ids=["strict", "strict_json", "strict_series", "lenient"])
def test_history_cli_exit_and_text_as_jax(healthy, monkeypatch, case, code,
                                          flags):
    if TAMPERS[case] is not None:
        TAMPERS[case](healthy)
    got, text, err = _run(history_report.main, [healthy] + flags)
    jgot, jtext, jerr = _run_jax(jax_hist.main, [healthy] + flags,
                                 monkeypatch)
    want = code if "--strict" in flags else None
    assert jgot == want
    assert (got == want) if want is not None else isinstance(got, dict)
    assert _strip_report(text) == jtext and err == jerr
    line = json.loads(text.strip().splitlines()[-1][len(REPORT_PREFIX):])
    assert line["cli"] == "history_report"
    assert line["ok"] == (case == "healthy")
    if "--json" in flags:
        doc = json.loads(_strip_report(text))
        assert doc["verifier"]["ok"] == (case == "healthy")
    if case == "healthy" and not flags[1:]:
        assert "verifier: OK" in text


def test_history_cli_keeps_a_copy_intact(healthy, tmp_path):
    """The reader writes nothing next to the shards it reads."""
    before = sorted(os.listdir(os.path.dirname(healthy)))
    copy = str(tmp_path / "copy")
    shutil.copytree(os.path.dirname(healthy), copy)
    _run(history_report.main, [healthy, "--strict"])
    assert sorted(os.listdir(os.path.dirname(healthy))) == before
    for name in before:
        with open(os.path.join(copy, name)) as f, \
                open(os.path.join(os.path.dirname(healthy), name)) as g:
            assert f.read() == g.read()
