"""The port's serve-side fault-injection harness
(``improved_body_parts_torch.cli.chaos_serve``) held to the JAX package's
``tools/chaos_serve.py`` on the CPU:

- one whole sweep (module fixture: ``tiny``, 2 replicas, 4 requests a
  phase, 2 streams x 6 frames, a 2 s wedge timeout), with one case per
  injection kind carrying the JAX test's assertions
  (``tests/test_serve_pool.py::test_chaos_serve_cli``) and one per
  teardown gate: zero lost futures, 0 first runs after warmup, no leaked
  thread or child, the pool's ledger, the artifact and its events, the
  ``CLI_REPORT`` line last;
- each injection's record carries the keys of the JAX tool's ``rec =
  {...}`` literal of that kind, read from its source;
- ``ChaosBox`` (delay, wedge, poison countdown), ``ChaosPredictor`` and
  ``LedgeredFutures.audit`` behave as the JAX classes on the same
  sequences;
- the JAX tool's artifacts are refused, and ``--device cuda`` without a
  card raises, before any model is built.
"""
import ast
import contextlib
import importlib.util
import io
import json
import os
import sys
import threading
import time
from concurrent.futures import Future

import pytest
import torch

from improved_body_parts_torch.cli import REPORT_PREFIX, chaos_serve

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "chaos_serve.py")


def _jax_tool():
    """``tools/chaos_serve.py`` of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_tools_chaos_serve",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_chaos = _jax_tool()
MODS = (("jax", jax_chaos), ("torch", chaos_serve))

SWEEP_ARGV = ["--config", "tiny", "--replicas", "2", "--requests", "4",
              "--streams", "2", "--frames", "6", "--wedge-timeout", "2.0",
              "--device", "cpu", "--strict"]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``chaos_serve.main`` once: (return or exit code, report, stdout,
    the events file's records)."""
    out = str(tmp_path_factory.mktemp("chaos") / "serve_chaos_torch.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            result = chaos_serve.main(SWEEP_ARGV + ["--out", out])
        except SystemExit as e:
            result = e.code
    with open(out) as f:
        report = json.load(f)
    events_path = os.path.splitext(out)[0] + "_events.jsonl"
    with open(events_path) as f:
        events = [json.loads(line, parse_constant=pytest.fail)
                  for line in f]
    return result, report, buf.getvalue(), events


def _injection(report, kind):
    return next(i for i in report["injections"] if i["kind"] == kind)


def test_every_injection_in_the_jax_order(sweep):
    result, report, _, _ = sweep
    assert isinstance(result, dict)          # --strict did not exit 1
    assert [i["kind"] for i in report["injections"]] == [
        "wedged_fetcher", "poisoned_program", "killed_decode_pool",
        "replica_hard_stop_mid_stream", "latency_spike",
        "worker_sigkill", "fastpath_mid_skip_run"]
    assert list(chaos_serve.KINDS) == [i["kind"]
                                       for i in report["injections"]]


def _wedged(rec, report):
    assert rec["all_resolved_ok"] and rec["futures"] == 4
    assert rec["fenced"] and rec["fence_reason"] in ("wedged", "stopped")
    assert rec["restarted"] and rec["recovery_s"] < 60.0


def _poisoned(rec, report):
    assert rec["fenced"] and rec["fence_reason"] == "breaker_open"
    assert rec["breaker_after_restart"] == "half_open"
    assert rec["breaker_closed_after_probes"] and rec["restarted"]


def _killed_pool(rec, report):
    assert rec["all_resolved_ok"] and rec["replica_still_live"]
    assert rec["completed_after"] - rec["completed_before"] == 4


def _hard_stop(rec, report):
    assert [s["delivered"] for s in rec["streams"]] == [6, 6]
    assert all(s["ordered"] for s in rec["streams"])
    assert rec["frames_failed"] == 0 and rec["frames_resubmitted"] >= 1
    assert rec["fenced"] and rec["restarted"]


def _latency(rec, report):
    assert rec["policy"]["hedges"] >= 1 and rec["policy"]["hedge_wins"] >= 1


def _sigkill(rec, report):
    assert rec["resolved_ok"] + rec["resolved_error"] == \
        rec["in_flight_at_kill"]
    assert rec["respawned"] and rec["respawned_pid"] != rec["killed_pid"]
    assert rec["fenced"] >= 1 and rec["failovers"] >= 1
    assert rec["post_respawn_answered"]
    assert rec["postmortem_ok"] and rec["postmortem_problems"] == []
    assert rec["postmortem_in_flight"] >= 1


def _fastpath(fp, report):
    # the JAX test's assertions: three-tier conservation exact through
    # shed + migration + hard-stop, the skip run survived the faults, and
    # the stranded real forward is the ONLY failure
    assert fp["migrate_stream"]["exact"] is True
    assert fp["shed_stream"]["exact"] is True
    assert fp["migrate_stream"]["failed"] == 1
    assert fp["shed_stream"]["dropped"] >= 1
    assert fp["frames_migrated"] >= 1
    assert fp["migrate_stream_escalations"]["error"] >= 1
    assert fp["migrate_stream"]["answered_tracker"] > \
        fp["skipped_before_faults"]


INJECTION_CHECKS = {
    "wedged_fetcher": _wedged, "poisoned_program": _poisoned,
    "killed_decode_pool": _killed_pool,
    "replica_hard_stop_mid_stream": _hard_stop,
    "latency_spike": _latency, "worker_sigkill": _sigkill,
    "fastpath_mid_skip_run": _fastpath}


@pytest.mark.parametrize("kind", list(INJECTION_CHECKS))
def test_injection(sweep, kind):
    _, report, stdout, _ = sweep
    INJECTION_CHECKS[kind](_injection(report, kind), report)
    assert f"injection {kind}: done" in stdout


def _jax_record_keys():
    """{kind: keys} of each ``rec = {...}`` literal in the JAX tool."""
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "rec"
                and isinstance(node.value, ast.Dict)):
            keys = {k.value for k in node.value.keys}
            kind = node.value.values[[k.value for k in node.value.keys]
                                     .index("kind")].value
            out[kind] = keys
    return out


@pytest.mark.parametrize("kind", list(INJECTION_CHECKS))
def test_record_keys_are_the_jax_tools(sweep, kind):
    _, report, _, _ = sweep
    jax_keys = _jax_record_keys()
    assert set(jax_keys) == set(INJECTION_CHECKS)
    assert set(_injection(report, kind)) == jax_keys[kind]


def test_report_keys_cover_the_jax_tools(sweep):
    _, report, _, _ = sweep
    for key in ("protocol", "platform", "config", "size", "replicas",
                "requests_per_phase", "streams", "frames_per_stream",
                "wedge_timeout_s", "telemetry_events", "injections",
                "warmup", "futures", "recompiles_post_warmup",
                "leaked_threads", "leaked_children", "pool_final",
                "failed_checks", "checks_failed", "ok"):
        assert key in report, key
    assert report["platform"] == "cpu" and report["device"] == "cpu"
    assert report["replicas"] == 2 and report["parameters"] > 0


def _gate_futures(report, stdout, events):
    f = report["futures"]
    assert f["lost"] == 0 and f["lost_kinds"] == []
    assert f["tracked"] == f["resolved_ok"] + f["resolved_error"]
    # the typed errors: the fastpath's stranded forward and shed frames,
    # and the SIGKILLed worker's in-flight requests
    assert f["resolved_error"] >= 2


def _gate_first_runs(report, stdout, events):
    assert report["recompiles_post_warmup"] == 0
    assert report["warmup"]["bucket_shapes"] == [[128, 128]]
    names = [e["event"] for e in events]
    assert "warmup_complete" in names and "recompile" not in names


def _gate_threads(report, stdout, events):
    assert report["leaked_threads"] == []


def _gate_children(report, stdout, events):
    assert report["leaked_children"] == []


def _gate_pool_ledger(report, stdout, events):
    pool = report["pool_final"]
    assert "pool accounting conserved" in stdout
    assert all(s["state"] == "live" for s in pool["replicas"])


def _gate_verdict(report, stdout, events):
    assert report["ok"] is True and report["checks_failed"] == 0
    assert report["failed_checks"] == [] and "FAIL " not in stdout


def _gate_events(report, stdout, events):
    names = [e["event"] for e in events]
    assert names[0] == "run_start"
    assert [e["kind"] for e in events if e["event"] == "injection_done"] \
        == list(chaos_serve.KINDS)
    verdict = [e for e in events if e["event"] == "chaos_serve_verdict"]
    assert len(verdict) == 1 and verdict[0]["ok"] is True


def _gate_cli_report(report, stdout, events):
    last = stdout.strip().splitlines()[-1]
    assert last.startswith(REPORT_PREFIX)
    line = json.loads(last[len(REPORT_PREFIX):])
    assert line["cli"] == "chaos_serve" and line["ok"] is True
    assert line["futures_lost"] == 0 and line["recompiles_post_warmup"] == 0
    assert line["injections"] == list(chaos_serve.KINDS)


GATES = {"futures": _gate_futures, "first_runs": _gate_first_runs,
         "threads": _gate_threads, "children": _gate_children,
         "pool_ledger": _gate_pool_ledger, "verdict": _gate_verdict,
         "events": _gate_events, "cli_report": _gate_cli_report}


@pytest.mark.parametrize("gate", list(GATES))
def test_teardown_gate(sweep, gate):
    _, report, stdout, events = sweep
    GATES[gate](report, stdout, events)


# --------------------------------------------------------------------- #
# the harness pieces, against the JAX classes                           #
# --------------------------------------------------------------------- #
def _poison_sequence(mod, poison, calls):
    box = mod.ChaosBox()
    with box.lock:
        box.poison_left = poison
    out = []
    for _ in range(calls):
        try:
            box.apply()
            out.append("ok")
        except RuntimeError as e:
            out.append(str(e))
    return out, box.poison_left


@pytest.mark.parametrize("poison,calls", [(0, 2), (3, 5), (2, 2)])
def test_box_poison_countdown_equals_jax(poison, calls):
    got = _poison_sequence(chaos_serve, poison, calls)
    assert got == _poison_sequence(jax_chaos, poison, calls)
    assert got[0].count("ok") == max(0, calls - poison)


@pytest.mark.parametrize("name,mod", MODS)
def test_box_delay_holds_the_resolve(name, mod):
    box = mod.ChaosBox()
    box.delay_s = 0.05
    t0 = time.perf_counter()
    box.apply()
    assert time.perf_counter() - t0 >= 0.05


@pytest.mark.parametrize("name,mod", MODS)
def test_box_wedge_parks_until_released(name, mod):
    box = mod.ChaosBox()
    box.wedge.set()
    done = threading.Event()
    t = threading.Thread(target=lambda: (box.apply(), done.set()))
    t.start()
    assert not done.wait(0.2)            # parked
    box.release.set()
    assert done.wait(5.0)
    t.join(5.0)
    assert not t.is_alive()


class _Inner:
    """A predictor stand-in: each async method returns a resolve that
    logs its name; every other attribute passes through."""

    def __init__(self):
        self.log = []
        self.skeleton = "sk"

    def _async(self, name):
        def resolve():
            self.log.append(name)
            return name
        return resolve

    def predict_compact_async(self, img):
        return self._async("compact")

    def predict_compact_batch_async(self, imgs):
        return self._async("compact_batch")

    def predict_decoded_async(self, img):
        return self._async("decoded")

    def predict_decoded_batch_async(self, imgs):
        return self._async("decoded_batch")


def _wrapping(mod):
    inner = _Inner()
    box = mod.ChaosBox()
    pred = mod.ChaosPredictor(inner, box)
    out = [pred.skeleton]
    methods = ("predict_compact_async", "predict_compact_batch_async",
               "predict_decoded_async", "predict_decoded_batch_async")
    for m in methods:
        out.append(getattr(pred, m)(None)())
    with box.lock:
        box.poison_left = 1
    resolve = pred.predict_decoded_batch_async(None)
    try:
        resolve()
    except RuntimeError as e:
        out.append(str(e))
    out.append(resolve())               # the poison is spent
    return out, inner.log


def test_chaos_predictor_wrapping_equals_jax():
    got = _wrapping(chaos_serve)
    assert got == _wrapping(jax_chaos)
    # the poisoned resolve never reached the inner one
    assert got[1] == ["compact", "compact_batch", "decoded",
                      "decoded_batch", "decoded_batch"]


def _ledger(mod):
    ledger = mod.LedgeredFutures()
    ok, err1, err2, never = Future(), Future(), Future(), Future()
    ok.set_result([1])
    err1.set_exception(ValueError("x"))
    err2.set_exception(RuntimeError("y"))
    for f, kind in ((ok, "a"), (err1, "b"), (never, "c"), (err2, "b")):
        assert ledger.track(f, kind) is f
    return ledger.audit(timeout_s=0.2)


def test_ledger_audit_equals_jax():
    got = _ledger(chaos_serve)
    assert got == _ledger(jax_chaos)
    assert got == {"tracked": 4, "resolved_ok": 1, "resolved_error": 2,
                   "errors_by_type": {"ValueError": 1, "RuntimeError": 1},
                   "lost": 1, "lost_kinds": ["c"]}


@pytest.mark.parametrize("name,mod", MODS)
def test_wait_until(name, mod):
    hits = []
    assert mod.wait_until(lambda: hits.append(1) or len(hits) >= 3,
                          timeout_s=5, interval_s=0.001)
    assert not mod.wait_until(lambda: False, timeout_s=0.05)


# --------------------------------------------------------------------- #
# refusals                                                              #
# --------------------------------------------------------------------- #
class _Reached(Exception):
    pass


@pytest.mark.parametrize("out", [
    "SERVE_CHAOS.json", "sub/SERVE_CHAOS.json", "SERVE_CHAOS_events.jsonl",
    "SERVE_CHAOS_events.jsonl.p1", "SERVE_CHAOS.txt"])
def test_jax_artifacts_refused_before_any_work(monkeypatch, tmp_path, out):
    """``SERVE_CHAOS.json`` and its event files, as ``--out`` or as the
    event sink ``--out`` implies, exit before a model is built."""
    def reached(*a, **k):
        raise _Reached
    import improved_body_parts_torch.models as models

    monkeypatch.setattr(models, "build_model", reached)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="SERVE_CHAOS.* is the JAX"):
        chaos_serve.main(["--device", "cpu", "--out", out])
    assert os.listdir(tmp_path) == []


def test_the_port_names_are_not_refused(monkeypatch, tmp_path):
    def reached(*a, **k):
        raise _Reached
    import improved_body_parts_torch.models as models

    monkeypatch.setattr(models, "build_model", reached)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(_Reached):
        chaos_serve.main(["--device", "cpu"])


def test_no_card_raises_before_any_model(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU refusal is not reachable")

    def reached(*a, **k):
        raise _Reached
    import improved_body_parts_torch.models as models

    monkeypatch.setattr(models, "build_model", reached)
    out = str(tmp_path / "c.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_serve.main(["--out", out])
    assert not os.path.exists(out)


@pytest.mark.parametrize("main,flags", [
    (chaos_serve.main, ("--wedge-timeout", "--failover-bound", "--replicas",
                        "--planted", "--strict", "--device", "--out")),
    ("telemetry_report", ("--json", "--no-shards")),
    ("history_report", ("--series", "--window", "--json", "--strict"))],
    ids=["chaos_serve", "telemetry_report", "history_report"])
def test_help_names_the_flags(main, flags, capsys):
    """Each CLI's ``--help`` exits 0 and names its flags; only
    ``chaos_serve`` takes ``--device``."""
    if isinstance(main, str):
        import importlib

        main = importlib.import_module(
            f"improved_body_parts_torch.cli.{main}").main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for flag in flags:
        assert flag in text
    assert ("--device" in text) == (main is chaos_serve.main)
