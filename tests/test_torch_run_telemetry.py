"""The port's run telemetry (``obs.health``, ``obs.run``,
``utils.profiling``) and the training hooks that report through it, held
to the JAX package's on the CPU.

- ``HealthSentinel``: the same (loss, grad norm) windows give the same
  verdicts, ``state()`` (the ``/healthz`` body), registry series and
  ``health`` events under warn / skip_step and each limit; halt raises
  ``DivergenceError`` at the same window with the same message.
- ``RunTelemetry`` around each package's ``train_epoch`` / ``fit`` on
  the same step outputs (the JAX tests' stub steps; the port's losses
  are tensors, read back at the window): the same event names, fields
  and deterministic values (``train_step``, ``health``, ``epoch``,
  ``warmup_complete``), the same registry series; a trailing partial
  window; halt raises and ``/healthz`` reads 503, warn counts and
  continues; another exception emits the memory forensics.
- ``device_prefetch(phase_stats=)``, ``ShmRingInput.attach_telemetry``,
  ``RunSupervisor.bind(telemetry)``'s ``/healthz`` block and ``cli.train
  --telemetry-sink --telemetry-trace --telemetry-port --on-divergence``
  (flags into the bundle; a tiny-config CPU run end to end; a halt on a
  tiny grad-norm limit).
- ``utils.profiling``: ``profile_trace`` writes a Chrome trace on the
  CPU with its ``trace_start`` / ``trace_stop`` events, ``timed`` and
  ``chained_time`` on an explicit CPU device.
"""
import dataclasses
import json
import math
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import improved_body_parts_torch.obs as tobs
import improved_body_parts_tpu.obs as jobs
from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.train import loop as tloop
from improved_body_parts_tpu.config import get_config as jget_config
from improved_body_parts_tpu.train import loop as jloop

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

#: event fields that carry clocks, not results
CLOCK_FIELDS = {"t", "time_unix", "step_s", "imgs_per_sec", "data_wait_s",
                "compute_s", "duration_s", "pid", "host", "argv"}

WINDOWS = [(0.5, 1.0), (0.4, 2.0), (float("nan"), 1.0), (0.3, 9.0),
           (0.2, float("inf")), (0.2, None), (float("-inf"), None),
           (0.1, 0.5)]


def _events(path):
    recs = tobs.read_events(path)
    return [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
            for r in recs if r["event"] != "run_start"]


def _sentinel_run(obs, tmp_path, name, policy, limit):
    path = str(tmp_path / f"{name}.jsonl")
    sink = obs.EventSink(path)
    reg = obs.Registry()
    s = obs.HealthSentinel(reg, sink, policy=policy, grad_norm_limit=limit)
    verdicts, states = [], []
    for i, (loss, gn) in enumerate(WINDOWS):
        verdicts.append(s.check(loss, gn, step=i, epoch=0))
        states.append(s.state())
    sink.close()
    return verdicts, states, reg.snapshot(), _events(path)


@pytest.mark.parametrize("policy,limit", [
    ("warn", 0.0), ("warn", 5.0), ("skip_step", 5.0)])
def test_health_sentinel_equal_jax(tmp_path, policy, limit):
    got = _sentinel_run(tobs, tmp_path, "t", policy, limit)
    assert got == _sentinel_run(jobs, tmp_path, "j", policy, limit)
    assert got[0] == [True, True, False, limit == 0.0, False, True, False,
                      True]
    json.dumps(got[1], allow_nan=False)          # /healthz stays strict


def test_health_sentinel_halt_and_extra_equal_jax():
    msgs = []
    for obs in (jobs, tobs):
        s = obs.HealthSentinel(obs.Registry(), policy="halt",
                               grad_norm_limit=5.0)
        s.set_extra("supervisor", lambda: {"status": "draining"})
        s.set_extra("broken", lambda: 1 / 0)
        assert s.check(0.5, 1.0, step=1, epoch=0)
        healthy = s.state()
        with pytest.raises(obs.DivergenceError, match="halt") as e:
            s.check(0.5, 6.0, step=2, epoch=0)
        msgs.append((str(e.value), healthy, s.state()))
    assert msgs[1] == msgs[0]
    # an extra source's own status escalates a healthy probe body
    assert msgs[1][1]["status"] == "draining"
    assert msgs[1][1]["broken"] == "error: ZeroDivisionError"
    assert msgs[1][2]["status"] == "diverged"
    for obs in (jobs, tobs):
        with pytest.raises(ValueError, match="policy"):
            obs.HealthSentinel(obs.Registry(), policy="explode")
    assert tobs.POLICIES == jobs.POLICIES


# --------------------------------------------------------------------- #
# the train loop under the bundle, both packages                        #
# --------------------------------------------------------------------- #
class _State:
    """What the port's loop reads of a state: the model's device."""

    def __init__(self):
        self.model = torch.nn.Linear(1, 1)


def _step_outputs(n, nan_at=None, gnorm=True):
    out = []
    for i in range(n):
        loss = float("nan") if i == nan_at else 0.5 + 0.125 * (i % 3)
        out.append((loss, 1.0 + i if gnorm else None))
    return out


def _steps(pkg, outputs):
    calls = [0]

    def step(state, *batch):
        loss, gn = outputs[calls[0]]
        calls[0] += 1
        if pkg == "jax":
            lv = np.float32(loss)
            return (state, lv) if gn is None else (state, lv,
                                                   np.float32(gn))
        lv = torch.tensor(loss, dtype=torch.float32)
        return ((state, lv) if gn is None
                else (state, lv, torch.tensor(gn, dtype=torch.float32)))
    return step, calls


def _batches(n):
    for _ in range(n):
        yield (np.ones((2, 8, 8, 3), np.float32),)


def _epoch(pkg, tmp_path, outputs, print_freq, tag="", **tele_kw):
    obs, loop, cfg, state = ((jobs, jloop, jget_config("tiny"), None)
                             if pkg == "jax" else
                             (tobs, tloop, get_config("tiny"), _State()))
    path = str(tmp_path / f"{pkg}{tag}.jsonl")
    reg = obs.Registry()
    kw = dict(registry=reg, watch_compiles=False, **tele_kw)
    if pkg == "torch":
        kw["device"] = "cpu"
    tele = obs.RunTelemetry(path, **kw)
    step, calls = _steps(pkg, outputs)
    err = None
    try:
        _, avg = loop.train_epoch(state, step, _batches(len(outputs)), cfg,
                                  2, print_freq=print_freq, telemetry=tele,
                                  log_fn=lambda s: None)
    except Exception as e:  # noqa: BLE001 — compared across packages
        avg, err = None, f"{type(e).__name__}: {e}"
    healthz = None
    if tele.server is not None:
        try:
            with urllib.request.urlopen(tele.server.url + "/healthz",
                                        timeout=10) as r:
                healthz = r.status
        except urllib.error.HTTPError as e:
            healthz = e.code
    tele.close()
    snap = {k: v for k, v in reg.snapshot().items()
            if k.startswith(("train_loss", "health_"))}
    return dict(avg=avg, err=err, calls=calls[0], events=_events(path),
                series=sorted(reg.snapshot()), snap=snap, healthz=healthz)


@pytest.mark.parametrize("n,print_freq,gnorm", [
    (12, 4, True), (10, 4, True), (6, 8, False)])
def test_train_epoch_events_equal_jax(tmp_path, n, print_freq, gnorm):
    """The same windows through both loops under the bundle: equal
    events (names, fields, values but the clocks), equal series."""
    outputs = _step_outputs(n, gnorm=gnorm)
    got = _epoch("torch", tmp_path, outputs, print_freq)
    want = _epoch("jax", tmp_path, outputs, print_freq)
    assert got["events"] == want["events"]
    assert got["snap"] == want["snap"]
    assert got["series"] == want["series"]
    assert got["avg"] == pytest.approx(want["avg"], rel=1e-7)
    names = [e["event"] for e in got["events"]]
    assert names.count("train_step") == math.ceil(n / print_freq)
    assert "warmup_complete" in names and "trace_export" not in names
    if n % print_freq:
        assert got["events"][-2]["partial_window"] == n % print_freq


def test_halt_raises_and_healthz_503_warn_counts(tmp_path):
    outputs = _step_outputs(6, nan_at=2)
    halt = {pkg: _epoch(pkg, tmp_path, outputs, 1, on_divergence="halt",
                        http_port=0) for pkg in ("jax", "torch")}
    assert halt["torch"]["events"] == halt["jax"]["events"]
    assert halt["torch"]["err"].startswith("DivergenceError")
    assert halt["torch"]["err"] == halt["jax"]["err"]
    assert halt["torch"]["calls"] == 3 and halt["torch"]["healthz"] == 503
    names = [e["event"] for e in halt["torch"]["events"]]
    assert "memory_forensics" not in names
    warn = _epoch("torch", tmp_path, outputs, 1, tag="_warn",
                  on_divergence="warn", http_port=0)
    assert warn["err"] is None and warn["calls"] == 6
    assert warn["snap"]["health_divergences_total"] == 1.0
    assert warn["snap"]["health_checks_total"] == 6.0
    assert warn["healthz"] == 200                 # a later window healed
    assert [e["status"] for e in warn["events"]
            if e["event"] == "health"] == ["ok", "ok", "diverged", "ok",
                                           "ok", "ok"]


def test_step_exception_emits_forensics(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    tele = tobs.RunTelemetry(path, registry=tobs.Registry(),
                             watch_compiles=False, device="cpu")

    def step(state, *batch):
        raise RuntimeError("CUDA out of memory (simulated)")

    with pytest.raises(RuntimeError, match="simulated"):
        tloop.train_epoch(_State(), step, _batches(2), get_config("tiny"),
                          0, telemetry=tele, log_fn=lambda s: None)
    tele.close()
    (rec,) = [e for e in tobs.read_events(path)
              if e["event"] == "memory_forensics"]
    assert rec["oom"] is True and rec["live_arrays"] > 0
    assert rec["devices"] == {}                  # the CPU's zero sampler


def test_fit_epoch_events_equal_jax(tmp_path):
    """``fit`` under the bundle (a stub checkpoint manager on both sides,
    as the JAX package's own test does): the same epoch events."""
    saved = {}

    def stub_manager(pkg):
        class StubManager:
            @classmethod
            def from_config(cls, *a, **k):
                return cls()

            def save(self, state, epoch, train_loss, best_loss):
                saved.setdefault(pkg, []).append(epoch)

            def record_metric(self, *a, **k):
                pass

            def wait(self):
                pass

            def close(self):
                pass
        return StubManager

    events = {}
    for pkg, obs, loop, cfg, state in (
            ("jax", jobs, jloop, jget_config("tiny"), None),
            ("torch", tobs, tloop, get_config("tiny"), _State())):
        path = str(tmp_path / f"fit_{pkg}.jsonl")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        tele = obs.RunTelemetry(path, registry=obs.Registry(),
                                watch_compiles=False, **kw)
        outputs = _step_outputs(6)
        step, _ = _steps(pkg, outputs)
        orig = loop.ckpt.CheckpointManager
        loop.ckpt.CheckpointManager = stub_manager(pkg)
        try:
            loop.fit(state, step, cfg, lambda e: _batches(3), epochs=2,
                     checkpoint_dir=str(tmp_path / f"ck_{pkg}"),
                     log_fn=lambda s: None, telemetry=tele)
        finally:
            loop.ckpt.CheckpointManager = orig
        tele.close()
        events[pkg] = _events(path)
    assert events["torch"] == events["jax"]
    assert saved["torch"] == saved["jax"] == [0, 1]
    assert [e["epoch"] for e in events["torch"]
            if e["event"] == "epoch"] == [0, 1]


def test_run_bundle_installs_and_restores_defaults(tmp_path):
    from improved_body_parts_torch.obs.events import get_sink
    from improved_body_parts_torch.obs.reqtrace import get_reqtrace
    from improved_body_parts_torch.obs.trace import get_tracer

    before = (get_sink(), get_tracer(), get_reqtrace())
    hist = tobs.HistoryStore(None, cadence_s=0.01)
    with tobs.RunTelemetry(str(tmp_path / "ev.jsonl"), http_port=0,
                           trace_path=str(tmp_path / "trace.json"),
                           history=hist, device="cpu") as tele:
        assert get_sink() is tele.sink and get_tracer() is tele.trace
        assert get_reqtrace() is tele.reqtrace
        assert hist.doc()["sampler_alive"]
        with urllib.request.urlopen(tele.server.url + "/history",
                                    timeout=10) as r:
            assert r.status == 200
    assert (get_sink(), get_tracer(), get_reqtrace()) == before
    assert not hist.doc()["sampler_alive"]
    assert os.path.exists(tmp_path / "trace.json")
    export = [e for e in tobs.read_events(str(tmp_path / "ev.jsonl"))
              if e["event"] == "trace_export"]
    assert export and export[0]["path"].endswith("trace.json")
    assert (tobs.resolve_sink_path("auto", "/ck")
            == jobs.resolve_sink_path("auto", "/ck"))
    assert tobs.resolve_sink_path("", "/ck") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tobs.RunTelemetry(None)              # the card by default
        assert get_sink() is before[0]


# --------------------------------------------------------------------- #
# the hooks: prefetch, ring, supervisor, cli.train                      #
# --------------------------------------------------------------------- #
def test_device_prefetch_phase_stats_attributes_wait_and_compute():
    from improved_body_parts_torch.parallel import device_prefetch

    def slow_source():
        for i in range(4):
            time.sleep(0.03)                     # the input falls behind
            yield (np.full((2, 3), i, np.float32),)

    phases = tobs.StepPhases(tobs.Registry(), "train")
    seen = []
    for (x,) in device_prefetch(slow_source(), "cpu", depth=1,
                                phase_stats=phases):
        time.sleep(0.01)                         # the step
        seen.append(int(x[0, 0]))
    wait, hold = phases.totals()
    assert seen == [0, 1, 2, 3] and phases.batches.value == 4
    assert wait > 0.05 and hold > 0.03


def test_ring_attach_telemetry_exports_its_internals(one_torch_thread):
    from improved_body_parts_torch.data import MemoryDataset, ShmRingInput
    from improved_body_parts_torch.data.fixture import fixture_records

    cfg = get_config("tiny")
    ds = MemoryDataset(fixture_records(num_images=4, people_per_image=1,
                                       image_size=128, seed=3), cfg,
                       augment=False)
    reg = tobs.Registry()
    with ShmRingInput(ds, 2, num_workers=1, wire="uint8") as ring:
        assert ring.attach_telemetry(reg) is ring
        n = sum(1 for _ in ring.batches(0))
        snap = reg.snapshot()
    assert n == 2
    assert snap["input_ring_batches_total"] == 2.0
    assert snap["input_ring_slots_total"] == float(ring.slots)
    assert snap["input_ring_consumer_stalls_total"] >= 1.0
    assert snap["input_ring_rebuilds_total"] == 0.0
    assert 'input_ring_render_seconds{worker="0"}' in snap
    assert "input_ring_free_slots" in snap


def test_supervisor_bind_puts_its_state_on_healthz(tmp_path):
    from improved_body_parts_torch.train import RunSupervisor

    sup = RunSupervisor(str(tmp_path / "ck"), sleep=lambda s: None,
                        log_fn=lambda s: None)
    sup.open_segment({"argv": []})
    with tobs.RunTelemetry(str(tmp_path / "ev.jsonl"), http_port=0,
                           device="cpu") as tele:
        sup.bind(tele)
        with urllib.request.urlopen(tele.server.url + "/healthz",
                                    timeout=10) as r:
            body = json.loads(r.read())
    assert body["status"] == "ok" and "supervisor" in body
    assert body["supervisor"]["segment"] == sup.segment
    assert any(e["event"] == "segment_start"
               for e in tobs.read_events(str(tmp_path / "ev.jsonl")))


@pytest.mark.parametrize("argv,policy,sink,trace,port", [
    (["--on-divergence", "halt"], "halt", False, False, False),
    (["--on-divergence", "skip_step"], "skip_step", False, False, False),
    (["--telemetry-sink", "auto"], "warn", True, False, False),
    (["--telemetry-trace", "auto"], "warn", False, True, False),
    (["--telemetry-port", "0"], "warn", False, False, True),
])
def test_telemetry_flags_build_the_bundle(tmp_path, argv, policy, sink,
                                          trace, port):
    from improved_body_parts_torch.cli import train as cli_train

    args = cli_train._parser().parse_args(
        ["--config", "tiny", "--checkpoint-dir", str(tmp_path), *argv,
         "--device", "cpu"])
    cfg, _ = cli_train.resolve_args(args)
    tele, sink_path, trace_path = cli_train.make_telemetry(
        args, cfg, torch.device("cpu"))
    try:
        assert tele.health.policy == policy
        assert (sink_path == str(tmp_path / "events.jsonl")) == sink
        assert (trace_path == str(tmp_path / "trace.json")) == trace
        assert (tele.server is not None) == port
    finally:
        tele.close()
    args = cli_train._parser().parse_args(["--config", "tiny",
                                           "--device", "cpu"])
    assert cli_train.make_telemetry(args, cli_train.resolve_args(args)[0],
                                    "cpu")[0] is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from improved_body_parts_torch.data.fixture import build_fixture

    path = str(tmp_path_factory.mktemp("tele_corpus") / "train.h5")
    assert build_fixture(path, num_images=3, people_per_image=2,
                         image_size=128, seed=4, drawn=True) >= 4
    return path


def test_cli_train_telemetry_sink_and_halt_policy(corpus, tmp_path, capsys,
                                                  one_torch_thread):
    """``cli.train`` with the telemetry flags on a healthy tiny run: the
    manifest links the stream and trace, the stream holds a train_step
    per window with a healthy sentinel verdict, an epoch record and the
    checkpoint's events, every line strict JSON, and the trace saved."""
    from improved_body_parts_torch.cli import parse_reports
    from improved_body_parts_torch.cli import train as cli_train

    ck = str(tmp_path / "ck")
    cli_train.main(["--config", "tiny", "--epochs", "1", "--train-h5",
                    corpus, "--workers", "0", "--input-pipeline", "sync",
                    "--checkpoint-dir", ck, "--print-freq", "1",
                    "--telemetry-sink", "auto", "--telemetry-trace", "auto",
                    "--telemetry-port", "0", "--on-divergence", "halt",
                    "--device", "cpu"])
    (rep,) = parse_reports(capsys.readouterr().out)
    with open(os.path.join(ck, "RUN.json")) as f:
        manifest = json.load(f)
    assert manifest["telemetry_events"] == os.path.join(ck, "events.jsonl")
    assert manifest["on_divergence"] == "halt"
    assert manifest["telemetry_port"] > 0
    with open(manifest["telemetry_events"]) as f:
        evs = [json.loads(line, parse_constant=pytest.fail) for line in f]
    names = [e["event"] for e in evs]
    assert names.count("train_step") == rep["steps"] > 0
    health = [e for e in evs if e["event"] == "health"]
    assert len(health) == rep["steps"]
    assert all(e["status"] == "ok" and e["grad_norm"] > 0 for e in health)
    assert "epoch" in names and "trace_export" in names
    assert os.path.exists(manifest["telemetry_trace"])


def test_train_halts_on_a_tiny_grad_norm_limit(corpus, tmp_path,
                                               one_torch_thread):
    """``cli.train.train`` under a halt bundle with a grad-norm limit no
    step meets: the first window raises ``DivergenceError`` out of the
    run (the in-flight checkpoint flushed), and the sentinel reads
    diverged."""
    from improved_body_parts_torch.cli import train as cli_train
    from improved_body_parts_torch.data import CocoPoseDataset

    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "ck"), print_freq=1,
        on_divergence="halt", health_grad_norm_limit=1e-9))
    ds = CocoPoseDataset(corpus, cfg, augment=True, seed=0)
    with tobs.RunTelemetry(str(tmp_path / "ev.jsonl"), device="cpu",
                           on_divergence="halt",
                           grad_norm_limit=1e-9) as tele:
        with pytest.raises(tobs.DivergenceError, match="grad_norm_over"):
            cli_train.train(cfg, ds, 1, device=torch.device("cpu"),
                            log_fn=lambda s: None, telemetry=tele)
        assert tele.health.state()["status"] == "diverged"
    ds.close()


# --------------------------------------------------------------------- #
# profiling                                                             #
# --------------------------------------------------------------------- #
def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from improved_body_parts_torch.utils import profile_trace

    path = str(tmp_path / "ev.jsonl")
    with tobs.RunTelemetry(path, device="cpu", registry=tobs.Registry()):
        with profile_trace(str(tmp_path / "prof")):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = tmp_path / "prof" / "trace.json"
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"]
    evs = {e["event"]: e for e in tobs.read_events(path)}
    assert evs["trace_start"]["log_dir"] == str(tmp_path / "prof")
    assert evs["trace_stop"]["path"] == str(trace)
    assert evs["trace_stop"]["duration_s"] > 0


def test_timed_and_chained_time_on_the_cpu(tmp_path, capsys):
    from improved_body_parts_torch.utils import (
        AverageMeter,
        chained_time,
        timed,
    )

    meter = AverageMeter()
    with timed("block", meter, sync_value=torch.ones(2)):
        time.sleep(0.01)
    assert meter.count == 1 and meter.val >= 0.01
    assert "[block]" in capsys.readouterr().out
    seen = []

    def forward(variables, x):
        seen.append(x.clone())
        return [[x * variables]]

    s = chained_time(forward, 2.0, torch.ones(1, 4, 4, 3), iters=3,
                     warmup=1)
    assert s > 0 and len(seen) == 4
    # each step's input differs: the noise bank and the previous output
    assert not torch.equal(seen[1], seen[2])


def test_checkpoint_manager_reports_through_the_registry(tmp_path):
    """The checkpoint manager's registry metrics (the JAX package's
    names): each phase's seconds, the payload bytes, the retained
    count after retention."""
    sys.path.insert(0, "tests")
    from test_torch_checkpoint import _state

    from improved_body_parts_torch.train import CheckpointManager

    reg = tobs.Registry()
    with CheckpointManager(str(tmp_path), keep_last_n=1, keep_best=False,
                           registry=reg) as m:
        for epoch in range(3):
            m.save(_state(float(epoch)), epoch, 1.0, 1.0)
        m.wait()
    snap = reg.snapshot()
    for phase in ("blocked", "snapshot", "serialize", "commit"):
        assert f'checkpoint_seconds{{phase="{phase}"}}' in snap
    assert snap["checkpoint_bytes"] > 0
    assert snap["checkpoints_retained"] == 1.0


@pytest.mark.parametrize("entry", ["fit", "cli_train"])
def test_run_checkpoint_metrics_reach_the_bundle_registry(
        entry, corpus, tmp_path, one_torch_thread):
    """A run under a bundle with its own registry: the checkpoint
    manager that ``fit`` (and ``cli.train.train`` through it) builds
    reports its seconds, bytes and retained count to that registry, so
    they reach the bundle's ``/metrics``."""
    sys.path.insert(0, "tests")
    from test_torch_checkpoint import CFG, _state

    reg = tobs.Registry()
    ck = str(tmp_path / "ck")
    with tobs.RunTelemetry(None, registry=reg, http_port=0,
                           device="cpu") as tele:
        if entry == "fit":
            cfg = CFG.replace(train=dataclasses.replace(
                CFG.train, checkpoint_dir=ck, keep_last_n=1))
            tloop.fit(_state(), lambda s, x: (s, torch.tensor(1.0)), cfg,
                      lambda e: iter([(np.ones((1, 4), np.float32),)] * 2),
                      epochs=2, log_fn=lambda s: None, telemetry=tele)
        else:
            from improved_body_parts_torch.cli import train as cli_train
            from improved_body_parts_torch.data import CocoPoseDataset

            cfg = get_config("tiny")
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, checkpoint_dir=ck, keep_last_n=1))
            ds = CocoPoseDataset(corpus, cfg, augment=True, seed=0)
            try:
                cli_train.train(cfg, ds, 1, device=torch.device("cpu"),
                                log_fn=lambda s: None, telemetry=tele)
            finally:
                ds.close()
        with urllib.request.urlopen(tele.server.url + "/metrics",
                                    timeout=10) as r:
            exposition = r.read().decode()
    snap = reg.snapshot()
    for phase in ("blocked", "snapshot", "serialize", "commit"):
        assert f'checkpoint_seconds{{phase="{phase}"}}' in snap
        assert f'checkpoint_seconds_count{{phase="{phase}"}}' in exposition
    assert snap["checkpoint_bytes"] > 0
    assert snap["checkpoints_retained"] >= 1.0
    assert "checkpoint_bytes " in exposition
