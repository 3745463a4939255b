"""The port's fleet plane, compile watch and device memory
(``improved_body_parts_torch.obs.{fleet,recompile,memory}``) held to the
JAX package's, on the CPU.

- The worker telemetry block and the flight-recorder ring: the same
  inputs under one fake clock give the JAX package's bytes, and decode
  to the same documents (published, never published, torn, stale,
  unknown version, wrapped ring, torn ring).
- Postmortems: the same ring and in-flight ledger build the same record
  and the verifier gives the same verdicts.
- ``FleetRegistry``: the merged samples, ``/fleet`` document and
  ``/healthz`` block over published, unpublished and stale workers equal
  the JAX package's (``worker`` labels, stale marker, conservation).
- The telemetry knobs: ``WorkerTelemetry(enabled=False)`` touches
  neither the block nor the ring; ``flush_trace`` writes the JAX
  package's span file with its ``t0_mono`` anchor, or returns None.
- ``CompileWatch``: the port's compile event is the first run of an
  unwarmed (lane, shape, batch) in a ``Predictor``; the families and the
  ``recompile`` event are the JAX package's.
- ``DeviceMemory``: on the CPU an explicit zero sampler; asked for the
  card on a host without one it raises; forensics groups live tensors.
"""
import json
import time

import numpy as np
import pytest
import torch

import improved_body_parts_torch.obs as tobs
import improved_body_parts_torch.obs.fleet as tfleet
import improved_body_parts_tpu.obs as jobs
import improved_body_parts_tpu.obs.fleet as jfleet

PKGS = (("jax", jobs, jfleet), ("torch", tobs, tfleet))


class Clock:
    """A perf_counter stand-in: 100.0, 100.5, 101.0, ... per call."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


@pytest.fixture
def fake_clock(monkeypatch):
    """Every perf_counter read in both packages' fleet code returns the
    same sequence (both modules read ``time.perf_counter``)."""
    def install():
        clock = Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        return clock
    return install


def _worker_script(fleet, obs, telem, rec):
    wt = fleet.WorkerTelemetry(1, telem, rec)
    rng = np.random.default_rng(0)
    for i in range(40):
        wt.record(fleet.REC_PICKUP, slot=i % 8, seq=2 * i + 2, a=5.0)
        wt.count_status(i % 7 != 0, expired=i % 11 == 0)
        wt.observe_hops(float(rng.uniform(0.01, 0.02)),
                        float(rng.uniform(0.001, 0.002)))
        wt.record(fleet.REC_EXEC_DONE, slot=i % 8, seq=2 * i + 2)
        wt.record(fleet.REC_DONE, slot=i % 8, seq=2 * i + 2, a=0.0)
        if i % 5 == 4:
            wt.on_burst(5)
        wt.publish(force=i % 10 == 9)
    return wt


class TestTelemBlock:
    def test_publish_decode_roundtrip(self, fake_clock):
        """The same worker script writes the JAX package's telemetry
        block and ring byte for byte, and both decode alike."""
        out = {}
        for name, obs, fleet in PKGS:
            fake_clock()
            telem = np.zeros(fleet.TELEM_FLOATS, np.float64)
            rec = np.zeros(fleet.REC_FLOATS, np.float64)
            _worker_script(fleet, obs, telem, rec)
            doc = fleet.decode_telem(fleet.read_block(telem), now=200.0)
            ring = fleet.read_flight_records(rec)
            out[name] = (telem.tobytes(), rec.tobytes(), doc, ring)
        assert out["torch"] == out["jax"]
        assert tfleet.TELEM_FLOATS == jfleet.TELEM_FLOATS
        assert tfleet.REC_FLOATS == jfleet.REC_FLOATS
        doc, ring = out["torch"][2], out["torch"][3]
        assert doc["published"] and doc["served"] == 40
        assert len(ring["records"]) == tfleet.REC_SLOTS
        assert ring["count"] == 120

    @pytest.mark.parametrize("case", ["unpublished", "version", "torn",
                                      "stale"])
    def test_stale_marker_keeps_last_known_values(self, fake_clock, case):
        """A never-published, unknown-version, torn or stale block
        decodes as in the JAX package."""
        out = {}
        for name, obs, fleet in PKGS:
            fake_clock()
            telem = np.zeros(fleet.TELEM_FLOATS, np.float64)
            if case != "unpublished":
                _worker_script(fleet, obs, telem, None)
            if case == "version":
                telem[fleet.T_VERSION] = 99.0
            if case == "torn":
                telem[fleet.T_PARITY] += 1
            arr = fleet.read_block(telem, retries=4)
            out[name] = fleet.decode_telem(
                arr, staleness_s=5.0,
                now=1e4 if case == "stale" else 200.0)
        assert out["torch"] == out["jax"]
        doc = out["torch"]
        assert doc["published"] == (case == "stale")
        if case == "stale":
            assert doc["stale"] and doc["served"] == 40

    def test_sigkill_torn_ring_still_yields_records(self, fake_clock):
        out = {}
        for name, obs, fleet in PKGS:
            fake_clock()
            rec = np.zeros(fleet.REC_FLOATS, np.float64)
            wt = fleet.WorkerTelemetry(0, None, rec)
            for i in range(5):
                wt.record(fleet.REC_PICKUP, slot=i, seq=2 * i + 2)
            rec[0] += 1                      # killed mid-write
            out[name] = fleet.read_flight_records(rec)
        assert out["torch"] == out["jax"]
        assert out["torch"]["torn"] and len(out["torch"]["records"]) == 5

    def test_flow_id_equal(self):
        for args in ((0, 0, 2), (1, 7, 12), (3, 4095, 2 ** 33 + 6)):
            assert tfleet.flow_id(*args) == jfleet.flow_id(*args)


class TestTelemetryKnobs:
    """``WorkerTelemetry(enabled=False)`` (the fleet A/B's OFF arm) and
    ``flush_trace`` against the JAX package's."""

    def test_disabled_arm_never_touches_the_block_or_the_ring(
            self, fake_clock):
        """The JAX package's ``test_disabled_arm_never_touches_the_block``
        in both packages, the flight ring and the hop meters included:
        only the served counters move (the heartbeat reads them)."""
        out = {}
        for name, obs, fleet in PKGS:
            fake_clock()
            telem = np.zeros(fleet.TELEM_FLOATS, np.float64)
            rec = np.zeros(fleet.REC_FLOATS, np.float64)
            wt = fleet.WorkerTelemetry(0, telem, rec, enabled=False)
            wt.count_status(True)
            wt.observe_hops(0.010, 0.001)
            wt.record(fleet.REC_PICKUP, slot=1, seq=2)
            wt.on_burst(3)
            wt.sample_memory()
            published = wt.publish(force=True)
            wt.trace.add_span_rel("serve", 0.0, 0.001, track="w")
            out[name] = (published, telem.tobytes(), rec.tobytes(),
                         wt.served, wt.ok, wt.hops["device"].summary(),
                         wt.trace.enabled, wt.trace.recorded)
        assert out["torch"] == out["jax"]
        published, telem, rec, served, ok, hops, tracing, spans = \
            out["torch"]
        assert not published and (served, ok) == (1, 1)
        assert not any(np.frombuffer(telem)) and not any(
            np.frombuffer(rec))
        assert hops["count"] == 0 and not tracing and spans == 0

    @pytest.mark.parametrize("case", ["written", "no_path", "disabled",
                                      "unwritable"])
    def test_flush_trace(self, tmp_path, case):
        """Enabled with a path: the ring saved with its ``t0_mono``
        anchor, the path returned, the file the JAX package's but for
        the pid.  No path, the OFF arm, or a write that fails: None,
        nothing raised, no file."""
        got = {}
        for name, obs, fleet in PKGS:
            t0 = 1234.5
            wt = fleet.WorkerTelemetry(1, None, None, trace_t0=t0,
                                       enabled=case != "disabled")
            wt.trace.add_span_abs("serve", t0 + 0.002, 0.003,
                                  track="worker1-serve",
                                  args={"slot": 0, "seq": 2})
            wt.trace.flow_step("req", 7, track="worker1-serve", cat="proc",
                               ts=0.0035)
            path = {"no_path": None,
                    "unwritable": str(tmp_path / "afile" / "t.json")}.get(
                case, str(tmp_path / f"{name}.json.p2"))
            if case == "unwritable":
                (tmp_path / "afile").write_text("a file, not a directory")
            ret = wt.flush_trace(path)
            doc = None
            if ret is not None:
                with open(ret) as f:
                    doc = json.load(f)
                for ev in doc["traceEvents"]:
                    ev.pop("pid", None)
                    if ev["name"] == "process_name":
                        ev.pop("args")      # the package's name
            got[name] = (ret is None, doc)
        assert got["torch"][1] == got["jax"][1]
        none, doc = got["torch"]
        assert none == (case != "written")
        if case == "written":
            assert doc["otherData"]["t0_mono"] == 1234.5
            assert [e["name"] for e in doc["traceEvents"]
                    if e["ph"] != "M"] == ["serve", "req"]
        else:
            assert not list(tmp_path.glob("*.json.p2"))


class TestPostmortem:
    def test_build_and_verify_postmortem(self, fake_clock):
        out = {}
        for name, obs, fleet in PKGS:
            fake_clock()
            rec = np.zeros(fleet.REC_FLOATS, np.float64)
            wt = fleet.WorkerTelemetry(0, None, rec)
            wt.record(fleet.REC_PICKUP, slot=2, seq=11)
            wt.record(fleet.REC_PICKUP, slot=4, seq=13)
            wt.record(fleet.REC_EXEC_DONE, slot=4, seq=13)
            pm = fleet.build_postmortem(
                0, pid=4242, exitcode=-9,
                flight=fleet.read_flight_records(rec),
                in_flight=[(2, 11), (4, 13), (5, 12)])
            out[name] = (pm, fleet.verify_postmortem(pm))
        assert out["torch"] == out["jax"]
        pm, (ok, problems) = out["torch"]
        assert ok, problems
        assert [e["last_completed_hop"] for e in pm["in_flight"]] == [
            "queue", "device", None]

    @pytest.mark.parametrize("in_flight,require", [
        ([], True), ([(3, 4)], True), ([(3, 4)], False)])
    def test_verifier_rejects_an_unidentifying_postmortem(self, in_flight,
                                                          require):
        verdicts = []
        for _, obs, fleet in PKGS:
            empty = {"records": [], "count": 0, "torn": False}
            pm = fleet.build_postmortem(0, pid=1, exitcode=-9,
                                        flight=empty, in_flight=in_flight)
            verdicts.append((fleet.verify_postmortem(
                pm, require_in_flight=require),
                fleet.verify_postmortem({"worker": "zero"})))
        assert verdicts[1] == verdicts[0]
        assert verdicts[1][0][0] == (not require)


# --------------------------------------------------------------------- #
# parent-side merge                                                      #
# --------------------------------------------------------------------- #
def _info(**kw):
    info = {"alive": True, "running": True, "gave_up": False,
            "backing_off": False, "consecutive_failures": 0,
            "crash_budget": 3, "restarts": 1, "in_flight": 1,
            "submitted": 41, "hb_age_s": 0.01, "hb_served": 40,
            "pid": 4242}
    info.update(kw)
    return info


class TestFleetRegistry:
    def test_stale_worker_exports_with_stale_marker(self, fake_clock):
        """Three workers — published and fresh, never published (liveness
        only), published long ago (stale, gave up) — merge into the JAX
        package's samples, exposition, ``/fleet`` and ``/healthz``
        documents."""
        out = {}
        for name, obs, fleet in PKGS:
            clock = fake_clock()
            blocks = [np.zeros(fleet.TELEM_FLOATS, np.float64)
                      for _ in range(3)]
            _worker_script(fleet, obs, blocks[0], None)
            _worker_script(fleet, obs, blocks[2], None)
            clock.t += 1e3                   # block 2 ages past 5 s
            _worker_script(fleet, obs, blocks[0], None)
            reg = obs.Registry()
            fr = fleet.FleetRegistry(staleness_s=5.0).attach(reg)
            infos = [_info(), _info(pid=7, submitted=0, hb_served=0,
                                    in_flight=0),
                     _info(gave_up=True, alive=False, running=False)]
            for i, (b, info) in enumerate(zip(blocks, infos)):
                fr.add_worker(i, lambda b=b, f=fleet: f.read_block(b),
                              lambda info=info: info)
            # help texts aside (the port's compile family says what a
            # compile is there), every sample and line is the JAX one
            out[name] = ([s[:4] for s in fr.samples()],
                         [ln for ln in reg.prometheus().splitlines()
                          if not ln.startswith("# HELP")],
                         fr.fleet_state(), fr.health_extra(),
                         fr.conservation())
        assert out["torch"] == out["jax"]
        samples, text, state, health, cons = out["torch"]
        assert {s[1]["worker"] for s in samples if "worker" in s[1]} == {
            "0", "1", "2"}
        assert [ln.rsplit(" ", 1)[1] for ln in text
                if ln.startswith("fleet_worker_stale{")] == ["0.0", "0.0",
                                                             "1.0"]
        assert not any(s[0] == "fleet_worker_served_total"
                       and s[1]["worker"] == "1" for s in samples)
        assert health["status"] == "worker_crash_budget_exhausted"
        assert cons["router_submitted"] == 82 and cons["workers_served"] \
            == 80


# --------------------------------------------------------------------- #
# compile watch and device memory                                       #
# --------------------------------------------------------------------- #
def test_compile_watch_counts_first_runs_of_unwarmed_shapes():
    """A warmed shape runs with no compile; an unwarmed one after
    ``mark_warm`` is one post-warmup recompile, with the JAX package's
    families and event."""
    import sys

    sys.path.insert(0, "tests")
    from test_torch_serve import _make_pred, person_maps  # noqa: F401
    from test_serve import _person_maps

    class Sink:
        def __init__(self):
            self.events = []

        def emit(self, event, **fields):
            self.events.append((event, fields))

    reg, sink = tobs.Registry(), Sink()
    watch = tobs.CompileWatch(registry=reg, sink=sink).install()
    pred = _make_pred(_person_maps())
    img = np.zeros((256, 256, 3), np.uint8)
    shapes = pred.enumerate_bucket_shapes([(256, 256)])
    fresh = pred.precompile_compact(shapes, (1,), decode=True)
    assert watch.compiles.value == fresh == 1
    watch.mark_warm("test")
    pred.predict_decoded(img)                       # warm: no event
    assert watch.recompiles.value == 0
    pred.predict_decoded(np.zeros((192, 256, 3), np.uint8))
    assert watch.recompiles.value == 1 and len(watch.timeline) == 1
    assert [e for e, _ in sink.events] == ["warmup_complete", "recompile"]
    jreg = jobs.Registry()
    jobs.CompileWatch(registry=jreg)
    names = lambda r: sorted(s[0] for s in r.iter_samples())  # noqa: E731
    assert names(reg) == names(jreg)
    assert tobs.CompileWatch is not None and tobs.COMPILE_EVENT
    watch.uninstall()
    pred.predict_decoded(np.zeros((128, 256, 3), np.uint8))
    assert watch.compiles.value == 2


def test_device_memory_zero_sampler_on_the_cpu():
    reg = tobs.Registry()
    mem = tobs.DeviceMemory(registry=reg, device="cpu")
    assert mem.sample(emit=True) == {} and not mem.supported
    assert not list(reg.iter_samples())       # nothing registered
    keep = [torch.zeros(64, 32), torch.zeros(64, 32),  # noqa: F841
            torch.ones(3, dtype=torch.int64)]
    report = mem.forensics(top=50)
    big = [g for g in report["largest"]
           if g["shape"] == [64, 32] and g["dtype"] == "torch.float32"]
    assert big and big[0]["count"] >= 2 and big[0]["bytes"] >= 2 * 8192
    assert report["live_bytes"] >= 2 * 8192
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tobs.DeviceMemory(device="cuda")
    wt = tfleet.WorkerTelemetry(0, device="cpu")
    wt.sample_memory()
    assert wt._dev_bytes == 0.0
