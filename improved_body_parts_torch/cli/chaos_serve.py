"""Fault-injection harness for fault-tolerant serving (counterpart of the
JAX package's ``tools/chaos_serve.py``)::

    python -m improved_body_parts_torch.cli.chaos_serve --strict
    python -m improved_body_parts_torch.cli.chaos_serve --config tiny \\
        --replicas 2 --requests 4 --frames 6 --device cpu --strict

A replica pool (``serve.EnginePool`` over shared-nothing
``DynamicBatcher`` replicas) serves real traffic — single-image submits,
policy-layer hedged submits and live stream sessions — while
deterministic faults are injected INTO the serving machinery, in this
order:

1. **wedged fetcher**: a replica's resolve parks; the health probe must
   see the stall, fence the replica, and the bounded drain must fail its
   in-flight work over to a healthy replica;
2. **poisoned program**: a replica's resolve raises until its
   failure-rate breaker trips; callers never see the failures, the
   replica is fenced, and after restart it re-enters through HALF-OPEN
   probation and closes its breaker;
3. **killed decode pool**: the host-pool-lane replica's decode executor
   is shut down; the fetcher's inline decode keeps it serving (no
   fence);
4. **replica hard-stop mid-stream**: a replica is stopped while
   ``StreamSession`` frames are pinned on it; every stream delivers
   every frame in order (the tracker's age stamp is the proof);
5. **latency spike**: a replica turns slow; the ``PolicyClient``'s
   hedged second dispatch fires and wins;
6. **worker SIGKILL**: a ``ProcessRouter`` worker process (the
   host-only ``serve.worker:constant_predictor``) is kill -9'd mid-batch;
   its futures resolve, the supervisor respawns a fresh pid, and the
   exhumed flight ring passes ``obs.fleet.verify_postmortem``;
7. **fastpath mid-skip-run**: streams on the temporal-coherence fast
   path are shed, migrated and hard-stopped mid-skip-run; the three-tier
   ledger balances exactly.

Teardown gates: zero lost futures (every future resolves with a result
or a typed error), 0 post-warmup first runs (``obs.CompileWatch``: the
port's compile event is a predictor's first run of an unwarmed lane
shape), no leaked thread, no leaked descendant process (the stdlib's
``resource_tracker`` exempt), and the pool's ``submitted == completed +
failed + depth``.

The model is ``build_model(--config)`` from a seeded init, wrapped in
``cli.e2e_bench.PlantedModel`` over ``--planted`` people on a canvas of
the frame's size: the whole forward runs and the maps hold decodable
people.  Every replica's ``Predictor`` comes from
:func:`replica_predictor` (one call per replica, in replica order) and
shares that one model.  Replica 1 runs the host-pool decode lane
(``device_decode=False``), the others the fused device decode.

It runs on ``--device cuda`` unless asked for ``cpu`` and raises without
a card.  Writes ``serve_chaos_torch.json`` (``--out``) and its event
stream ``<out stem>_events.jsonl``; the JAX tool's ``SERVE_CHAOS.json``
and ``SERVE_CHAOS_events.jsonl*`` are refused before any work.  Prints
``cli.exit_report``'s ``CLI_REPORT`` line last; ``--strict`` exits 1 on
any failed check.

This module also holds the harness pieces a later tool reuses, as the
JAX package's tools import them from ``tools/chaos_serve.py``:
:class:`ChaosBox`, :class:`ChaosPredictor`, :class:`LedgeredFutures` and
:func:`wait_until`.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading
import time

import numpy as np

from ..obs.events import strict_dump
from .fleet_audit import CONSTANT_SPEC

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("SERVE_CHAOS.json", "SERVE_CHAOS_events.jsonl*")

KINDS = ("wedged_fetcher", "poisoned_program", "killed_decode_pool",
         "replica_hard_stop_mid_stream", "latency_spike", "worker_sigkill",
         "fastpath_mid_skip_run")


# ------------------------------------------------------------ chaos preds
class ChaosBox:
    """Per-replica fault controls, armed / disarmed by the harness."""

    def __init__(self):
        self.lock = threading.Lock()
        self.wedge = threading.Event()   # set = wedged
        self.release = threading.Event()  # set = wedged resolves may pass
        self.poison_left = 0
        self.delay_s = 0.0

    def apply(self):
        """Runs INSIDE a wrapped resolve(), on the replica's fetch thread,
        before the resolve reads anything back from the device — the
        mid-execute injection point.  A parked fetcher holds no device
        work of its own, so the other replicas' work goes on."""
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.wedge.is_set():
            self.release.wait()          # parks the fetcher
        with self.lock:
            if self.poison_left > 0:
                self.poison_left -= 1
                raise RuntimeError(
                    "chaos: poisoned program raised mid-execute")


class ChaosPredictor:
    """Wraps a real ``Predictor``; every async dispatch's resolve() first
    passes through the replica's :class:`ChaosBox` (wedge / poison /
    delay land mid-execute, where a sick device or program would)."""

    def __init__(self, inner, box: ChaosBox):
        self._inner, self._box = inner, box

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _wrap(self, resolve):
        def wrapped():
            self._box.apply()
            return resolve()

        return wrapped

    def predict_compact_async(self, *a, **kw):
        return self._wrap(self._inner.predict_compact_async(*a, **kw))

    def predict_compact_batch_async(self, *a, **kw):
        return self._wrap(
            self._inner.predict_compact_batch_async(*a, **kw))

    def predict_decoded_async(self, *a, **kw):
        return self._wrap(self._inner.predict_decoded_async(*a, **kw))

    def predict_decoded_batch_async(self, *a, **kw):
        return self._wrap(
            self._inner.predict_decoded_batch_async(*a, **kw))


class LedgeredFutures:
    """Every future the harness hands out, so 'zero lost futures' is a
    checkable number."""

    def __init__(self):
        self._lock = threading.Lock()
        self._futs = []

    def track(self, fut, kind):
        with self._lock:
            self._futs.append((fut, kind))
        return fut

    def audit(self, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        unresolved = []
        ok = err = 0
        by_error = {}
        with self._lock:
            futs = list(self._futs)
        for fut, kind in futs:
            remaining = max(0.0, deadline - time.monotonic())
            try:
                fut.result(timeout=remaining)
                ok += 1
            except Exception as e:  # noqa: BLE001 — typed errors are a
                # RESOLUTION; only a never-resolving future is a loss
                if fut.done():
                    err += 1
                    name = type(e).__name__
                    by_error[name] = by_error.get(name, 0) + 1
                else:
                    unresolved.append(kind)
        return {"tracked": len(futs), "resolved_ok": ok,
                "resolved_error": err, "errors_by_type": by_error,
                "lost": len(unresolved), "lost_kinds": unresolved}


def wait_until(pred, timeout_s=30.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def replica_predictor(model, skeleton, boxsize, device):
    """One replica's ``Predictor`` over the shared (planted) ``model`` at
    ``boxsize`` on ``device``; called once per replica, in replica
    order."""
    from ..config import InferenceModelParams
    from ..infer import Predictor

    return Predictor(model, skeleton,
                     model_params=(InferenceModelParams(boxsize=boxsize)
                                   if boxsize else None),
                     device=device)


def proc_children():
    """Pids whose parent is this process (read from ``/proc``)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                if int(f.read().split()[3]) == os.getpid():
                    out.append(int(name))
        except (OSError, IndexError, ValueError):
            continue
    return out


def stdlib_singleton(pid):
    """True for multiprocessing's ``resource_tracker``: a process-wide
    singleton the stdlib keeps alive after the last SharedMemory is
    unlinked — not a leak."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"resource_tracker" in f.read()
    except OSError:
        return True      # reaped between the scan and the read


class Sweep:
    """The pool, its replicas and fault boxes, the ledger and the
    checks of one run; one method per injection, in the JAX tool's
    order (:data:`KINDS`)."""

    def __init__(self, args, pool, engines, boxes, telemetry, img):
        self.args, self.pool, self.engines = args, pool, engines
        self.boxes, self.telemetry, self.img = boxes, telemetry, img
        self.ledger = LedgeredFutures()
        self.failures = []

    def check(self, cond, label):
        print(("PASS " if cond else "FAIL ") + label, flush=True)
        if not cond:
            self.failures.append(label)
        return bool(cond)

    def state(self, idx):
        return self.pool.replica_states()[idx]

    # ---------------------------------------------------- 1: wedged fetcher
    def wedged_fetcher(self):
        args, pool, box, check = self.args, self.pool, self.boxes[0], \
            self.check
        t0 = time.perf_counter()
        box.wedge.set()
        futs = [self.ledger.track(pool.submit(self.img), "wedged_fetcher")
                for _ in range(args.requests)]
        results = [f.result(timeout=300) for f in futs]
        recovered_s = time.perf_counter() - t0
        fenced = wait_until(lambda: self.state(0)["state"] == "fenced",
                            timeout_s=30)
        reason = self.state(0)["fence_reason"]
        box.wedge.clear()
        box.release.set()                # unpin the parked fetcher
        time.sleep(0.1)
        box.release.clear()
        restarted = pool.restart(0)
        rec = {
            "kind": "wedged_fetcher", "futures": len(futs),
            "all_resolved_ok": all(isinstance(r, list) for r in results),
            "fenced": fenced, "fence_reason": reason,
            "restarted": restarted,
            "recovery_s": round(recovered_s, 3),
        }
        check(rec["all_resolved_ok"], "wedged: every future resolved ok")
        check(fenced and reason in ("wedged", "stopped"),
              "wedged: replica fenced by the health probe")
        check(recovered_s < args.failover_bound,
              f"wedged: recovery bounded ({recovered_s:.2f}s)")
        check(restarted, "wedged: replica restarted into routing")
        return rec

    # -------------------------------------------------- 2: poisoned program
    def poisoned_program(self):
        args, pool, box, check = self.args, self.pool, self.boxes[0], \
            self.check
        t0 = time.perf_counter()
        with box.lock:
            box.poison_left = 2 * args.requests
        # sequential closed loop: at submit time every replica is idle,
        # so the depth tie routes each first attempt to replica 0 — the
        # poisoned one — until the breaker fences it
        futs = []
        for _ in range(args.requests):
            f = self.ledger.track(pool.submit(self.img), "poisoned_program")
            f.result(timeout=300)        # raises = a LOST failover
            futs.append(f)
        recovered_s = time.perf_counter() - t0
        fenced = wait_until(lambda: self.state(0)["state"] == "fenced",
                            timeout_s=30)
        reason = self.state(0)["fence_reason"]
        with box.lock:
            box.poison_left = 0          # the program "heals"
        restarted = pool.restart(0)
        breaker_after_restart = self.state(0)["breaker"]
        # half-open probation: traffic closes the breaker again
        probed = [self.ledger.track(pool.submit(self.img), "poison_probe")
                  for _ in range(4)]
        for f in probed:
            f.result(timeout=300)
        closed = wait_until(lambda: self.state(0)["breaker"] == "closed",
                            timeout_s=30)
        rec = {
            "kind": "poisoned_program", "futures": len(futs) + len(probed),
            "fenced": fenced, "fence_reason": reason,
            "restarted": restarted,
            "breaker_after_restart": breaker_after_restart,
            "breaker_closed_after_probes": closed,
            "recovery_s": round(recovered_s, 3),
        }
        check(fenced and reason == "breaker_open",
              "poison: breaker tripped and fenced the replica")
        check(breaker_after_restart == "half_open",
              "poison: restart re-enters through half-open probation")
        check(closed, "poison: probes closed the breaker")
        check(recovered_s < args.failover_bound,
              f"poison: recovery bounded ({recovered_s:.2f}s)")
        return rec

    # ------------------------------------------------ 3: killed decode pool
    def killed_decode_pool(self):
        # replica 1 is the host-pool decode lane: its executor is load-
        # bearing.  Kill it; the fetcher's inline decode must keep the
        # replica serving — degraded, NOT fenced.
        engine, check = self.engines[1], self.check
        before = engine.metrics.completed
        engine._pool.shutdown(wait=False)
        futs = [self.ledger.track(engine.submit(self.img),
                                  "killed_decode_pool")
                for _ in range(self.args.requests)]
        results = [f.result(timeout=300) for f in futs]
        ok = all(isinstance(r, list) for r in results)
        still_live = self.state(1)["state"] == "live"
        rec = {
            "kind": "killed_decode_pool", "futures": len(futs),
            "all_resolved_ok": ok,
            "completed_before": before,
            "completed_after": engine.metrics.completed,
            "replica_still_live": still_live,
        }
        check(ok, "decode-pool: inline fallback served every request")
        check(still_live,
              "decode-pool: degraded replica stays live (no fence)")
        return rec

    # --------------------------------------- 4: replica hard-stop mid-stream
    def replica_hard_stop_mid_stream(self):
        from ..stream import SessionManager

        args, pool, check = self.args, self.pool, self.check
        t0 = time.perf_counter()
        resub_before = pool.counters()["resubmitted"]
        # slow replica 0 down so frames are pinned on it when the
        # hard-stop lands (a fast host could have drained it otherwise)
        self.boxes[0].delay_s = 0.3
        mgr = SessionManager(pool, max_in_flight=3)
        sessions = [mgr.open(f"chaos{i}") for i in range(args.streams)]
        stop_at = args.frames // 2
        per_stream = []

        def client(si):
            s = sessions[si]
            futs = []
            for t in range(args.frames):
                if si == 0 and t == stop_at:
                    # hard-stop a replica while frames are pinned on it
                    self.engines[0].stop(drain_timeout_s=0.1)
                futs.append(self.ledger.track(s.submit_frame(self.img),
                                              "stream_frame"))
            ordered = True
            delivered = 0
            for i, f in enumerate(futs):
                tracked = f.result(timeout=300)
                delivered += 1
                # static planted crowd: the tracker age stamp equals the
                # frame index IFF every earlier frame was delivered, in
                # order, exactly once — the frame-order proof
                if not all(p.age == i for p in tracked):
                    ordered = False
            per_stream.append({"stream": si, "delivered": delivered,
                               "ordered": ordered})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.boxes[0].delay_s = 0.0
        recovered_s = time.perf_counter() - t0
        fenced = wait_until(lambda: self.state(0)["state"] == "fenced",
                            timeout_s=30)
        snaps = [s.snapshot() for s in sessions]
        mgr.close_all(timeout_s=60)
        restarted = pool.restart(0)
        resubmitted = pool.counters()["resubmitted"] - resub_before
        rec = {
            "kind": "replica_hard_stop_mid_stream",
            "streams": per_stream,
            "fenced": fenced,
            "fence_reason": self.state(0)["fence_reason"],
            "restarted": restarted,
            "frames_failed": sum(s["frames_failed"] for s in snaps),
            "frames_resubmitted": resubmitted,
            "recovery_s": round(recovered_s, 3),
        }
        check(all(p["delivered"] == args.frames for p in per_stream),
              "hard-stop: every stream delivered every frame")
        check(all(p["ordered"] for p in per_stream),
              "hard-stop: frame order preserved across migration")
        check(rec["frames_failed"] == 0,
              "hard-stop: zero frame failures (failover was invisible)")
        check(resubmitted >= 1,
              "hard-stop: stranded in-flight frames were re-submitted")
        check(recovered_s < args.failover_bound,
              f"hard-stop: recovery bounded ({recovered_s:.2f}s)")
        check(restarted, "hard-stop: replica restarted into routing")
        return rec

    # ------------------------------------------------------ 5: latency spike
    def latency_spike(self):
        from ..serve import PolicyClient

        check = self.check
        self.boxes[0].delay_s = 0.4
        client = PolicyClient(self.pool, hedge_after_s=0.1, max_attempts=6)
        client.stats.register_into(self.telemetry.registry)
        # sequential closed loop: every primary lands on the (idle,
        # tie-preferred) slow replica, so every request exercises the
        # hedge path against a healthy one
        futs, lat = [], []
        for _ in range(self.args.requests):
            t0 = time.perf_counter()
            f = self.ledger.track(client.submit(self.img), "hedged_submit")
            f.result(timeout=300)
            lat.append(time.perf_counter() - t0)
            futs.append(f)
        self.boxes[0].delay_s = 0.0
        stats = client.stats.snapshot()
        rec = {
            "kind": "latency_spike", "futures": len(futs),
            "policy": stats,
            "max_wait_s": round(max(lat), 3),
        }
        check(stats["hedges"] >= 1, "latency: hedged second dispatch fired")
        check(stats["hedge_wins"] >= 1,
              "latency: a hedge beat the slow replica")
        return rec

    # ------------------------------------------------------ 6: worker SIGKILL
    def worker_sigkill(self):
        """kill -9 across the PROCESS boundary: the one fault class the
        in-process phases cannot model.  A self-contained router: the
        injection must not share fate with the in-process pool."""
        from ..obs.fleet import verify_postmortem
        from ..serve import ProcessRouter

        args, check, ledger = self.args, self.check, self.ledger
        t0 = time.perf_counter()
        small = np.zeros((48, 48, 3), np.uint8)
        router = ProcessRouter(
            CONSTANT_SPEC, num_workers=2,
            spec_kwargs={"num_parts": 18, "n_people": 2, "delay_s": 0.2},
            slots=16, max_image_hw=(64, 64), num_parts=18,
            max_people=8, restart_after_s=0.3, probe_interval_s=0.05)
        with router:
            # path probe, and the proof the target worker is serving
            ledger.track(router.submit(small),
                         "worker_sigkill_probe").result(timeout=120)
            pid0 = router.workers[0].worker_stats()["pid"]
            futs = [ledger.track(router.submit(small), "worker_sigkill")
                    for _ in range(args.requests)]
            time.sleep(0.05)             # land the kill MID-batch
            os.kill(pid0, signal.SIGKILL)
            ok = err = 0
            for f in futs:
                try:
                    f.result(timeout=120)
                    ok += 1
                except Exception:  # noqa: BLE001 — typed = resolved
                    err += 1
            recovered_s = time.perf_counter() - t0
            respawned = wait_until(
                lambda: router.workers[0].restarts >= 2, timeout_s=30)
            pid1 = router.workers[0].worker_stats()["pid"]
            post = ledger.track(router.submit(small), "worker_sigkill_post")
            # the process engine returns (people, signals) when the
            # escalation signal vector rides the response
            res = post.result(timeout=120)
            people = res[0] if isinstance(res, tuple) else res
            post_ok = isinstance(people, list) and len(people) > 0
            counters = router.counters()
            # the exhumed ring must IDENTIFY the killed batch (slot/seq +
            # last completed hop), not merely exist
            pm = router.workers[0].last_postmortem
            pm_ok, pm_problems = verify_postmortem(pm) \
                if pm is not None else (False, ["no postmortem exhumed"])
        rec = {
            "kind": "worker_sigkill",
            "in_flight_at_kill": len(futs),
            "resolved_ok": ok, "resolved_error": err,
            "killed_pid": pid0, "respawned_pid": pid1,
            "respawned": bool(respawned and pid1 != pid0),
            "worker_respawns": counters["worker_respawns"],
            "fenced": counters["fenced"],
            "failovers": counters["failovers"],
            "post_respawn_answered": post_ok,
            "recovery_s": round(recovered_s, 3),
            "postmortem_ok": pm_ok,
            "postmortem_problems": pm_problems,
            "postmortem_in_flight": (len(pm["in_flight"])
                                     if pm is not None else 0),
            "postmortem_last_hop": (pm["last_completed_hop"]
                                    if pm is not None else None),
        }
        check(ok + err == len(futs),
              "sigkill: every mid-batch future resolved")
        check(counters["fenced"] >= 1 and counters["failovers"] >= 1,
              "sigkill: pool fenced the dead worker and failed over")
        check(rec["respawned"],
              "sigkill: supervisor respawned a fresh process (new pid)")
        check(post_ok, "sigkill: respawned worker serves again")
        check(recovered_s < args.failover_bound,
              f"sigkill: recovery bounded ({recovered_s:.2f}s)")
        check(pm_ok, "sigkill: postmortem identifies the killed batch"
              + ("" if pm_ok else f" ({'; '.join(pm_problems)})"))
        return rec

    # --------------------------------------- 7: fastpath mid-skip-run
    def fastpath_mid_skip_run(self):
        """The fast path under the fault menu: a skipping stream is
        migrated mid-skip-run (parked real forwards re-submitted to a
        healthy replica, zero failures) and hard-stopped (the stranded
        real forward FAILS, the ``error`` escalation re-proves the
        scene, skipping resumes); a second stream is shed under
        drop_oldest.  The three-tier ledger must balance exactly."""
        from ..stream import FastPathConfig, SessionManager

        pool, engines, boxes, check = self.pool, self.engines, self.boxes, \
            self.check
        t0 = time.perf_counter()
        fp = FastPathConfig(max_skip_run=2, min_stable=1)
        mgr = SessionManager(engines[0], fastpath=fp)
        sess_m = mgr.open("fp_migrate", max_in_flight=4, policy="block")
        sess_s = mgr.open("fp_shed", max_in_flight=2, policy="drop_oldest")

        def drive(sess, n, wait=True, catch=False):
            futs = [self.ledger.track(sess.submit_frame(self.img),
                                      "fastpath_frame") for _ in range(n)]
            outcomes = []
            if wait:
                for f in futs:
                    try:
                        f.result(timeout=300)
                        outcomes.append("ok")
                    except Exception as e:  # noqa: BLE001 — typed
                        if not catch:
                            raise
                        outcomes.append(type(e).__name__)
            return futs, outcomes

        # a — prove skipping: sequential calm frames; with max_skip_run=2
        # every 3rd frame is a real forward
        for _ in range(5):
            drive(sess_m, 1)
        skipped_before = sess_m.fastpath.metrics.answered_tracker
        # b — migration mid-skip-run: slow replica 0 so the next owed
        # real forward PARKS, then rebind the stream to replica 1 — the
        # parked forward is re-submitted, nothing fails
        boxes[0].delay_s = 0.25
        futs_b, _ = drive(sess_m, 3, wait=False)
        time.sleep(0.05)      # let admissions land; the real forward
        moved = sess_m.migrate(engines[1])  # is parked in the delay
        for f in futs_b:
            f.result(timeout=300)
        boxes[0].delay_s = 0.0
        failed_after_migration = sess_m.fastpath.metrics.failed
        # c — hard-stop mid-skip-run: park the next real forward on
        # replica 1, then stop it with a drain too short to finish: the
        # stranded frame fails with a typed error, the fast path owes an
        # ``error`` full forward
        boxes[1].delay_s = 0.3
        futs_c, _ = drive(sess_m, 3, wait=False)
        time.sleep(0.05)                  # land the stop mid-execute
        engines[1].stop(drain_timeout_s=0.05)
        outcomes_c = []
        for f in futs_c:
            try:
                f.result(timeout=300)
                outcomes_c.append("ok")
            except Exception as e:  # noqa: BLE001 — typed resolution
                outcomes_c.append(type(e).__name__)
        boxes[1].delay_s = 0.0
        # d — recovery: back on the live replica, the owed ``error``
        # full forward re-proves the scene and skipping resumes
        sess_m.migrate(engines[0])
        for _ in range(5):
            drive(sess_m, 1)
        snap_m = sess_m.fastpath.snapshot()
        # e — shed mid-skip-run on the second stream: establish skipping,
        # then burst a slowed replica at depth 2 under drop_oldest —
        # oldest frames shed as FrameDropped (a typed resolution)
        for _ in range(5):
            drive(sess_s, 1)
        boxes[0].delay_s = 0.25
        _, outcomes_e = drive(sess_s, 9, catch=True)
        boxes[0].delay_s = 0.0
        snap_s = sess_s.fastpath.snapshot()
        mgr.close_all(timeout_s=60)
        recovered_s = time.perf_counter() - t0
        # replica 1 was hard-stopped: the pool fences it; restart it
        fenced = wait_until(lambda: self.state(1)["state"] == "fenced",
                            timeout_s=30)
        restarted = pool.restart(1)
        cons_m = {k: snap_m[k] for k in
                  ("submitted", "answered_tracker", "answered_roi",
                   "escalated_full", "failed", "dropped", "depth", "exact")}
        cons_s = {k: snap_s[k] for k in cons_m}
        rec = {
            "kind": "fastpath_mid_skip_run",
            "migrate_stream": cons_m,
            "migrate_stream_escalations": snap_m["escalations"],
            "shed_stream": cons_s,
            "shed_stream_escalations": snap_s["escalations"],
            "skipped_before_faults": skipped_before,
            "frames_migrated": moved,
            "stop_outcomes": outcomes_c,
            "shed_outcomes": outcomes_e,
            "fenced": fenced, "restarted": restarted,
            "recovery_s": round(recovered_s, 3),
        }
        check(skipped_before >= 3,
              "fastpath: tracker tier engaged before the faults")
        check(moved >= 1, "fastpath: mid-skip-run migration re-submitted "
              "parked real forwards")
        check(failed_after_migration == 0,
              "fastpath: migration was invisible (zero failures)")
        check(snap_m["failed"] == 1,
              "fastpath: hard-stop stranded exactly the parked real forward")
        check(snap_m["escalations"]["error"] >= 1,
              "fastpath: the error escalation re-proved the scene")
        check(snap_m["answered_tracker"] > skipped_before,
              "fastpath: skipping resumed after recovery")
        check(snap_s["dropped"] >= 1,
              "fastpath: backpressure shed frames into the dropped bucket")
        check(cons_m["exact"] and cons_s["exact"],
              "fastpath: three-tier conservation exact through shed + "
              "migration + hard-stop")
        check(restarted, "fastpath: replica restarted into routing")
        return rec

    def ensure_all_live(self, after_kind):
        """Between injections: only the TARGETED replica may have been
        fenced (each injection restarts it); a healthy replica fenced by
        collateral is a named failing check, and is restarted so one
        injection's fallout cannot cascade into the next verdict."""
        stray = [s for s in self.pool.replica_states()
                 if s["state"] != "live"]
        self.check(not stray, f"{after_kind}: no collateral fences "
                   f"({[(s['replica'], s['fence_reason']) for s in stray]})")
        for s in stray:
            self.pool.restart(s["replica"])


def _run(sweep, report, threads_before, children_before):
    """Warm the pool, run the injections in order, then the teardown
    gates; returns (the futures audit, the first runs after warmup)."""
    args, pool, telemetry, img = sweep.args, sweep.pool, sweep.telemetry, \
        sweep.img
    from ..stream import SessionManager

    n_rep = len(sweep.engines)
    check = sweep.check
    pool.start()
    warm = pool.warmup([(args.size, args.size)])
    # untimed warm slice over every traffic shape the phases use (pool
    # submits + stream frames), then arm the first-run watch: any first
    # run past this line is a failing number
    for f in [pool.submit(img) for _ in range(n_rep * 2)]:
        f.result(timeout=600)
    with SessionManager(pool, max_in_flight=3) as warm_mgr:
        ws = warm_mgr.open("warm")
        for f in [ws.submit_frame(img) for _ in range(4)]:
            f.result(timeout=600)
    telemetry.mark_warm("pool warmup + warm slice")
    report["warmup"] = {"newly_compiled": warm["newly_compiled"],
                        "bucket_shapes": [list(s) for s in
                                          warm["bucket_shapes"]],
                        "batch_sizes": list(warm["batch_sizes"])}
    check(all(s["state"] == "live" for s in pool.replica_states()),
          "warm pool: every replica live before the first injection "
          "(no false wedge-fence under ordinary load)")

    for kind in KINDS:
        rec = getattr(sweep, kind)()
        report["injections"].append(rec)
        sweep.ensure_all_live(rec["kind"])
        telemetry.emit("injection_done", kind=rec["kind"])
        print(f"injection {rec['kind']}: done", flush=True)

    # ----------------------------------------------------------- teardown
    # steady-state proof: after every injection + recovery, the pool
    # still serves clean traffic
    tail = [sweep.ledger.track(pool.submit(img), "steady_tail")
            for _ in range(n_rep)]
    for f in tail:
        f.result(timeout=300)
    pool.stop(drain_timeout_s=30.0)
    for b in sweep.boxes:
        b.release.set()                 # unpin anything still parked

    audit = sweep.ledger.audit()
    report["futures"] = audit
    check(audit["lost"] == 0,
          f"zero lost futures ({audit['tracked']} tracked, "
          f"{audit['resolved_ok']} ok, {audit['resolved_error']} typed "
          "errors)")

    # the warm pool must have served the WHOLE sweep — failovers,
    # restarts, migrations — with no lane shape run for the first time
    recompiles = int(telemetry.compile_watch.recompiles.value)
    report["recompiles_post_warmup"] = recompiles
    check(recompiles == 0, "0 post-warmup first runs across the sweep")

    # thread leak scan: every serving thread must be gone (the wedged
    # fetcher was released above; timers cancelled; pools shut down)
    def leaked():
        return [t.name for t in threading.enumerate()
                if t.ident not in threads_before and t.is_alive()]

    wait_until(lambda: not leaked(), timeout_s=30)
    report["leaked_threads"] = leaked()
    check(not report["leaked_threads"],
          f"no leaked threads ({report['leaked_threads']})")

    def leaked_children():
        return sorted(pid for pid in set(proc_children()) - children_before
                      if not stdlib_singleton(pid))

    wait_until(lambda: not leaked_children(), timeout_s=30)
    report["leaked_children"] = leaked_children()
    check(not report["leaked_children"], "no leaked descendants")

    report["pool_final"] = pool.snapshot()
    m = pool.metrics
    check(m.submitted == m.completed + m.failed + m.depth,
          "pool accounting conserved (submitted == completed + failed "
          "+ depth)")

    failures = sweep.failures
    report["failed_checks"] = failures
    report["checks_failed"] = len(failures)
    report["ok"] = not failures
    telemetry.emit("chaos_serve_verdict", ok=report["ok"],
                   checks_failed=len(failures))
    return audit, recompiles


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--size", type=int, default=128,
                    help="square image size of the chaos traffic")
    ap.add_argument("--boxsize", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=3,
                    help="pool replicas (>= 2 so failover has a target; "
                         "replica 1 runs the host-pool decode lane for "
                         "the killed-decode-pool injection)")
    ap.add_argument("--requests", type=int, default=6,
                    help="requests per single-image injection phase")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8,
                    help="frames per stream in the hard-stop phase")
    ap.add_argument("--planted", type=int, default=1)
    ap.add_argument("--wedge-timeout", type=float, default=8.0,
                    help="pool wedge_timeout_s (stall age before fence); "
                         "must sit WELL above the host's burst-case "
                         "batch service time or a merely-busy replica "
                         "gets false-fenced")
    ap.add_argument("--failover-bound", type=float, default=60.0,
                    help="per-injection wall bound on full recovery")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="serve_chaos_torch.json")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when any check fails")
    return ap


def main(argv=None) -> dict:
    """Run the sweep, write the artifact and print the report; returns
    it, or exits 1 under ``--strict`` when a check failed."""
    args = _parser().parse_args(argv)
    from . import refuse_artifact

    sink_path = os.path.splitext(args.out)[0] + "_events.jsonl"
    refuse_artifact(args.out, JAX_ARTIFACTS)
    refuse_artifact(sink_path, JAX_ARTIFACTS, flag="--out's event sink")

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..obs import Registry, RunTelemetry
    from ..serve import DynamicBatcher, EnginePool
    from . import card_stamp, exit_report
    from .e2e_bench import PlantedModel, planted_maps

    device = resolve_device(args.device)
    print(f"platform={device.type}", flush=True)
    cfg = get_config(args.config)
    model = build_model(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    if args.planted > 0:
        # canvas == frame size hugs the planted crowd into the frame's
        # top-left, so it DECODES at chaos sizes — the hard-stop order
        # proof (tracker age stamps) and the fastpath phase (a tracker
        # needs confirmed tracks to skip) both need real people
        model = PlantedModel(model, planted_maps(cfg.skeleton, args.planted,
                                                 rng, canvas=args.size),
                             cfg.skeleton)

    n_rep = max(2, args.replicas)
    boxes = [ChaosBox() for _ in range(n_rep)]
    # shared-nothing replicas: one Predictor per replica, each wrapped in
    # its chaos controls; replica 1 runs the HOST-POOL decode lane so the
    # killed-decode-pool injection targets a load-bearing executor
    preds = [ChaosPredictor(replica_predictor(model, cfg.skeleton,
                                              args.boxsize, device),
                            boxes[i])
             for i in range(n_rep)]
    engines = [DynamicBatcher(preds[i], max_batch=2, max_wait_ms=15,
                              max_queue=64, decode_workers=2,
                              device_decode=(i != 1))
               for i in range(n_rep)]

    telemetry = RunTelemetry(
        sink_path, registry=Registry(),
        run_meta={"tool": "chaos_serve", "config": args.config,
                  "platform": device.type},
        device=device)

    img = np.zeros((args.size, args.size, 3), np.uint8)
    report = {
        "protocol": (
            "in-process EnginePool over shared-nothing DynamicBatcher "
            "replicas serving real traffic (submits, hedged policy "
            "submits, stream sessions) while deterministic faults are "
            "injected mid-execute, plus a process-lane phase (worker "
            "SIGKILL through a ProcessRouter); every future tracked; "
            "zero-lost/bounded-failover/frame-order/leak-scan asserted"),
        "platform": device.type, "config": args.config,
        "parameters": n_params,
        "size": args.size, "replicas": n_rep,
        "requests_per_phase": args.requests,
        "streams": args.streams, "frames_per_stream": args.frames,
        "wedge_timeout_s": args.wedge_timeout,
        "telemetry_events": sink_path,
        "injections": [],
        **card_stamp(device),
    }

    # thread/descendant baseline BEFORE any serving machinery exists
    threads_before = {t.ident for t in threading.enumerate()}
    children_before = set(proc_children())

    pool = EnginePool(
        engines, probe_interval_s=0.05,
        wedge_timeout_s=args.wedge_timeout, drain_timeout_s=1.0,
        breaker_kw=dict(failure_threshold=0.5, min_requests=4,
                        window=8, cooldown_s=1.0, half_open_probes=1),
        registry=telemetry.registry)
    sweep = Sweep(args, pool, engines, boxes, telemetry, img)
    try:
        audit, recompiles = _run(sweep, report, threads_before,
                                 children_before)
    finally:
        # an aborted sweep leaves no parked thread, running pool or
        # installed sink behind (each step is idempotent)
        for b in boxes:
            b.release.set()
        pool.stop(drain_timeout_s=5.0)
        telemetry.close()
    failures = sweep.failures
    with open(args.out, "w") as f:
        strict_dump(report, f, indent=2)
    print(f"wrote {args.out}  overall: {'OK' if report['ok'] else 'FAIL'}",
          flush=True)
    exit_report("chaos_serve", device, ok=report["ok"],
                injections=[r["kind"] for r in report["injections"]],
                futures_tracked=audit["tracked"],
                futures_lost=audit["lost"],
                recompiles_post_warmup=recompiles,
                leaked_threads=len(report["leaked_threads"]),
                checks_failed=len(failures))
    if args.strict and failures:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
