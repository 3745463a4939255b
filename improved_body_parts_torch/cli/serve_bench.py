"""Closed-loop serving benchmark of the port: throughput and tail latency
against offered load, batched serving against sequential single images
(the port's counterpart of ``tools/serve_bench.py``)::

    python -m improved_body_parts_torch.cli.serve_bench --clients 1,4,8 \\
        --requests 12 --out serve_bench_torch.json
    python -m improved_body_parts_torch.cli.serve_bench --proc-only \\
        --proc-rounds 5 --requests 20 --out proc_bench_torch.json

K client threads each run a closed loop (submit → wait for the decoded
skeletons → submit the next image) against ``serve.DynamicBatcher``.  The
verdict arm compares against K clients driving
``Predictor.predict_compact`` + decode behind a global lock (the
reference's serial evaluate.py protocol exposed as it is to concurrent
callers); two stronger hand-rolled baselines are recorded too
(``sequential_overlapped``: decode outside the lock;
``sequential_concurrent``: no coordination), and
``beats_all_sequential_baselines`` compares with the best of the three.
Verdict rounds interleave the arms so drift on the host hits both alike.
Each arm reports imgs/s, p50/p95/p99 latency, batch occupancy (mean and
histogram), the per-request hop waterfall (``serve.metrics.HOPS``) and
``hop_conservation_frac`` (hop sums over end-to-end sums: the hops
partition each request's time, so it reads 1 up to rounding).  The
device-decode A/B (``decode_ab``) sets the batcher's fused lane
(forward, ``topk_peaks``, ``limb_pair_stats`` and ``greedy_assemble`` on
the card) against its host-pool lane in interleaved rounds.

The batcher serves across ``--devices N`` replicas
(``Predictor.device_replica``): cards 0..N-1, every visible card for 0,
more than are visible refused; on ``--device cpu``, N CPU replicas.  A
seeded init's maps carry ``--planted N`` synthetic people
(``cli.e2e_bench.PlantedModel``), so the decode has real work.

``--proc-only`` runs instead the thread-pool vs process-pool A/B: an
``EnginePool`` of in-process worker threads against a ``ProcessRouter``
of worker processes on the shared-memory wire, the same GIL-shaped
predictor in both (:data:`GIL_SPEC`: a GIL-held spin and a GIL-free
wait, no model), interleaved rounds and per-arm first-run accounting,
then a SIGKILL chaos arm: every future submitted across a worker's kill
resolves and the worker respawns.  Spawned workers import this module,
so importing it touches no card and parses no argument.

``--telemetry-sink`` / ``--telemetry-port`` run the bench under an
``obs.RunTelemetry`` (JSONL events; ``/metrics`` live).  The artifact
(``--out``, default ``serve_bench_torch.json``; the JAX tool's
``SERVE_BENCH.json`` and ``PROC_BENCH.json`` are refused) records the
card's name and ``nvidia-smi`` power limit and the TF32 / autocast
settings.  It runs on ``--device cuda`` unless asked for ``cpu``.
"""
from __future__ import annotations

import argparse
import os
import threading
import time

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("SERVE_BENCH.json", "PROC_BENCH.json")

#: the process arm's worker factory (spawned workers import this module)
GIL_SPEC = "improved_body_parts_torch.cli.serve_bench:gil_predictor"


def run_clients(n_clients, requests, work_fn):
    """Spawn ``n_clients`` closed-loop clients, each issuing ``requests``
    calls of ``work_fn(client_id, i)``; returns (wall_s, latencies)."""
    latencies = [[] for _ in range(n_clients)]
    errors = []

    def client(cid):
        try:
            for i in range(requests):
                t0 = time.perf_counter()
                work_fn(cid, i)
                latencies[cid].append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, [v for lat in latencies for v in lat]


def lat_summary(latencies):
    from ..utils import PercentileMeter

    m = PercentileMeter(capacity=max(len(latencies), 1))
    for v in latencies:
        m.update(v)
    return {k: round(v, 2) for k, v in m.summary(scale=1e3).items()}


def bench_sequential(pred, decode_one, images, n_clients, requests,
                     mode="serial"):
    """K clients, each a closed loop over ``predict_compact`` + decode —
    today's per-image entry point driven by concurrent callers, in three
    flavours:

    - ``serial``: a global lock around forward + decode (the reference's
      serial evaluate.py protocol exposed as-is);
    - ``overlap``: lock around the forward only, decode concurrent on
      the client threads (a strictly stronger hand-rolled baseline);
    - ``concurrent``: no coordination at all — every client calls
      ``predict_compact`` directly (the literal naive deployment).
    """
    lock = threading.Lock()

    def work(cid, i):
        img = images[(cid + i * n_clients) % len(images)]
        if mode == "concurrent":
            decode_one(pred.predict_compact(img), img)
        elif mode == "overlap":
            with lock:  # one image on the device at a time
                res = pred.predict_compact(img)
            decode_one(res, img)
        else:
            with lock:  # the serial loop: forward + decode per request
                decode_one(pred.predict_compact(img), img)

    # an untimed first run per distinct shape (cuDNN's choice, the
    # allocator's first blocks)
    for img in {im.shape: im for im in images}.values():
        decode_one(pred.predict_compact(img), img)
    wall, lats = run_clients(n_clients, requests, work)
    total = n_clients * requests
    return {"clients": n_clients, "requests": total, "mode": mode,
            "imgs_per_sec": round(total / wall, 3),
            "latency_ms": lat_summary(lats)}


def make_server(pred, params, args, use_native, n_clients, devices=None,
                registry=None, device_decode=True):
    from ..serve import DynamicBatcher

    # auto: one decode lane per client, but never more threads than
    # cores — past that they just thrash the GIL against the dispatcher
    workers = args.decode_workers or max(2, min(n_clients,
                                                os.cpu_count() or 2))
    return DynamicBatcher(pred, params, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          max_queue=args.max_queue,
                          decode_workers=workers,
                          eager_idle_flush=not args.occupancy_first,
                          use_native=use_native, devices=devices,
                          registry=registry, device_decode=device_decode)


def bench_decode_ab(pred, params, images, sizes, n_clients, requests,
                    args, use_native, devices, rounds):
    """Device-decode lane vs host-pool lane, interleaved A/B rounds.

    The two arms are the SAME batcher configuration differing only in
    ``device_decode`` — fused on-device assembly + inline finish vs the
    decode thread pool.  Rounds alternate device/host slices and the
    verdict is the median per-round ratio (the standing ROADMAP bench
    protocol: slow host drift hits both arms of a round equally, and
    the median ignores the one round a cron job stole).
    """
    out = {"rounds": rounds, "clients": n_clients,
           "requests_per_round": n_clients * requests,
           "note": "On a CPU host both lanes share the same few cores, "
                   "so the fused lane's win is the freed decode-pool "
                   "CPU only; on-chip the assembly rides the idle "
                   "accelerator while the host pool serialized on the "
                   "GIL — the margin is expected to widen there.",
           "device_imgs_per_sec": [], "host_pool_imgs_per_sec": []}
    with make_server(pred, params, args, use_native, n_clients,
                     devices=devices, device_decode=True) as dev_srv, \
            make_server(pred, params, args, use_native, n_clients,
                        devices=devices, device_decode=False) as host_srv:
        dev_srv.warmup(sizes)
        host_srv.warmup(sizes)
        for _ in range(rounds):
            dev = run_serve_slice(dev_srv, images, n_clients, requests)
            host = run_serve_slice(host_srv, images, n_clients, requests)
            out["device_imgs_per_sec"].append(dev["imgs_per_sec"])
            out["host_pool_imgs_per_sec"].append(host["imgs_per_sec"])
            print(f"decode round: device {dev['imgs_per_sec']} vs "
                  f"host-pool {host['imgs_per_sec']} imgs/s", flush=True)
        snap = dev_srv.metrics.snapshot()
        out["device_p95_ms"] = dev["latency_ms"]["p95"]
        out["host_pool_p95_ms"] = host["latency_ms"]["p95"]
    ratios = sorted(d / h for d, h in zip(out["device_imgs_per_sec"],
                                          out["host_pool_imgs_per_sec"]))
    out["per_round_ratio"] = [round(r, 3) for r in ratios]
    out["median_round_ratio"] = round(ratios[len(ratios) // 2], 3)
    out["device_decode_beats_host_pool"] = bool(
        out["median_round_ratio"] > 1.0)
    # the observable fallback rate: every request the fused lane served
    # inline vs demoted to the pool (capacity overflows)
    out["decode_fused"] = snap["decode_fused"]
    out["decode_host_fallback"] = snap["decode_host_fallback"]
    return out


def run_serve_slice(server, images, n_clients, requests):
    """One closed-loop measurement slice against a running batcher.
    Load-shed (``ServerOverloaded``) retries ride the shared policy
    helper — jittered exponential backoff, exactly what a production
    client runs — and are REPORTED, not counted as failures."""
    import threading as _threading

    from ..serve import submit_with_retry

    retries = [0]
    retries_lock = _threading.Lock()

    def work(cid, i):
        img = images[(cid + i * n_clients) % len(images)]
        fut, n = submit_with_retry(server.submit, img,
                                   base_s=0.002, max_s=0.05)
        if n:
            with retries_lock:
                retries[0] += n
        fut.result()

    wall, lats = run_clients(n_clients, requests, work)
    total = n_clients * requests
    return {"clients": n_clients, "requests": total,
            "imgs_per_sec": round(total / wall, 3),
            "latency_ms": lat_summary(lats),
            "shed_retries": retries[0]}


# --------------------------------------------------------------------- #
# thread-pool vs process-pool A/B (--proc-only)                         #
# --------------------------------------------------------------------- #
class _GilBoundPredictor:
    """Deterministic serve workload with the REAL serve-path GIL shape:
    a pure-Python accumulation loop that HOLDS the GIL (the host-side
    decode/orchestration milliseconds) followed by a blocking wait that
    RELEASES it (device execution — a sync on the card waits without
    the GIL), then the constant predictor's bit-deterministic person
    table.  This is what the thread-vs-process A/B must isolate: on a
    multi-core host the process arm buys real parallelism for the
    GIL-held part; on ANY host the thread arm additionally pays the
    GIL convoy — a worker thread waking from its device wait stalls up
    to the 5 ms switch interval behind a sibling's spin before it can
    run, while the OS preempts between processes immediately."""

    def __init__(self, num_parts=18, n_people=4, spin=80000,
                 device_s=0.025):
        from ..serve.worker import constant_predictor

        self._inner = constant_predictor(num_parts=num_parts,
                                         n_people=n_people)
        self.spin = int(spin)
        self.device_s = float(device_s)

    def serve_one(self, image):
        acc = int(image[0, 0, 0]) if image.size else 0
        for _ in range(self.spin):        # GIL-held host work
            acc = (acc * 1103515245 + 12345) & 0x7FFFFFFF
        if self.device_s:
            time.sleep(self.device_s)     # GIL-released device wait
        return self._inner.serve_one(image)


def gil_predictor(num_parts=18, n_people=4, spin=80000,
                  device_s=0.025):
    """Worker factory spec target (:data:`GIL_SPEC`) —
    the process arm's child builds its own instance; the thread arm
    calls it in-process.  Same code, same image-determined output:
    the A/B isolates WHERE ``serve_one`` runs."""
    return _GilBoundPredictor(num_parts=num_parts, n_people=n_people,
                              spin=spin, device_s=device_s)


class ThreadWorkerEngine:
    """The process worker's in-process twin: ONE predictor behind ONE
    worker thread with the same slot-bounded admission
    (``ServerOverloaded`` past ``slots``) behind the same duck-typed
    engine contract — so ``EnginePool([ThreadWorkerEngine...])`` vs
    ``ProcessRouter`` differ in exactly one variable: threads under a
    shared GIL vs processes with their own interpreters."""

    def __init__(self, pred, *, slots=8):
        import queue as queue_mod

        from ..serve import ServeMetrics

        self.pred = pred
        self.slots = slots
        self.metrics = ServeMetrics()
        self._q = queue_mod.Queue()
        self._sem = threading.BoundedSemaphore(slots)
        self._running = False
        self._draining = False
        self._thread = None

    @property
    def draining(self):
        return self._draining

    def start(self):
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="thread-worker")
        self._thread.start()
        return self

    def _loop(self):
        from ..serve import DeadlineExceeded
        from ..serve.metrics import HOPS

        while True:
            item = self._q.get()
            if item is None:
                return
            fut, img, deadline, t0, ctx = item
            try:
                t_pickup = time.perf_counter()
                if deadline is not None and t_pickup > deadline:
                    raise DeadlineExceeded("deadline expired in queue")
                res = self.pred.serve_one(img)
                t_exec1 = time.perf_counter()
                self.metrics.on_decode(fused=True)
                t_fin = time.perf_counter()
                self.metrics.on_complete(t_fin - t0)
                # the same 5-hop partition the process wire stamps, so
                # request_report's chain-coverage check holds over both
                # arms (no batch window and no separate decode step
                # here — those hops are legitimately ~0)
                ctx.finish("ok", hops=list(zip(
                    HOPS, (t_pickup - t0, 0.0, t_exec1 - t_pickup,
                           t_fin - t_exec1, 0.0))))
                fut.set_result(res)
            except BaseException as e:  # noqa: BLE001 — per request
                self.metrics.on_fail(
                    expired=type(e).__name__ == "DeadlineExceeded")
                ctx.finish(f"error:{type(e).__name__}")
                fut.set_exception(e)
            finally:
                self._sem.release()

    def submit(self, image, *, deadline_s=None):
        from concurrent.futures import Future

        from ..serve import (
            DeadlineExceeded, ServerOverloaded)

        if self._draining:
            self.metrics.on_reject()
            raise ServerOverloaded("thread worker is draining")
        if not self._running:
            raise RuntimeError("ThreadWorkerEngine is not running")
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.on_expire_rejected()
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit")
        if not self._sem.acquire(blocking=False):
            self.metrics.on_reject()
            raise ServerOverloaded(
                f"{self.slots} requests in flight (slots)")
        from ..obs.reqtrace import (
            NULL_NODE, get_reqtrace)

        rt = get_reqtrace()
        # same causal shape as the process engine's per-request node:
        # the A/B arms must pay the SAME tracing cost
        ctx = rt.begin("thread_worker") if rt.enabled else NULL_NODE
        fut = Future()
        t0 = time.perf_counter()
        self.metrics.on_submit()
        self._q.put((fut, image,
                     None if deadline_s is None else t0 + deadline_s,
                     t0, ctx))
        return fut

    def warmup(self, image_sizes, batch_sizes=None):
        return {"bucket_shapes": [], "batch_sizes": [],
                "newly_compiled": 0}

    def stop(self, drain_timeout_s=None):
        if not self._running and self._thread is None:
            return
        self._running = False
        self._draining = True
        self._q.put(None)       # after any queued work: natural drain
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(10.0 if drain_timeout_s is None
                        else drain_timeout_s)
        self._draining = False

    def health(self):
        return {"running": self._running, "draining": self._draining,
                "dispatcher_alive": bool(self._thread is not None
                                         and self._thread.is_alive()),
                "fetchers_alive": 1, "fetchers_expected": 1,
                "queue_depth": self.metrics.depth,
                "batches_in_flight": self._q.qsize(),
                "stall_age_s": self.metrics.stall_age_s()}


def bench_proc_ab(args, telemetry, rounds, before_rounds=None):
    """Thread-pool vs process-pool A/B over the SAME predictor:
    ``EnginePool`` of N in-process worker threads vs ``ProcessRouter``
    of N worker processes on the shared-memory wire.  Interleaved
    rounds, median per-round ratio verdict, and per-arm first-run
    accounting (``obs.CompileWatch``: a lane shape's first run, the
    port's compile) — with the twist that the process arm's first runs
    happen in the CHILDREN, so its delta adds every worker's own
    in-process CompileWatch count read from the heartbeat block.
    ``before_rounds`` (a callable) runs once both arms are warm, before
    the first timed round."""
    import numpy as np

    from ..serve import EnginePool
    from ..serve.router import ProcessRouter

    workers = args.proc_workers
    n_clients = 2 * workers
    slots = max(8, 2 * n_clients)
    pred_kw = {"num_parts": 18, "n_people": 4, "spin": args.proc_spin,
               "device_s": args.proc_device_ms / 1e3}
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
              for _ in range(8)]
    sizes = [(64, 64)]

    def compiles():
        return int(telemetry.compile_watch.compiles.value)

    out = {"workers": workers, "clients": n_clients, "rounds": rounds,
           "requests_per_round": n_clients * args.requests,
           "cpu_count": os.cpu_count(),
           "predictor": {"spec": GIL_SPEC, **pred_kw},
           "note": "Same predictor both arms: a GIL-held host-work "
                   "spin + a GIL-released device wait (the serve-path "
                   "shape). On a multi-core host the process arm adds "
                   "true parallelism for the GIL-held part; on a "
                   "single-core host the margin that remains is the "
                   "GIL convoy (threads wake from the device wait "
                   "into a 5 ms switch-interval stall behind a "
                   "sibling's spin; the OS preempts between processes "
                   "immediately) minus the wire's IPC cost.",
           "thread_imgs_per_sec": [], "process_imgs_per_sec": []}
    arm_recompiles = {"thread": 0, "process": 0}
    thread_pool = EnginePool(
        [ThreadWorkerEngine(gil_predictor(**pred_kw), slots=slots)
         for _ in range(workers)])
    router = ProcessRouter(GIL_SPEC,
                           num_workers=workers, spec_kwargs=pred_kw,
                           slots=slots, max_image_hw=(64, 64),
                           num_parts=18, max_people=8,
                           registry=telemetry.registry)
    th = pr = None
    with thread_pool, router:
        thread_pool.warmup(sizes)
        router.warmup(sizes)
        if before_rounds is not None:
            before_rounds()
        telemetry.mark_warm("proc A/B warmup")
        for _ in range(rounds):
            c0 = compiles()
            th = run_serve_slice(thread_pool, images, n_clients,
                                 args.requests)
            arm_recompiles["thread"] += compiles() - c0
            c0 = compiles()
            pr = run_serve_slice(router, images, n_clients,
                                 args.requests)
            arm_recompiles["process"] += compiles() - c0
            out["thread_imgs_per_sec"].append(th["imgs_per_sec"])
            out["process_imgs_per_sec"].append(pr["imgs_per_sec"])
            print(f"proc round: thread {th['imgs_per_sec']} vs "
                  f"process {pr['imgs_per_sec']} imgs/s", flush=True)
        out["thread_p95_ms"] = th["latency_ms"]["p95"]
        out["process_p95_ms"] = pr["latency_ms"]["p95"]
        out["worker_stats"] = router.worker_stats()
        arm_recompiles["process"] += sum(
            w["recompiles_post_warmup"] for w in out["worker_stats"])
        # hop waterfalls live on each ENGINE's metrics (on_hops), not
        # the pool's routing-level object; reservoir percentiles don't
        # merge exactly across workers, so commit the per-worker
        # waterfalls (matching the registry's {replica=,hop=} labels)
        # and merge only the conservation frac, which sums exactly
        wsnaps = [w.metrics.snapshot() for w in router.workers]
        # worker-VIEW readout over the shm telemetry block (the fleet
        # plane): per-worker hop quantiles measured in the process that
        # paid them, plus the cross-boundary conservation ledger —
        # router-view submitted vs Σ worker-view served + in-flight
        fleet = router.fleet_state()
    out["per_arm_recompiles_post_warmup"] = arm_recompiles
    out["process_worker_hop_quantiles_ms"] = [
        {"worker": w["worker"],
         "published": w["telemetry"].get("published", False),
         "hops_ms": {
             hop: {"count": int(h["count"]),
                   "p50": round(h["p50_s"] * 1e3, 3),
                   "p95": round(h["p95_s"] * 1e3, 3),
                   "p99": round(h["p99_s"] * 1e3, 3)}
             for hop, h in (w["telemetry"].get("hops") or {}).items()}}
        for w in fleet["workers"]]
    out["cross_boundary_conservation"] = fleet["conservation"]
    # the thread arm has no hop decomposition (no wire stamps), so
    # only the process arm gets the waterfall + conservation readout
    out["process_hops_ms_per_worker"] = [s["hops_ms"] for s in wsnaps]
    hop_sum = sum(h["sum"] for s in wsnaps for h in s["hops_ms"].values())
    e2e_sum = sum(s["latency_ms"]["mean"] * s["latency_ms"]["count"]
                  for s in wsnaps)
    out["process_hop_conservation_frac"] = (
        round(hop_sum / e2e_sum, 4) if e2e_sum > 0 else None)
    ratios = sorted(p / t for p, t in zip(out["process_imgs_per_sec"],
                                          out["thread_imgs_per_sec"]))
    out["per_round_ratio"] = [round(r, 3) for r in ratios]
    out["median_round_ratio"] = round(ratios[len(ratios) // 2], 3)
    out["multi_core_host"] = bool((os.cpu_count() or 1) > 1)
    out["process_beats_thread"] = bool(out["median_round_ratio"] >= 1.0)
    # the gate: on a multi-core host the process arm must win outright
    # (that is the point of process isolation — N workers, N cores).  A
    # single-core host cannot grant parallelism to EITHER arm, so the
    # measurable claim degrades to parity: the shm wire + process
    # isolation cost stays inside tolerance, and the QPS win waits for
    # cores (the SIGKILL-survival win is unconditional either way).
    # The tolerance is a transport-regression TRIPWIRE, not a
    # parallelism claim: the per-request isolation tax (two scheduler
    # wake hops + encode/decode + two slot-row copies) measures
    # 5-15% of a 45 ms request cycle and run-to-run medians drift
    # ±0.06 on a shared single-core host, while the transport
    # pathology this check exists to catch (an mp.Queue feeder thread
    # on each hop, caught during development and replaced with raw
    # one-way pipes) costs 25-30%.
    out["parity_tolerance"] = 0.85
    out["single_core_parity"] = bool(
        out["median_round_ratio"] >= out["parity_tolerance"])
    out["verdict_ok"] = bool(
        out["process_beats_thread"] if out["multi_core_host"]
        else out["single_core_parity"])
    return out


def chaos_router(args):
    """The chaos arm's ``ProcessRouter`` (the constant predictor holding
    each request 0.25 s), not started."""
    from ..serve.router import ProcessRouter

    return ProcessRouter(
        "improved_body_parts_torch.serve.worker:constant_predictor",
        num_workers=max(2, args.proc_workers),
        spec_kwargs={"num_parts": 18, "n_people": 2, "delay_s": 0.25},
        slots=16, max_image_hw=(64, 64), num_parts=18, max_people=8,
        restart_after_s=0.3, probe_interval_s=0.05)


def bench_proc_chaos(router):
    """SIGKILL across the process boundary mid-batch: every submitted
    future must RESOLVE (a result after pool failover, or a typed
    error — never a hang), the killed worker must come back through
    the supervisor lifecycle (>= 1 real respawn, fresh pid), and the
    fleet keeps answering afterwards.  ``router``: a
    :func:`chaos_router`, started or not (its workers may have started
    beside another arm's), stopped here."""
    import signal

    import numpy as np

    n_inflight = 6
    img = np.full((48, 48, 3), 7, dtype=np.uint8)
    with router:
        router.submit(img).result(timeout=60)       # path probe
        pid0 = router.workers[0].worker_stats()["pid"]
        futs = [router.submit(img) for _ in range(n_inflight)]
        time.sleep(0.05)                            # mid-batch
        os.kill(pid0, signal.SIGKILL)
        outcomes = {"ok": 0, "error": 0}
        for f in futs:
            try:
                f.result(timeout=60)
                outcomes["ok"] += 1
            except Exception:  # noqa: BLE001 — typed resolve counts
                outcomes["error"] += 1
        deadline = time.perf_counter() + 30
        while (router.workers[0].restarts < 2
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        router.submit(img).result(timeout=60)       # fleet answers
        stats = router.worker_stats()
        counters = router.counters()
    resolved = outcomes["ok"] + outcomes["error"]
    return {"injection": "SIGKILL worker 0 mid-batch",
            "in_flight_at_kill": n_inflight,
            "resolved": resolved,
            "resolved_ok": outcomes["ok"],
            "resolved_error": outcomes["error"],
            "all_futures_resolved": bool(resolved == n_inflight),
            "killed_pid": pid0,
            "respawned_pid": stats[0]["pid"],
            "respawned": bool(stats[0]["pid"] not in (None, pid0)
                              and stats[0]["restarts"] >= 2),
            "worker_respawns": counters["worker_respawns"],
            "fenced": counters["fenced"],
            "failovers": counters["failovers"],
            "pool_restarts": counters["restarts"],
            "post_respawn_answered": True}


def bench_serve(pred, params, images, sizes, n_clients, requests, args,
                use_native, devices=None):
    with make_server(pred, params, args, use_native, n_clients,
                     devices) as server:
        warm = server.warmup(sizes)
        out = run_serve_slice(server, images, n_clients, requests)
        snap = server.metrics.snapshot()
    out.update({
        "mean_batch_occupancy": snap["mean_batch_occupancy"],
        "occupancy_histogram": snap["occupancy_histogram"],
        "queue_depth_peak": snap["queue_depth_peak"],
        # the per-hop decomposition (queue/batch_formation/device/
        # decode/deliver) alongside the e2e numbers, plus the
        # conservation readout (hop sums / e2e sums — exact partition
        # by construction, see serve.metrics.HOPS)
        "hops_ms": snap["hops_ms"],
        "hop_conservation_frac": snap["hop_conservation_frac"],
        "warmup": {"bucket_shapes": [list(s) for s
                                     in warm["bucket_shapes"]],
                   "batch_sizes": list(warm["batch_sizes"]),
                   "newly_compiled": warm["newly_compiled"]}})
    return out

def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--sizes", default="512",
                    help="comma-separated square image sizes (mixed sizes "
                         "exercise multi-bucket coalescing)")
    ap.add_argument("--requests", type=int, default=12,
                    help="closed-loop requests per client")
    ap.add_argument("--clients", default="1,4,8",
                    help="offered-load sweep for the batched arm")
    ap.add_argument("--baseline-clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternating sequential/serve verdict rounds — "
                         "interleaving makes the comparison robust to "
                         "host load drift between arms")
    ap.add_argument("--decode-rounds", type=int, default=0,
                    help="device-decode vs host-pool A/B rounds "
                         "(0 = same as --rounds)")
    ap.add_argument("--no-decode-ab", action="store_true",
                    help="skip the device-decode vs host-pool A/B")
    ap.add_argument("--decode-only", action="store_true",
                    help="run ONLY the device-decode vs host-pool A/B; "
                         "skips the sequential baselines, the load sweep "
                         "and the batched-vs-sequential verdict")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=100.0,
                    help="coalescing deadline (the idle-device flush "
                         "makes throughput insensitive to it; it bounds "
                         "added latency under load)")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--occupancy-first", action="store_true",
                    help="disable the eager idle-device flush: only "
                         "max_batch/deadline flushes, maximizing lane "
                         "occupancy")
    ap.add_argument("--decode-workers", type=int, default=0,
                    help="0 = auto (match the client count, like the "
                         "sequential baseline's concurrent decodes)")
    ap.add_argument("--boxsize", type=int, default=0,
                    help="override InferenceModelParams.boxsize (0 = "
                         "default protocol); set to the image size to "
                         "keep CPU smoke runs small")
    ap.add_argument("--planted", type=int, default=2,
                    help="plant GT-style maps for N synthetic people "
                         "(realistic decode workload, as cli.e2e_bench)")
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32"])
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="device replicas the batcher serves across "
                         "(0 = every visible card; on --device cpu, N "
                         "CPU replicas, 0 = one)")
    ap.add_argument("--proc-only", action="store_true",
                    help="run ONLY the thread-pool vs process-pool A/B "
                         "+ the SIGKILL chaos arm; builds no model — "
                         "both arms serve the GIL-shaped predictor")
    ap.add_argument("--proc-workers", type=int, default=2,
                    help="worker count per arm of the proc A/B")
    ap.add_argument("--proc-rounds", type=int, default=0,
                    help="interleaved thread/process verdict rounds "
                         "(0 = same as --rounds)")
    ap.add_argument("--proc-spin", type=int, default=80000,
                    help="GIL-held host-work iterations per request in "
                         "the proc A/B predictor (~5 ms at default)")
    ap.add_argument("--proc-device-ms", type=float, default=40.0,
                    help="GIL-released device-wait per request in the "
                         "proc A/B predictor (a batch-inference-class "
                         "device step, so the fixed per-request isolation "
                         "tax is amortized as production traffic does)")
    ap.add_argument("--telemetry-sink", default="auto",
                    help="JSONL event stream for the run ('auto' = "
                         "<out>_events.jsonl next to --out, 'none' "
                         "disables); the path lands in the output JSON "
                         "as telemetry_events")
    ap.add_argument("--telemetry-port", type=int, default=-1,
                    help="serve /metrics + /snapshot live during the "
                         "bench (0 = ephemeral port, -1 off)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="serve_bench_torch.json")
    return ap


def main(argv=None) -> dict:
    """Run the bench and write the artifact; returns its document."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.decode_only and args.no_decode_ab:
        ap.error("--decode-only and --no-decode-ab are contradictory")

    from .. import resolve_device
    from ..obs import Registry, RunTelemetry
    from . import card_stamp, refuse_artifact
    from .stream_bench import serve_devices

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    devices = serve_devices(args.devices, device)
    print(f"platform={device.type} serve_devices={len(devices)}",
          flush=True)

    sink_path = None
    if args.telemetry_sink not in ("none", ""):
        sink_path = (os.path.splitext(args.out)[0] + "_events.jsonl"
                     if args.telemetry_sink == "auto"
                     else args.telemetry_sink)
    telemetry = RunTelemetry(
        sink_path, registry=Registry(),
        http_port=(args.telemetry_port if args.telemetry_port >= 0
                   else None),
        run_meta={"tool": "serve_bench", "config": args.config,
                  "device": device.type},
        device=device)
    if telemetry.server is not None:
        print(f"telemetry: {telemetry.server.url}/metrics", flush=True)
    report = {"platform": device.type, "config": args.config,
              "telemetry_events": sink_path, **card_stamp(device)}
    try:
        if args.proc_only:
            _proc_only(args, telemetry, report)
        else:
            _serve(args, device, devices, telemetry, report)
    finally:
        telemetry.close()
        _write(args.out, report)
    return report


def _write(path, report):
    from ..obs.events import strict_dump

    with open(path, "w") as f:
        strict_dump(report, f, indent=2)


def _proc_only(args, telemetry, report):
    """The thread-pool vs process-pool A/B and the chaos arm (no model:
    both arms serve the GIL-shaped predictor; worker processes ride the
    shm wire)."""
    from ..obs.events import strict_dumps

    report.update({
        "requests_per_client": args.requests,
        "note": "thread-pool vs process-pool A/B on the shared-memory "
                "wire + SIGKILL chaos arm; interleaved rounds, median "
                "per-round ratio verdict, per-arm first-run accounting "
                "(workers count their own first runs in-process)."})
    rounds = args.proc_rounds or max(1, args.rounds)
    # the chaos arm's workers start beside the A/B's and are up before
    # its first timed round (they idle through the rounds)
    chaos = chaos_router(args).start()
    try:
        report["proc_ab"] = bench_proc_ab(
            args, telemetry, rounds,
            before_rounds=lambda: chaos.warmup([(64, 64)]))
    except BaseException:
        chaos.stop()
        raise
    _write(args.out, report)
    telemetry.emit(
        "proc_ab", median_round_ratio=report["proc_ab"]["median_round_ratio"],
        process_beats_thread=report["proc_ab"]["process_beats_thread"])
    print(f"proc A/B: median ratio {report['proc_ab']['median_round_ratio']}"
          f" (multi_core_host={report['proc_ab']['multi_core_host']}, "
          f"verdict_ok={report['proc_ab']['verdict_ok']})", flush=True)
    report["proc_chaos"] = bench_proc_chaos(chaos)
    report["recompiles_post_warmup"] = sum(
        report["proc_ab"]["per_arm_recompiles_post_warmup"].values())
    telemetry.emit("proc_chaos", **{
        k: report["proc_chaos"][k]
        for k in ("all_futures_resolved", "resolved", "worker_respawns",
                  "failovers")})
    print(strict_dumps({
        "verdict_ok": report["proc_ab"]["verdict_ok"],
        "multi_core_host": report["proc_ab"]["multi_core_host"],
        "median_round_ratio": report["proc_ab"]["median_round_ratio"],
        "chaos_all_futures_resolved":
            report["proc_chaos"]["all_futures_resolved"],
        "chaos_respawned": report["proc_chaos"]["respawned"]}))


def _serve(args, device, devices, telemetry, report):
    """The decode A/B, the sequential baselines, the load sweep and the
    interleaved verdict over the seeded (planted) model."""
    import numpy as np

    from ..config import get_config
    from ..infer.pipeline import compact_decode_fn
    from ..obs.events import strict_dumps
    from ..serve.artifacts import checkpoint_predictor
    from . import precision_stamp
    from .e2e_bench import PlantedModel, planted_maps, synth_images

    cfg = get_config(args.config)
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in args.sizes.split(",")]
    pred = checkpoint_predictor(args.config, None,
                                params_dtype=args.params_dtype,
                                boxsize=args.boxsize, device=device)
    if args.planted > 0:
        # canvas sized so the planted people land INSIDE the valid
        # (visible) region of the benched image sizes
        canvas = max(int(max(sizes) / 0.6) + 64, 640)
        pred.model = PlantedModel(pred.model, planted_maps(
            cfg.skeleton, args.planted, rng, canvas=canvas), cfg.skeleton)
    params = pred.params
    use_native = not args.no_native

    # a handful of distinct images per size, cycled by the clients
    images = [im for s in sizes for im in synth_images(4, s, rng)]
    size_list = [(s, s) for s in sizes]
    report.update({
        "sizes": sizes, "serve_devices": len(devices),
        "precision": precision_stamp(pred.model),
        "occupancy_first": bool(args.occupancy_first),
        "note": "closed-loop clients; verdict rounds interleave the arms "
                "so host drift hits both equally.",
        "planted_people": args.planted,
        "requests_per_client": args.requests,
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
        "max_queue": args.max_queue,
        "decode_workers": args.decode_workers,
        "bucket_shapes": [list(s) for s in
                          pred.enumerate_bucket_shapes(size_list)]})

    decode_one = compact_decode_fn(pred, params, use_native=use_native)

    # --- device-decode vs host-pool A/B (interleaved rounds) ----------
    n_peak = max(int(c) for c in args.clients.split(","))
    if not args.no_decode_ab:
        decode_rounds = args.decode_rounds or max(1, args.rounds)
        report["decode_ab"] = bench_decode_ab(
            pred, params, images, size_list, n_peak, args.requests, args,
            use_native, devices, decode_rounds)
        _write(args.out, report)
        telemetry.emit("decode_ab", **{
            k: report["decode_ab"][k]
            for k in ("median_round_ratio", "device_decode_beats_host_pool",
                      "decode_fused", "decode_host_fallback")})
        print(f"decode A/B: median ratio "
              f"{report['decode_ab']['median_round_ratio']} (fused "
              f"{report['decode_ab']['decode_fused']}, fallback "
              f"{report['decode_ab']['decode_host_fallback']})", flush=True)
    if args.decode_only:
        print(strict_dumps({
            "device_decode_beats_host_pool":
                report["decode_ab"]["device_decode_beats_host_pool"],
            "median_round_ratio": report["decode_ab"]["median_round_ratio"]}))
        return

    # --- offered-load sweep (context curve) ---------------------------
    for mode, key in (("overlap", "sequential_overlapped"),
                      ("concurrent", "sequential_concurrent")):
        arm = bench_sequential(pred, decode_one, images,
                               args.baseline_clients, args.requests,
                               mode=mode)
        report[key] = arm
        _write(args.out, report)
        print(f"sequential/{mode} x{arm['clients']}: "
              f"{arm['imgs_per_sec']} imgs/s "
              f"p95={arm['latency_ms']['p95']}ms", flush=True)

    report["serve"] = []
    for n in [int(c) for c in args.clients.split(",")]:
        arm = bench_serve(pred, params, images, size_list, n,
                          args.requests, args, use_native, devices=devices)
        report["serve"].append(arm)
        _write(args.out, report)
        telemetry.emit("serve_arm", clients=n,
                       imgs_per_sec=arm["imgs_per_sec"],
                       p95_ms=arm["latency_ms"]["p95"],
                       mean_batch_occupancy=arm["mean_batch_occupancy"])
        print(f"serve x{n}: {arm['imgs_per_sec']} imgs/s "
              f"p95={arm['latency_ms']['p95']}ms "
              f"occupancy={arm['mean_batch_occupancy']}", flush=True)

    # --- verdict: interleaved rounds, batched vs sequential -----------
    # alternating A/B/A/B slices and per-arm TOTALS: slow host drift
    # (shared cores, other tenants) hits both arms equally
    seq_rounds, serve_rounds = [], []
    # the verdict server registers into the run registry: its counters
    # and latency reservoir surface on /metrics beside the first-run
    # watch — one exposition path
    with make_server(pred, params, args, use_native, n_peak,
                     devices=devices,
                     registry=telemetry.registry) as server:
        server.warmup(size_list)
        # every bucket x batch-size lane has run: a first run from here
        # on is the stall the watch exists for
        telemetry.mark_warm("serve warmup")
        for _ in range(max(1, args.rounds)):
            seq_rounds.append(bench_sequential(
                pred, decode_one, images, args.baseline_clients,
                args.requests))
            serve_rounds.append(run_serve_slice(
                server, images, n_peak, args.requests))
            print(f"round: sequential {seq_rounds[-1]['imgs_per_sec']} vs "
                  f"serve {serve_rounds[-1]['imgs_per_sec']} imgs/s",
                  flush=True)
        verdict_snap = server.metrics.snapshot()
        completed = server.metrics.completed_by_replica()

    def total_fps(rounds):
        n = sum(r["requests"] for r in rounds)
        return round(n / sum(r["requests"] / r["imgs_per_sec"]
                             for r in rounds), 3)

    seq_fps, serve_fps = total_fps(seq_rounds), total_fps(serve_rounds)
    report["sequential"] = {**seq_rounds[0], "imgs_per_sec": seq_fps,
                            "per_round_imgs_per_sec":
                            [r["imgs_per_sec"] for r in seq_rounds]}
    report["serve_at_peak_load"] = {
        **serve_rounds[-1], "imgs_per_sec": serve_fps,
        "per_round_imgs_per_sec": [r["imgs_per_sec"] for r in serve_rounds],
        # sheds the clients absorbed with jittered backoff
        "shed_retries_total": sum(r["shed_retries"] for r in serve_rounds),
        "mean_batch_occupancy": verdict_snap["mean_batch_occupancy"],
        "occupancy_histogram": verdict_snap["occupancy_histogram"],
        "queue_depth_peak": verdict_snap["queue_depth_peak"],
        # per-hop p50/p95/p99 over the interleaved verdict rounds
        "hops_ms": verdict_snap["hops_ms"],
        "hop_conservation_frac": verdict_snap["hop_conservation_frac"]}
    report["serve_replica_completed"] = {str(r): n
                                         for r, n in completed.items()}
    report["batched_beats_sequential"] = bool(serve_fps > seq_fps)
    report["speedup_at_peak_load"] = round(serve_fps / seq_fps, 3)
    strongest = max(seq_fps,
                    report["sequential_overlapped"]["imgs_per_sec"],
                    report["sequential_concurrent"]["imgs_per_sec"])
    report["beats_all_sequential_baselines"] = bool(serve_fps > strongest)
    # a first run during the verdict rounds means the warmup missed a
    # shape the traffic hit
    report["recompiles_post_warmup"] = int(
        telemetry.compile_watch.recompiles.value)
    telemetry.emit("serve_verdict", sequential_imgs_per_sec=seq_fps,
                   serve_imgs_per_sec=serve_fps,
                   batched_beats_sequential=report[
                       "batched_beats_sequential"])
    print(strict_dumps({"batched_beats_sequential":
                        report["batched_beats_sequential"],
                        "speedup": report["speedup_at_peak_load"]}))


if __name__ == "__main__":
    main()
