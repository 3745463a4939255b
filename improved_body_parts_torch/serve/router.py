"""Process-isolated serving: worker processes behind the pool's router.

:class:`ProcessWorkerEngine` presents ONE worker process through the
exact duck-typed engine contract `serve.pool` / `serve.policy` /
`serve.cascade` / `stream` already consume (``submit(image,
deadline_s=) -> Future``, ``health()``, ``warmup()``, ``stop()``,
``start()``, ``draining``, ``metrics``) — so
:class:`~improved_body_parts_torch.serve.pool.EnginePool`'s fence /
failover / breaker logic carries over UNCHANGED above the process
boundary.  :class:`ProcessRouter` is the deployment shape: N worker
processes, one ``EnginePool`` over their proxies, one merged metrics /
``/slo`` surface.

Transport is the shared-memory wire (``serve.worker``): images in
and fixed-shape person tables out through preallocated slot rows under
per-slot seqlocks; only ``(kind, slot, seq)`` tokens cross a pair of
raw one-way ``multiprocessing.Pipe`` connections (NOT ``mp.Queue`` —
a Queue interposes a feeder thread on every hop, and on a busy host
each request pays two extra scheduler wake round-trips; a bare pipe
sends the token synchronously in the caller).

Worker lifecycle is the run supervisor's discipline, per process:

- a SIGKILLed / crashed worker fails its in-flight futures with
  :class:`~improved_body_parts_torch.data.shm_ring.WorkerDied` — the pool
  records the failure, fences the replica and RESUBMITS the work to a
  healthy one (zero lost futures across a kill -9);
- ``start()`` (the pool's restart path) respawns with exponential
  backoff on consecutive no-progress failures and a crash budget that
  stops a deterministic crash loop from spinning forever — a worker
  that exhausts it stays down (``health()["running"] = False``) and the
  pool keeps it fenced;
- respawn REPLACES the pipes and the shared-memory region (a process
  killed mid-write can leave a half-written token in the channel,
  poisoning it for every later reader — the ``data.shm_ring`` rebuild
  rule).
"""
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import multiprocessing as mp

import numpy as np

from ..data.shm_ring import WorkerDied, _quiet_close, _slot_views
from ..obs.events import get_sink
from ..obs.fleet import (
    FleetRegistry,
    build_postmortem,
    flow_id,
    read_block,
    read_flight_records,
)
from ..obs.reqtrace import NULL_NODE, get_reqtrace
from ..obs.trace import get_tracer
from .batcher import DeadlineExceeded, ServerOverloaded
from .metrics import HOPS, ServeMetrics
from .pool import EnginePool
from .worker import (
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    decode_people,
    hb_view,
    rec_view,
    region_size,
    telem_view,
    wire_format,
    worker_main,
)


def _prebuild_kernels(spec_kwargs_json: str) -> None:
    """Build the CUDA kernels in THIS process before a worker is spawned
    for a card, so that workers only load the libraries: ``ops/_build``
    serializes its ``nvcc`` runs with a thread lock only, and two workers
    starting cold would each compile.  Nothing happens for a worker whose
    factory kwargs ask for the CPU, or on a host without a card (there
    the worker's own predictor raises for ``cuda``)."""
    device = str(json.loads(spec_kwargs_json).get("device", "cuda"))
    if not device.startswith("cuda"):
        return
    import torch

    if torch.cuda.is_available():
        from ..ops import _build

        _build.build_all()


class _ProcReq:
    """One in-flight request pinned to a slot row."""

    __slots__ = ("future", "ctx", "rid", "deadline", "t_submit",
                 "finished", "seq")

    def __init__(self, deadline_s: Optional[float]):
        self.future: Future = Future()
        self.ctx = NULL_NODE
        self.rid = ""
        self.t_submit = time.perf_counter()
        self.deadline = (None if deadline_s is None
                         else self.t_submit + deadline_s)
        self.finished = False
        self.seq = 0


class ProcessWorkerEngine:
    """One worker process behind the engine contract.

    ``spec`` is the worker predictor factory (``"module:callable"``)
    and ``spec_kwargs`` its JSON-safe kwargs — the CHILD builds the
    predictor, so the parent never pickles model state.  ``slots``
    bounds admission exactly like the batcher's ``max_queue``
    (``ServerOverloaded`` past it); ``max_image_hw`` / ``num_parts`` /
    ``max_people`` fix the wire layout.  ``telemetry=False`` spawns the
    worker with its telemetry off (only the heartbeat moves: the fleet
    A/B's OFF arm); ``trace_path`` is the worker's span-shard file.
    """

    def __init__(self, spec: str, spec_kwargs: Optional[dict] = None, *,
                 slots: int = 8,
                 max_image_hw: Tuple[int, int] = (512, 512),
                 num_parts: int = 18, max_people: int = 64,
                 max_batch: int = 4,
                 worker_idx: int = 0,
                 sink_path: Optional[str] = None,
                 heartbeat_timeout_s: float = 30.0,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 crash_budget: int = 5,
                 warmup_timeout_s: float = 300.0,
                 metrics: Optional[ServeMetrics] = None,
                 registry=None,
                 telemetry: bool = True,
                 trace_path: Optional[str] = None):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        self.spec = spec
        # allow_nan=False (JGL004): a non-finite kwarg would cross the
        # process boundary as a bare NaN token the child can't parse
        self.spec_kwargs_json = json.dumps(spec_kwargs or {},
                                           allow_nan=False)
        self.slots = slots
        self.names, self.shapes, self.dtypes = wire_format(
            max_image_hw, num_parts, max_people)
        self.max_image_hw = tuple(max_image_hw)
        self.max_batch = max_batch
        self.worker_idx = worker_idx
        self.sink_path = sink_path
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.crash_budget = crash_budget
        self.warmup_timeout_s = warmup_timeout_s
        self.telemetry = bool(telemetry)
        self.trace_path = trace_path
        self.metrics = metrics or ServeMetrics()
        if registry is not None:
            self.metrics.register_into(registry)
        self._ctx = mp.get_context("spawn")
        self._lock = threading.Lock()
        self._finish_lock = threading.Lock()
        self._pending: Dict[int, _ProcReq] = {}
        self._free: List[int] = []
        self._slots_sem = threading.BoundedSemaphore(slots)
        self._running = False
        self._draining = False
        self._gen = 0
        self._seq = 0
        self._proc = None
        self._shm = None
        self._header = None
        self._views = None
        self._hb = None
        self._telem = None      # worker telemetry block (read-only)
        self._rec = None        # flight-recorder ring (read-only)
        #: the last exhumed ``worker_postmortem`` record (None until a
        #: worker death is detected with the ring attached)
        self.last_postmortem: Optional[dict] = None
        self._backing_off = False
        # scrape-path liveness cache: ``worker_info`` is read per
        # history/metrics tick and ``proc.is_alive()`` is a waitpid
        # syscall (~ms under load on a loaded host); the reporting view
        # tolerates sub-second staleness — death DETECTION stays with
        # the probe loop, which reads ``proc.is_alive()`` directly.
        # Keyed on the proc object so a respawn invalidates it.
        self._alive_cache = (None, 0.0, False)
        self._task_tx = None    # parent write end of the task pipe
        self._done_rx = None    # parent read end of the done pipe
        # multiple client threads write the task channel; pipe sends
        # are NOT atomic across writers, so serialize them
        self._send_lock = threading.Lock()
        self._fetcher: Optional[threading.Thread] = None
        self._stop_lock = threading.Lock()
        # supervisor discipline: consecutive starts without a single
        # completed request; any success resets it
        self.consecutive_failures = 0
        self.restarts = 0
        self.gave_up = False
        self._warmup_box: Dict[str, object] = {}
        self._warmup_evt = threading.Event()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ProcessWorkerEngine":
        """(Re)spawn the worker: fresh shared-memory region, fresh
        pipes, fresh fetcher — the pool's ``restart()`` lands here.
        Applies the backoff/crash-budget discipline on consecutive
        no-progress respawns; past the budget the engine stays down
        (the pool keeps it fenced) instead of crash-looping."""
        with self._lock:
            if self._running:
                return self
            if self.consecutive_failures >= self.crash_budget:
                if not self.gave_up:
                    self.gave_up = True
                    get_sink().emit("worker_gave_up",
                                    worker=self.worker_idx,
                                    failures=self.consecutive_failures)
                return self
            self._gen += 1
            gen = self._gen
        if self.consecutive_failures > 0:
            self._backing_off = True
            try:
                time.sleep(min(self.backoff_base_s
                               * 2 ** (self.consecutive_failures - 1),
                               self.backoff_max_s))
            finally:
                self._backing_off = False
        self._teardown_transport()
        _prebuild_kernels(self.spec_kwargs_json)
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(
            create=True,
            size=region_size(self.slots, self.shapes, self.dtypes))
        shm.buf[:] = b"\x00" * len(shm.buf)
        # raw one-way pipes: worker reads tasks from task_r, parent
        # reads done-tokens from done_r; no feeder threads anywhere
        task_r, task_w = self._ctx.Pipe(duplex=False)
        done_r, done_w = self._ctx.Pipe(duplex=False)
        # the parent run's identity rides into the worker shard header
        # so the report tools can match shards to THIS run (and skip a
        # stray shard from another one loudly)
        run_id = (getattr(get_sink(), "run_meta", None)
                  or {}).get("run_id")
        proc = self._ctx.Process(
            target=worker_main,
            args=(self.worker_idx, shm.name, self.slots, self.shapes,
                  self.dtypes, self.spec, self.spec_kwargs_json,
                  task_r, done_w, os.getpid(), self.sink_path,
                  self.max_batch, self.telemetry, self.trace_path,
                  run_id),
            name=f"serve-worker-{self.worker_idx}", daemon=True)
        proc.start()
        # drop the parent's copies of the child-side ends so a dead
        # worker surfaces as EOF on done_r instead of a silent stall
        task_r.close()
        done_w.close()
        header, views = _slot_views(shm.buf, self.slots, self.shapes,
                                    self.dtypes, writeable=True)
        with self._lock:
            self._shm, self._header, self._views = shm, header, views
            self._hb = hb_view(shm.buf, self.slots, self.shapes,
                               self.dtypes, writeable=False)
            self._telem = telem_view(shm.buf, self.slots, self.shapes,
                                     self.dtypes, writeable=False)
            self._rec = rec_view(shm.buf, self.slots, self.shapes,
                                 self.dtypes, writeable=False)
            self._task_tx, self._done_rx = task_w, done_r
            self._proc = proc
            self._free = list(range(self.slots))
            self._pending = {}
            self._slots_sem = threading.BoundedSemaphore(self.slots)
            self._running = True
            self._draining = False
            self.restarts += 1
        fetcher = threading.Thread(target=self._fetch_loop,
                                   args=(gen, proc, done_r),
                                   name=f"proc-fetch-{self.worker_idx}",
                                   daemon=True)
        fetcher.start()
        self._fetcher = fetcher
        get_sink().emit("worker_spawned", worker=self.worker_idx,
                        pid=proc.pid, respawn=self.restarts - 1)
        return self

    def _teardown_transport(self) -> None:
        """Drop the previous generation's transport.  Pipes are
        REPLACED, never reused: a worker killed mid-write can leave a
        torn token that corrupts the stream for every later recv."""
        with self._lock:
            proc, self._proc = self._proc, None
            shm, self._shm = self._shm, None
            task_tx, self._task_tx = self._task_tx, None
            done_rx, self._done_rx = self._done_rx, None
            self._header = self._views = self._hb = None
            self._telem = self._rec = None
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(5.0)
        for conn in (task_tx, done_rx):
            if conn is not None:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001 — already torn by a
                    pass           # SIGKILL; close is best-effort
        if shm is not None:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            _quiet_close(shm)

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Bounded graceful stop: admission closes, in-flight slots get
        their bounded drain, stragglers fail explicitly, the worker
        gets the poison pill then SIGTERM.  Idempotent; concurrent
        callers serialize (the batcher's stop discipline)."""
        with self._stop_lock:
            self._stop_locked(drain_timeout_s)

    def _stop_locked(self, drain_timeout_s: Optional[float]) -> None:
        with self._lock:
            if not self._running and self._proc is None:
                return
            was_running, self._running = self._running, False
            self._draining = True
            proc, task_tx, rec = self._proc, self._task_tx, self._rec
            in_flight = [(idx, req.seq)
                         for idx, req in self._pending.items()]
        if was_running and proc is not None and not proc.is_alive():
            # the worker died before this stop reached it: the pool's
            # probe saw the dead process and fenced the replica before
            # the fetcher reported the death, and the fetcher now finds
            # the engine stopped.  Exhume the flight ring here, before
            # the teardown unmaps it.
            proc.join(1.0)
            with self._lock:
                self.consecutive_failures += 1
            self._exhume(proc, rec, in_flight)
        deadline = (None if drain_timeout_s is None
                    else time.perf_counter() + drain_timeout_s)
        while self._pending_count():
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if proc is not None and not proc.is_alive():
                break
            time.sleep(0.005)
        for req in self._take_pending():
            self._finish(req, error=RuntimeError(
                "process worker stopped before completion"))
        if task_tx is not None:
            try:
                with self._send_lock:
                    task_tx.send(None)  # poison pill: clean worker exit
            except Exception:  # noqa: BLE001 — pipe torn by a crash
                pass
        if proc is not None:
            proc.join(2.0 if deadline is None
                      else max(0.1, deadline - time.perf_counter()))
        self._teardown_transport()
        fetcher, self._fetcher = self._fetcher, None
        if fetcher is not None and fetcher is not threading.current_thread():
            fetcher.join(5.0)
        with self._lock:
            self._draining = False

    def __enter__(self) -> "ProcessWorkerEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def submit(self, image, *,
               deadline_s: Optional[float] = None) -> Future:
        """Write one request into a free slot row and hand the worker
        its token; returns a future resolving to the decoded people (or
        ``(people, signals)`` — the signal vector rides every response,
        so the cascade's escalation input costs nothing extra).

        Same refusal contract as ``DynamicBatcher.submit``:
        :class:`ServerOverloaded` when all slots are in flight or the
        engine drains, :class:`DeadlineExceeded` for a dead-on-arrival
        deadline, ``RuntimeError`` when not running."""
        if self._draining:
            self.metrics.on_reject()
            raise ServerOverloaded(
                "process worker is draining (shutdown in progress); "
                "retry against a live instance")
        if not self._running:
            raise RuntimeError("ProcessWorkerEngine is not running "
                               "(use `with engine:` or call start())")
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.on_expire_rejected()
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit")
        image = np.ascontiguousarray(image, dtype=np.uint8)
        h, w = image.shape[:2]
        mh, mw = self.max_image_hw
        if image.ndim != 3 or image.shape[2] != 3 or h > mh or w > mw:
            raise ValueError(
                f"image shape {image.shape} exceeds the worker wire "
                f"bucket {(mh, mw, 3)} (set max_image_hw)")
        if not self._slots_sem.acquire(blocking=False):
            self.metrics.on_reject()
            raise ServerOverloaded(
                f"{self.slots} requests in flight (slots); retry "
                "with backoff")
        req = _ProcReq(deadline_s)
        rt = get_reqtrace()
        if rt.enabled:
            # root for a bare client; child of the routing layer's node
            # (pool route / policy attempt / cascade lane) when this
            # submit runs inside its child_scope
            req.ctx = rt.begin("proc", worker=self.worker_idx)
        with self._lock:
            if not self._running or not self._free:
                # raced a stop/crash between the flag check and here
                self._slots_sem.release()
                req.ctx.finish("error:ServerOverloaded")
                self.metrics.on_reject()
                raise ServerOverloaded("process worker stopped")
            idx = self._free.pop()
            self._seq += 2
            req.seq = self._seq
            self._pending[idx] = req
            header, views, task_tx = (self._header, self._views,
                                      self._task_tx)
        tracer = get_tracer()
        tr0 = tracer.now() if tracer.enabled else 0.0
        img_v, meta_in = views[idx][0], views[idx][1]
        header[idx, 0] = req.seq - 1        # odd: router writing
        img_v[:h, :w] = image
        meta_in[0], meta_in[1] = float(h), float(w)
        meta_in[2] = 0.0 if req.deadline is None else req.deadline
        meta_in[3] = req.t_submit
        header[idx, 0] = req.seq            # even: consistent
        self.metrics.on_submit()
        try:
            with self._send_lock:
                task_tx.send(("req", idx, req.seq))
        except Exception as e:  # noqa: BLE001 — pipe torn by a crash
            self._finish(req, error=WorkerDied(
                f"serve worker {self.worker_idx} pipe unusable: {e}"),
                idx=idx)
        if tracer.enabled:
            # the router half of the cross-process flow arc: one
            # proc_submit slice (slot write + token send) starting the
            # (cat="proc", flow_id) arc the worker's serve slice steps
            # and the deliver slice finishes
            tr1 = tracer.now()
            rtrack = f"router-w{self.worker_idx}"
            tracer.add_span_rel("proc_submit", tr0,
                                max(tr1 - tr0, 1e-7), track=rtrack,
                                args={"slot": idx, "seq": req.seq,
                                      "worker": self.worker_idx})
            tracer.flow_start("req",
                              flow_id(self.worker_idx, idx, req.seq),
                              track=rtrack, cat="proc",
                              ts=(tr0 + tr1) / 2.0)
        return req.future

    # ------------------------------------------------------------- warmup
    def warmup(self, image_sizes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> dict:
        """Ask the worker to precompile its bucket programs (and arm
        its own in-process CompileWatch); blocks for the ack."""
        with self._lock:
            if not self._running:
                raise RuntimeError("ProcessWorkerEngine is not running")
            task_tx = self._task_tx
        self._warmup_evt.clear()
        self._warmup_box.clear()
        with self._send_lock:
            task_tx.send(("warmup", [tuple(s) for s in image_sizes],
                          None if batch_sizes is None
                          else list(batch_sizes)))
        if not self._warmup_evt.wait(self.warmup_timeout_s):
            raise RuntimeError(
                f"serve worker {self.worker_idx} warmup did not ack "
                f"within {self.warmup_timeout_s}s")
        if "error" in self._warmup_box:
            raise RuntimeError("serve worker warmup failed:\n"
                               + str(self._warmup_box["error"]))
        return dict(self._warmup_box.get("info", {}))

    # ------------------------------------------------------------- health
    @property
    def draining(self) -> bool:
        return self._draining

    def health(self) -> dict:
        """The pool-probe health contract.  ``dispatcher_alive`` maps
        to the worker PROCESS (additionally gated on heartbeat
        freshness: a live-but-wedged worker reads as dead once its
        heartbeat goes stale), ``fetchers_alive`` to the response
        fetcher thread."""
        with self._lock:
            proc, hb = self._proc, self._hb
            fetcher = self._fetcher
            running, draining = self._running, self._draining
            depth = len(self._pending)
        alive = proc is not None and proc.is_alive()
        if alive and hb is not None and self.heartbeat_timeout_s:
            last = float(hb[0])
            if last > 0.0 and (time.perf_counter() - last
                               > self.heartbeat_timeout_s):
                alive = False
        return {"running": running, "draining": draining,
                "dispatcher_alive": alive,
                "fetchers_alive": int(fetcher is not None
                                      and fetcher.is_alive()),
                "fetchers_expected": 1,
                "queue_depth": self.metrics.depth,
                "batches_in_flight": depth,
                "stall_age_s": self.metrics.stall_age_s()}

    def worker_stats(self) -> dict:
        """Heartbeat-block readout: pid, served count and the worker's
        OWN post-warmup recompile count (compiles happen in the child;
        the parent's CompileWatch cannot see them)."""
        with self._lock:
            hb, proc = self._hb, self._proc
        if hb is None:
            return {"pid": None, "served": 0,
                    "recompiles_post_warmup": 0, "restarts": self.restarts}
        return {"pid": proc.pid if proc is not None else None,
                "served": int(hb[1]),
                "recompiles_post_warmup": int(hb[2]),
                "restarts": self.restarts}

    # ------------------------------------------------------ fleet readout
    def telem_read(self):
        """Seqlock-consistent copy of the worker's telemetry block (or
        ``None``: no transport / torn) — ``obs.fleet.decode_telem``'s
        input, the ``FleetRegistry`` merge source."""
        with self._lock:
            telem = self._telem
        if telem is None:
            return None
        return read_block(telem)

    def worker_info(self) -> dict:
        """The router-side half of the fleet merge: liveness, lifecycle
        counters, crash budget, in-flight ledger and the router-view
        submit/complete counts the conservation check compares against
        the worker's served counter."""
        with self._lock:
            proc, hb = self._proc, self._hb
            running = self._running
            in_flight = len(self._pending)
        c_proc, c_t, c_alive = self._alive_cache
        now = time.perf_counter()
        if proc is c_proc and now - c_t < 0.5:
            alive = c_alive
        else:
            alive = proc is not None and proc.is_alive()
            self._alive_cache = (proc, now, alive)
        hb_stamp = float(hb[0]) if hb is not None else 0.0
        hb_age = (max(0.0, time.perf_counter() - hb_stamp)
                  if hb_stamp > 0.0 else None)
        m = self.metrics
        return {
            "worker": self.worker_idx,
            "pid": proc.pid if proc is not None else None,
            "alive": alive,
            "running": running,
            "backing_off": self._backing_off,
            "gave_up": self.gave_up,
            "consecutive_failures": self.consecutive_failures,
            "crash_budget": self.crash_budget,
            "restarts": self.restarts,
            "in_flight": in_flight,
            "submitted": m.submitted,
            "completed": m.completed,
            "failed": m.failed,
            "hb_age_s": round(hb_age, 3) if hb_age is not None else None,
            "hb_served": int(hb[1]) if hb is not None else 0,
            "hb_recompiles": int(hb[2]) if hb is not None else 0,
        }

    def flight_records(self) -> dict:
        """Exhume the flight-recorder ring (tolerant of a torn write —
        see ``obs.fleet.read_flight_records``)."""
        with self._lock:
            rec = self._rec
        if rec is None:
            return {"records": [], "count": 0, "torn": False}
        return read_flight_records(rec)

    # ------------------------------------------------------------ fetcher
    def _fetch_loop(self, gen: int, proc, done_rx) -> None:
        """Drain the worker's done pipe; detect death.  Generation-
        bound: a fetcher from a previous spawn must never touch the
        rebuilt transport."""
        while True:
            with self._lock:
                if gen != self._gen:
                    return
                running = self._running
            if not running and not self._pending_count():
                return
            try:
                if not done_rx.poll(0.2):
                    if not proc.is_alive():
                        self._on_worker_death(gen)
                        return
                    continue
                token = done_rx.recv()
            except EOFError:
                # write end closed: the worker died (SIGKILL/crash)
                self._on_worker_death(gen)
                return
            except (OSError, ValueError):
                # pipe closed under us by a teardown
                return
            kind = token[0]
            if kind == "done":
                self._on_done(gen, token[2], token[3])
            elif kind == "warmup_done":
                self._warmup_box["info"] = token[2]
                self._warmup_evt.set()
            elif kind in ("warmup_err", "init_err"):
                self._warmup_box["error"] = token[2]
                self._warmup_evt.set()
                if kind == "init_err":
                    get_sink().emit("worker_init_error",
                                    worker=self.worker_idx,
                                    error=str(token[2])[-400:])
                    self._on_worker_death(gen)
                    return

    def _on_done(self, gen: int, idx: int, seq: int) -> None:
        with self._lock:
            if gen != self._gen:
                return
            req = self._pending.get(idx)
            if req is None or req.seq != seq:
                return              # stale token from a torn rebuild
            views, header = self._views, self._header
        if int(header[idx, 0]) != seq + 2:
            # torn response (worker died mid-write): leave the request
            # pending; death detection fails it into pool failover
            return
        _, _, kps, scores, sig, meta_out, err = views[idx]
        status = float(meta_out[0])
        if status == STATUS_OK:
            people, signals = decode_people(kps, scores, sig)
            result = (people, signals) if signals is not None else people
            stamps = (float(meta_out[2]), float(meta_out[3]),
                      float(meta_out[4]), float(meta_out[5]))
            self._finish(req, result=result, idx=idx, stamps=stamps)
        elif status == STATUS_EXPIRED:
            self._finish(req, error=DeadlineExceeded(
                "deadline expired before the worker served it"),
                idx=idx)
        else:
            msg = (bytes(err[err != 0].tobytes()).decode(
                       "utf-8", "replace")
                   if status == STATUS_ERROR
                   else f"unknown wire status {status}")
            self._finish(req, error=RuntimeError(
                f"serve worker {self.worker_idx} error:\n{msg}"),
                idx=idx)

    def _on_worker_death(self, gen: int) -> None:
        """The worker process died (SIGKILL, OOM, segfault): fail every
        in-flight future with ``WorkerDied`` — the pool's failover
        resubmits them — and leave ``running=False`` so the probe
        fences this replica until ``restart()`` respawns it."""
        with self._lock:
            if gen != self._gen or not self._running:
                return
            proc = self._proc
        if proc is not None:
            # the done channel's EOF can come before the dead process
            # is reaped; wait for the exit status the postmortem names
            proc.join(1.0)
        with self._lock:
            if gen != self._gen or not self._running:
                return
            self._running = False
            self.consecutive_failures += 1
            rec = self._rec
            in_flight = [(idx, req.seq)
                         for idx, req in self._pending.items()]
        # exhume the flight recorder BEFORE failing the futures
        exitcode = self._exhume(proc, rec, in_flight)
        err = WorkerDied(
            f"serve worker {self.worker_idx} died "
            f"(exitcode={exitcode}) with work in flight")
        for req in self._take_pending():
            self._finish(req, error=err)

    def _exhume(self, proc, rec, in_flight) -> Optional[int]:
        """A dead worker's postmortem (``last_postmortem`` and the
        ``worker_postmortem`` event) and its ``worker_died`` event, from
        the flight ring ``rec``; returns its exit code.  The ring names
        the in-flight slot/seq and the last hop the dead worker
        completed — a SIGKILL leaves no other trace.  The region
        outlives the process (the parent still maps it), and the reader
        tolerates a permanently-odd parity from a kill mid-write
        (torn=True, best-effort copy)."""
        exitcode = proc.exitcode if proc is not None else None
        pid = proc.pid if proc is not None else None
        try:
            flight = (read_flight_records(rec) if rec is not None
                      else {"records": [], "count": 0, "torn": False})
            pm = build_postmortem(self.worker_idx, pid, exitcode,
                                  flight, in_flight)
            self.last_postmortem = pm
            get_sink().emit("worker_postmortem", **pm)
        except Exception:  # noqa: BLE001 — forensics must never block
            pass           # the failover path
        get_sink().emit("worker_died", worker=self.worker_idx,
                        exitcode=exitcode, in_flight=len(in_flight))
        return exitcode

    # ------------------------------------------------------------- finish
    def _pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def _take_pending(self) -> List[_ProcReq]:
        with self._lock:
            reqs = list(self._pending.values())
            self._pending.clear()
            self._free = list(range(self.slots))
        return reqs

    def _finish(self, req: _ProcReq, result=None, error=None,
                idx: Optional[int] = None,
                stamps: Optional[tuple] = None) -> None:
        """Resolve one request exactly once: metrics, future, slot.
        The batcher's once-flag discipline — a drain failing a request
        that a late done-token then completes must no-op."""
        with self._finish_lock:
            if req.finished:
                return
            req.finished = True
        if idx is not None:
            with self._lock:
                if self._pending.get(idx) is req:
                    del self._pending[idx]
                    self._free.append(idx)
        t_fin = time.perf_counter()
        if error is None and stamps is not None:
            # consecutive boundary stamps partition submit→finish into
            # the five serve hops exactly (the conservation contract);
            # worker stamps share CLOCK_MONOTONIC with ours, clamp any
            # residual skew to keep the waterfall non-negative
            t_pickup, t_exec0, t_exec1, t_decode = stamps
            bounds = [req.t_submit, t_pickup, t_exec0, t_exec1,
                      t_decode, t_fin]
            for i in range(1, len(bounds)):
                bounds[i] = max(bounds[i], bounds[i - 1])
            durs = tuple(bounds[i + 1] - bounds[i]
                         for i in range(len(HOPS)))
            if req.ctx.sampled:
                req.ctx.finish("ok", hops=list(zip(HOPS, durs)),
                               replica=self.worker_idx)
            self.metrics.on_hops(self.worker_idx, durs)
            self.metrics.on_decode(fused=True)
            tracer = get_tracer()
            if tracer.enabled and idx is not None:
                # the deliver slice finishes the cross-process flow arc
                # the submit started and the worker's serve slice
                # stepped; worker stamps share CLOCK_MONOTONIC with the
                # tracer's t0 so add_span_abs lands on the same axis
                rtrack = f"router-w{self.worker_idx}"
                tracer.add_span_abs("proc_deliver", bounds[4],
                                    max(t_fin - bounds[4], 1e-7),
                                    track=rtrack,
                                    args={"slot": idx, "seq": req.seq})
                tracer.flow_finish(
                    "req", flow_id(self.worker_idx, idx, req.seq),
                    track=rtrack, cat="proc",
                    ts=(bounds[4] - tracer.t0)
                    + (t_fin - bounds[4]) / 2.0)
        elif req.ctx.sampled:
            req.ctx.finish(
                "ok" if error is None
                else f"error:{type(error).__name__}",
                replica=self.worker_idx)
        try:
            if error is not None:
                self.metrics.on_fail(
                    expired=isinstance(error, DeadlineExceeded))
                req.future.set_exception(error)
            else:
                self.metrics.on_complete(t_fin - req.t_submit)
                self.consecutive_failures = 0
                self.gave_up = False
                req.future.set_result(result)
        except Exception:  # noqa: BLE001 — future cancelled by caller;
            pass           # the outcome is still accounted
        finally:
            try:
                self._slots_sem.release()
            except ValueError:
                pass        # slot pool was rebuilt under a respawn


class ProcessRouter:
    """N process workers behind ONE ``EnginePool``: the deployment
    shape for true multi-core serving.  Every pool capability —
    least-loaded routing, circuit breaking, fencing, transparent
    failover, auto-restart — applies to worker PROCESSES because each
    worker hides behind the unchanged engine contract.

    The router itself re-exports the engine contract too, so
    ``PolicyClient``, ``CascadeEngine`` lanes and ``StreamSession``
    sit on a ``ProcessRouter`` exactly as they would on a single
    batcher or a thread pool.

    ``telemetry`` goes to every worker; ``trace_path`` hands worker *i*
    the span shard ``f"{trace_path}.p{i + 1}"``, next to the parent's
    own export at ``trace_path``.
    """

    def __init__(self, spec: str, num_workers: int = 2,
                 spec_kwargs: Optional[dict] = None, *,
                 sink_path: Optional[str] = None,
                 restart_after_s: Optional[float] = 1.0,
                 wedge_timeout_s: float = 30.0,
                 drain_timeout_s: float = 10.0,
                 probe_interval_s: float = 0.2,
                 breaker_kw: Optional[dict] = None,
                 registry=None, slo=None,
                 qos_class: str = "interactive",
                 pool_kw: Optional[dict] = None,
                 telemetry: bool = True,
                 trace_path: Optional[str] = None,
                 staleness_s: float = 5.0,
                 **engine_kw):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers} must be >= 1")
        if sink_path is None:
            sink_path = getattr(get_sink(), "path", None)
        self.workers = [
            ProcessWorkerEngine(
                spec, spec_kwargs, worker_idx=i,
                sink_path=sink_path, telemetry=telemetry,
                # per-worker trace shards next to the parent export —
                # the ".pN" suffix convention cli.trace_report
                # auto-discovers
                trace_path=(f"{trace_path}.p{i + 1}"
                            if trace_path else None),
                **engine_kw)
            for i in range(num_workers)]
        #: the parent-side merge point: worker telemetry blocks +
        #: router-side lifecycle state under ``worker=`` labels, the
        #: ``/fleet`` document and the cross-process conservation check
        self.fleet = FleetRegistry(staleness_s=staleness_s)
        for w in self.workers:
            self.fleet.add_engine(w)
        kw = dict(pool_kw or {})
        kw.setdefault("restart_after_s", restart_after_s)
        kw.setdefault("wedge_timeout_s", wedge_timeout_s)
        kw.setdefault("drain_timeout_s", drain_timeout_s)
        kw.setdefault("probe_interval_s", probe_interval_s)
        kw.setdefault("breaker_kw", breaker_kw)
        self.pool = EnginePool(self.workers, registry=registry,
                               slo=slo, qos_class=qos_class, **kw)

    # ---------------------------------------------------- engine contract
    @property
    def metrics(self) -> ServeMetrics:
        return self.pool.metrics

    @property
    def draining(self) -> bool:
        return self.pool.draining

    def start(self) -> "ProcessRouter":
        self.pool.start()
        return self

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        self.pool.stop(drain_timeout_s=drain_timeout_s)

    def submit(self, image, *,
               deadline_s: Optional[float] = None) -> Future:
        return self.pool.submit(image, deadline_s=deadline_s)

    def warmup(self, image_sizes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> dict:
        return self.pool.warmup(image_sizes, batch_sizes=batch_sizes)

    def health(self) -> dict:
        """Fleet health: the pool replica-state rollup plus per-worker
        process liveness — one surface for ``/metrics`` and ``/slo``."""
        states = self.pool.replica_states()
        return {"running": self.pool._running,
                "draining": self.pool.draining,
                "workers": [
                    {**s, **w.health(), **w.worker_stats()}
                    for s, w in zip(states, self.workers)]}

    def __enter__(self) -> "ProcessRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------- rollups
    def counters(self) -> dict:
        out = dict(self.pool.counters())
        out["worker_respawns"] = sum(max(0, w.restarts - 1)
                                     for w in self.workers)
        out["workers_gave_up"] = sum(int(w.gave_up)
                                     for w in self.workers)
        return out

    def worker_stats(self) -> List[dict]:
        return [w.worker_stats() for w in self.workers]

    def fleet_state(self) -> dict:
        """The ``/fleet`` route body (wire as ``MetricsServer``'s
        ``fleet=`` callable): per-worker liveness / respawn / crash-
        budget state, decoded telemetry with staleness age, and the
        cross-process conservation block."""
        return self.fleet.fleet_state()

    def health_extra(self) -> dict:
        """The ``/healthz`` fleet block (wire via
        ``HealthSentinel.set_extra("fleet", router.health_extra)``):
        carries its own non-ok ``status`` once any worker exhausts its
        crash budget, which escalates the probe to 503."""
        return self.fleet.health_extra()

    def last_postmortems(self) -> List[Optional[dict]]:
        """Per-worker last exhumed ``worker_postmortem`` (None where no
        death was detected since start)."""
        return [w.last_postmortem for w in self.workers]

    def register_into(self, registry) -> "ProcessRouter":
        """One exposition path for the whole fleet: pool + per-replica
        engine metrics through the pool's weakref collector, plus the
        router's process-level rollups."""
        import weakref

        self.pool.register_into(registry)
        self.fleet.attach(registry)
        ref = weakref.ref(self)

        def _collect():
            rt = ref()
            if rt is None:
                return []
            samples = []
            samples.append(("router_worker_respawns_total", {},
                            "counter",
                            float(rt.counters()["worker_respawns"])))
            # gauges, not counters: gave_up can reset on recovery and
            # the recompile count restarts with a respawned worker —
            # and counter naming (JGL006 / the metric-name lint) would
            # demand a _total suffix these families don't carry
            samples.append(("router_workers_gave_up", {}, "gauge",
                            float(rt.counters()["workers_gave_up"])))
            for i, w in enumerate(rt.workers):
                st = w.worker_stats()
                samples.append(("router_worker_served_total",
                                {"worker": str(i)}, "counter",
                                float(st["served"])))
                samples.append(("router_worker_recompiles_post_warmup",
                                {"worker": str(i)}, "gauge",
                                float(st["recompiles_post_warmup"])))
            return samples

        registry.register_collector(_collect)
        return self

    def snapshot(self) -> dict:
        snap = self.pool.snapshot()
        snap["workers"] = self.worker_stats()
        snap["counters"] = self.counters()
        return snap
