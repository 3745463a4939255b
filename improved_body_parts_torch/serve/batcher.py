"""Asynchronous dynamic batcher: many concurrent single-image requests →
shape-bucketed batches on the card (the port's own copy of
``improved_body_parts_tpu/serve/batcher.py``).

Every inference entry point below this layer (``Predictor.predict*``,
``pipelined_inference``) consumes a pre-known iterable; this is the path
from independently-arriving requests to the card.  The 2N-lane forward
only pays off when its lanes are full, so throughput under real load
hinges on batch occupancy.

Design:

- **Admission** is bounded by ``max_queue`` in-flight requests (a
  semaphore held from submit to completion).  When full, :meth:`submit`
  raises :class:`ServerOverloaded` immediately — explicit load-shedding,
  never unbounded growth, and in-flight work keeps draining.
- **Coalescing**: a single dispatcher thread groups requests by
  ``Predictor.compact_lane_shape`` (the ``pad_right_down`` bucket
  geometry every batch runs at, so one warmed batch program per bucket
  serves all traffic).  A bucket flushes when it reaches ``max_batch``
  occupancy or when its oldest request has waited ``max_wait_ms`` — the
  classic throughput/latency knob pair.
- **Completion**: the device work is dispatched asynchronously.  On the
  DEFAULT device-decode lane it is the FUSED end-to-end decode
  (``Predictor.predict_decoded_batch_async``: forward, then the peak,
  limb and assembly kernels — ``ops.peaks``, ``ops.assembly`` — queued
  on the card per batch); each request finishes with an O(people)
  coordinate lookup right on the fetch thread.  The decode thread pool
  (the plumbing shared with ``infer.pipeline.compact_decode_fn``,
  GIL-released under the native decoder) is demoted to the overflow
  fallback — and remains the whole completion stage on the host-pool
  lane (``device_decode=False``).  ``ServeMetrics`` splits
  ``decode_fused`` from ``decode_host_fallback`` so the fallback rate
  is observable.  Results always map back to their own request (batch
  dispatch returns input order), so arrival order is preserved per
  caller.
- **Warmup**: :meth:`warmup` runs every configured bucket shape at every
  power-of-two batch size ≤ ``max_batch`` once (``serve.warmup``), so
  the first request in each bucket never pays the card's one-off costs.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import InferenceParams, SkeletonConfig
from ..infer.pipeline import compact_decode_fn
from ..obs.reqtrace import NULL_NODE, get_reqtrace
from ..obs.trace import get_tracer
from .metrics import HOPS, ServeMetrics
from .warmup import precompile

_STOP = object()
_KICK = object()   # device went idle — wake the dispatcher to flush
# process-wide request ids: the trace keys each request's async span and
# submit->execute flow arrow on these (next() is atomic under the GIL)
_RID = itertools.count(1)


class ServerOverloaded(RuntimeError):
    """Admission queue full — the request was rejected (load shed).

    The explicit fail-fast status: callers retry with backoff or surface
    a 503; the server keeps serving everything already admitted."""


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_s`` passed before its batch reached the
    device — the request is failed fast instead of occupying a bucket
    slot with work the caller already gave up on.  A retry against
    another replica is pointless (the deadline is global)."""


class _Request:
    __slots__ = ("image", "future", "t_submit", "deadline", "finished",
                 "rid", "ctx", "t_bucket", "t_dispatch", "t_exec",
                 "t_decode", "replica")

    def __init__(self, image: np.ndarray,
                 deadline_s: Optional[float] = None):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # absolute perf_counter instant past which the request is dead
        # weight (None = no deadline): checked by the dispatcher before
        # bucketing AND again at dispatch, never on the submit hot path
        self.deadline = (None if deadline_s is None
                         else self.t_submit + deadline_s)
        self.finished = False  # server-side once-flag (see _finish)
        self.rid = next(_RID)  # trace flow/async-span key
        self.ctx = NULL_NODE   # reqtrace node (obs.reqtrace)
        # hop-waterfall boundary stamps (perf_counter): each stage
        # stamps its exit, so consecutive differences PARTITION the
        # submit→finish window — see serve.metrics.HOPS
        self.t_bucket: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_exec: Optional[float] = None
        self.t_decode: Optional[float] = None
        self.replica = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None
                     else time.perf_counter()) >= self.deadline)


class DynamicBatcher:
    """Dynamic-batching compact-inference server around one Predictor.

    ::

        with DynamicBatcher(pred, max_batch=8, max_wait_ms=5) as server:
            server.warmup([(512, 512)])
            fut = server.submit(image_bgr)       # from any thread
            skeletons = fut.result()             # list[(coco_kps, score)]

    Restricted to the trivial (single-scale, no-rotation) grid — the
    protocol whose bucket geometry lets one warmed batch program per
    shape serve all traffic.

    The predictor itself is driven only from the internal dispatcher
    thread (plus the decode pool's overflow fallback, which re-runs
    single images); callers never touch it concurrently.
    """

    def __init__(self, predictor, params: Optional[InferenceParams] = None,
                 skeleton: Optional[SkeletonConfig] = None, *,
                 max_batch: int = 8, max_wait_ms: float = 25.0,
                 max_queue: int = 64, decode_workers: int = 2,
                 use_native: bool = True, devices: Optional[Sequence] = None,
                 eager_idle_flush: bool = True,
                 metrics: Optional[ServeMetrics] = None,
                 registry=None, device_decode: bool = True,
                 emit_signals: bool = False, slo=None,
                 qos_class: str = "interactive"):
        from ..infer.predict import trivial_grid

        self.predictor = predictor
        self.params = params or predictor.params
        self.skeleton = skeleton or predictor.skeleton
        if not trivial_grid(self.params):
            raise ValueError(
                "DynamicBatcher serves the single-scale protocol; "
                "scale/rotation grids dispatch per image — use "
                "predict_compact_ms / pipelined_inference for those")
        if max_batch < 1 or max_queue < 1:
            raise ValueError(f"max_batch={max_batch} and max_queue="
                             f"{max_queue} must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        # True: flush pending work the moment a device goes idle (hide
        # the coalescing wait behind in-flight work — the throughput
        # default).  False: only max_batch / deadline flush — maximizes
        # occupancy at the cost of idle device time; also what makes
        # flush behavior deterministic for tests.
        self.eager_idle_flush = eager_idle_flush
        self.metrics = metrics or ServeMetrics()
        # optional SLO wiring: an obs.slo.SLOTracker (or any object with
        # record(qos_class, latency_s, error=...)) sees every finished
        # request under this engine's QoS class.  Attach at ONE layer per
        # deployment — a layer above an slo-wired batcher would
        # double-count.
        self._slo = slo
        self._qos_class = qos_class
        if registry is not None:
            # the batcher's counters/reservoirs surface through a shared
            # registry (duck-typed: ServeMetrics.register_into)
            self.metrics.register_into(registry)
        # True (default): dispatch the FUSED device decode — forward +
        # compact extraction + greedy assembly queued on the device per
        # batch; the decode pool is demoted to the overflow fallback.
        # False: the host-pool lane (every decode runs decode_compact on
        # the pool) — the parity/A-B arm.
        self.device_decode = device_decode
        # True: every future resolves to (skeletons, EscalationSignals)
        # instead of bare skeletons — what a cascade layer routes on.
        # The signals are free: person count, overflow
        # flags and the min assembly score already ride the fused decode
        # payload's single fetch.  Requires the device-decode lane (the
        # host-pool lane never sees the device assembly).
        self.emit_signals = emit_signals
        if emit_signals and not device_decode:
            raise ValueError(
                "emit_signals needs the fused device-decode lane "
                "(device_decode=True): the escalation signals live in "
                "the device assembly's payload")
        # compact_decode_fn serves BOTH lanes: the host-pool lane's
        # per-request decoder, and the device lane's overflow fallback
        # (fed the compact records the fused buffer ships alongside)
        self._decode_one = compact_decode_fn(predictor, self.params,
                                             self.skeleton, use_native)
        self._decode_workers = max(1, decode_workers)
        # device replicas: data-parallel serving — each batch runs whole
        # on the least-loaded replica's device (a host's cards).  The
        # serial per-image paths can only ever drive one device; this is
        # throughput the engine alone unlocks.
        if devices:
            self._replicas = [predictor.device_replica(d) for d in devices]
        else:
            self._replicas = [predictor]
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._fetchqs = [queue.SimpleQueue() for _ in self._replicas]
        self._slots = threading.BoundedSemaphore(max_queue)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._fetchers: "list[threading.Thread]" = []
        self._running = False
        self._draining = False
        # every admitted, unfinished request — what the bounded-deadline
        # drain fails explicitly instead of stranding (guarded by
        # _finish_lock, the same lock that makes _finish exactly-once)
        self._inflight_reqs: "set[_Request]" = set()
        # per-replica batches dispatched whose device results are not yet
        # fetched — the dispatcher's "is a device idle" signal for idle
        # flushes and its least-loaded routing key
        self._in_flight = [0] * len(self._replicas)
        self._in_flight_lock = threading.Lock()
        self._finish_lock = threading.Lock()
        # serializes stop() AND start(): double-stop (a supervisor
        # racing a user shutdown) must not raise or double-join — the
        # first caller does the drain, concurrent callers block until
        # it finishes and then see the already-clean state — and a
        # restart waits for an in-progress drain's tail
        self._stop_lock = threading.Lock()
        # start generation: stage threads carry their token so one a
        # wedged drain left parked cannot feed or account against a
        # later generation's pipeline when it finally resumes
        self._gen = 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "DynamicBatcher":
        # serialized against stop(): a restart racing an in-progress
        # bounded drain must wait for the drain's tail, or the drain would tear down
        # the NEW generation's queues/threads it never owned
        with self._stop_lock:
            if self._running:
                return self
            # fresh queues per start GENERATION: a restart after stop()
            # must not share queues with a previous generation's threads
            # — a stale _STOP sentinel (or a thread a wedged drain left
            # parked mid-stage) would otherwise kill or starve the new
            # pipeline.  Every stage thread carries its generation
            # token and queue objects; a prior-generation thread that
            # resumes after a restart no-ops instead of feeding or
            # accounting against the live pipeline.
            self._gen += 1
            self._queue = queue.SimpleQueue()
            self._fetchqs = [queue.SimpleQueue() for _ in self._replicas]
            self._in_flight = [0] * len(self._replicas)
            self._pool = ThreadPoolExecutor(
                max_workers=self._decode_workers,
                thread_name_prefix="serve-decode")
            self._running = True
            self._dispatcher = threading.Thread(
                target=self._run, args=(self._gen, self._queue,
                                        self._fetchqs),
                name="serve-dispatcher", daemon=True)
            self._fetchers = [
                threading.Thread(target=self._run_fetcher,
                                 args=(i, self._fetchqs[i], self._gen),
                                 name=f"serve-fetcher-{i}", daemon=True)
                for i in range(len(self._replicas))]
            self._dispatcher.start()
            for t in self._fetchers:
                t.start()
            return self

    @property
    def draining(self) -> bool:
        """True once a graceful stop began: new submits are rejected
        with :class:`ServerOverloaded` while admitted work drains."""
        return self._draining

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Graceful drain, then shut down.

        Admission closes FIRST (new submits are rejected with
        :class:`ServerOverloaded` — the status a load-balancer already
        handles during rollout, unlike the old hard ``RuntimeError``),
        then the queued buckets flush, the fetch pipelines drain, and
        the decode pool joins.  With ``drain_timeout_s`` the whole drain
        is bounded: past the deadline the remaining in-flight futures
        fail with an explicit error instead of the caller hanging on a
        wedged device — every future returned by :meth:`submit` always
        completes, on time or by deadline.

        Idempotent and thread-safe: concurrent callers serialize on a
        stop lock —
        the first caller drains, the rest wait and return.
        """
        with self._stop_lock:
            self._stop_locked(drain_timeout_s)

    def _stop_locked(self, drain_timeout_s: Optional[float]) -> None:
        if not self._running and self._dispatcher is None \
                and not self._fetchers:
            return  # never started, or a previous stop() finished
        deadline = (None if drain_timeout_s is None
                    else time.perf_counter() + drain_timeout_s)

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(0.0, deadline - time.perf_counter())

        # order matters: reject new admissions BEFORE the stop sentinel,
        # so nothing can enqueue behind it and strand
        self._draining = True
        self._running = False
        self._queue.put(_STOP)
        self._dispatcher.join(remaining())
        expired = self._dispatcher.is_alive()  # daemon; dies with us
        self._dispatcher = None
        # the dispatcher flushed everything before exiting; now drain the
        # fetch pipelines behind it
        for q in self._fetchqs:
            q.put(_STOP)
        for t in self._fetchers:
            t.join(remaining())
            expired = expired or t.is_alive()
        self._fetchers = []
        # a submit that raced the _running flip may have enqueued behind
        # the sentinel; fail those futures rather than hang their callers
        unread_stop = False
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _STOP:
                unread_stop = True
            elif req is not _KICK:
                self._finish(req, error=RuntimeError("batcher stopped"))
        if unread_stop:
            # the dispatcher was still in a dispatch when the drain ran
            # out and never read its sentinel: hand it back, or the
            # thread waits on this queue for the life of the process
            self._queue.put(_STOP)
        if deadline is not None:
            # bounded decode drain: poll the admitted-set down instead
            # of an unbounded pool.shutdown(wait=True)
            while remaining() > 0:
                with self._finish_lock:
                    if not self._inflight_reqs:
                        break
                time.sleep(0.005)
            with self._finish_lock:
                stranded = list(self._inflight_reqs)
            # deadline hit with work still wedged in a stage (a hung
            # device resolve, a stuck decode): fail every remaining
            # future explicitly — _finish is exactly-once, so a stage
            # that later completes one anyway is a harmless no-op
            for req in stranded:
                self._finish(req, error=RuntimeError(
                    f"batcher stopped before completion (drain deadline "
                    f"{drain_timeout_s}s exceeded)"))
            wedged = bool(expired or stranded)
            self._pool.shutdown(wait=not wedged)
            # a wedged stage thread may still recover later and call
            # self._pool.submit — keep the SHUT-DOWN executor so that
            # raises the RuntimeError its inline-decode fallback
            # handles (None would AttributeError and kill the thread);
            # start() replaces the pool unconditionally
            if not wedged:
                self._pool = None
        else:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._draining = False

    def __enter__(self) -> "DynamicBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def submit(self, image_bgr: np.ndarray, *,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one BGR image; returns a future resolving to the
        decoded skeletons (``decode_compact`` output: a list of
        (coco_keypoints, score) tuples).

        ``deadline_s`` bounds the request's useful life: a request whose
        deadline passes before its bucket reaches the device fails fast
        with :class:`DeadlineExceeded` instead of occupying a batch
        lane (checked by the dispatcher at bucketing and again at
        dispatch — a caller that already gave up must not cost device
        time).

        :raises ServerOverloaded: ``max_queue`` requests already in
            flight (fail-fast backpressure, nothing is queued) — or the
            batcher is DRAINING toward shutdown (same retry-with-backoff
            contract: during a rolling restart the replacement instance
            takes the retry).
        :raises DeadlineExceeded: ``deadline_s`` is already non-positive
            at submit time (nothing is admitted).
        :raises RuntimeError: the batcher is not running.
        """
        if self._draining:
            self.metrics.on_reject()
            raise ServerOverloaded(
                "batcher is draining (shutdown in progress); retry "
                "against a live instance")
        if not self._running:
            raise RuntimeError("DynamicBatcher is not running "
                               "(use `with batcher:` or call start())")
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.on_expire_rejected()
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit")
        if not self._slots.acquire(blocking=False):
            self.metrics.on_reject()
            raise ServerOverloaded(
                f"{self.max_queue} requests in flight (max_queue); "
                "retry with backoff")
        req = _Request(image_bgr, deadline_s)
        rt = get_reqtrace()
        if rt.enabled:
            # root when the caller is a bare client; child of the
            # submitting layer's node when this submit runs inside its
            # child_scope — the cross-hop causal link
            req.ctx = rt.begin(
                "batcher", **({"model": self.metrics.model}
                              if self.metrics.model else {}))
        with self._finish_lock:
            self._inflight_reqs.add(req)
        trace = get_tracer()
        if trace.enabled:
            # one async span per request (enqueue -> fulfilment) plus a
            # flow arrow from this submit to the batch that executes it:
            # in Perfetto, batching fan-in is N arrows converging on one
            # `execute` slice
            trace.async_begin("request", req.rid, cat="serve",
                             args={"shape": list(np.shape(image_bgr))})
            trace.flow_start("serve_req", req.rid)
        self.metrics.on_submit()
        q = self._queue
        q.put(req)
        if not self._running or q is not self._queue:
            # raced stop() — or a whole stop()+start() cycle, in which
            # case the request landed in the PREVIOUS generation's
            # orphaned queue that no dispatcher will ever read (the
            # `q is not self._queue` arm; _running alone would look
            # fine again after the restart).  _finish is idempotent, so
            # if a dispatcher did catch it, this no-ops.
            self._finish(req, error=RuntimeError("batcher stopped"))
        return req.future

    # ------------------------------------------------------------- warmup
    def warmup(self, image_sizes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> dict:
        """Warm the batch programs the configured traffic needs: every
        bucket the given (H, W) image sizes land in × every power-of-two
        batch size ≤ ``max_batch`` (or an explicit ``batch_sizes``), on
        EVERY device replica — plus one dispatch of every NON-pow2
        occupancy, whose pow2 chunks join through an on-device row
        concat the (bucket × pow2) warmup does not reach.  Call before
        accepting traffic; see :func:`serve.warmup.precompile` for the
        returned summary."""
        # ONE warmup path (serve.warmup.precompile over the replica set);
        # each replica keeps its own warm set, since each device pays
        # its own first-run costs
        info = precompile(self._replicas, image_sizes, self.max_batch,
                          params=self.params, batch_sizes=batch_sizes,
                          decode=self.device_decode)
        # an explicit batch_sizes is the caller's occupancy cap: the
        # chunk-join loop must not dispatch the pow2 chunk programs that
        # restriction just excluded
        occupancy_cap = (max(batch_sizes) if batch_sizes
                         else self.max_batch)
        for replica in self._replicas:
            dispatch = (replica.predict_decoded_batch_async
                        if self.device_decode
                        else replica.predict_compact_batch_async)
            for h, w in image_sizes:
                img = np.zeros((int(h), int(w), 3), np.uint8)
                for n in range(3, occupancy_cap + 1):
                    if n & (n - 1):  # non-pow2: chunk-join flush shape
                        dispatch([img] * n, thre1=self.params.thre1,
                                 params=self.params)()
        return info

    # ------------------------------------------------------------- health
    def health(self) -> dict:
        """One consistent liveness read for a router's health probe,
        built from signals that already exist: thread liveness plus the
        ``ServeMetrics`` stall clock.

        A replica is *wedged* when work is admitted but nothing has
        completed for longer than the router's patience
        (``stall_age_s``), and *crashed* when its dispatcher or a
        fetcher thread died — both observable here without touching the
        device."""
        dispatcher = self._dispatcher
        fetchers = list(self._fetchers)
        with self._in_flight_lock:
            batches_in_flight = sum(self._in_flight)
        return {
            "running": self._running,
            "draining": self._draining,
            "dispatcher_alive": bool(dispatcher is not None
                                     and dispatcher.is_alive()),
            "fetchers_alive": sum(1 for t in fetchers if t.is_alive()),
            "fetchers_expected": len(fetchers),
            "queue_depth": self.metrics.depth,
            "batches_in_flight": batches_in_flight,
            "stall_age_s": self.metrics.stall_age_s(),
        }

    # --------------------------------------------------------- dispatcher
    def _run(self, gen: int, inq: "queue.SimpleQueue",
             fetchqs: "list[queue.SimpleQueue]") -> None:
        """The coalescing loop.  A bucket flushes when any of:

        - it reached ``max_batch`` occupancy (full lanes — always);
        - its oldest request waited out ``max_wait_ms`` (the latency
          promise — always);
        - the device went idle (no batch in flight): holding requests
          back can only raise occupancy if the wait is hidden behind
          in-flight work, so an idle device flushes whatever exists
          immediately.  This makes throughput insensitive to
          ``max_wait_ms`` — the deadline buys occupancy only out of
          time the device was busy anyway.
        """
        pending: Dict[Tuple[int, int], List[_Request]] = {}
        stop = False
        while not stop:
            timeout = None
            if pending:
                oldest = min(reqs[0].t_submit for reqs in pending.values())
                timeout = max(0.0, oldest + self.max_wait_s
                              - time.perf_counter())
            try:
                item = inq.get(timeout=timeout)
            except queue.Empty:
                item = None
            # bucket this request and every one already queued behind it
            # before any flush decision: a dispatch holds this thread for
            # its host work, and requests that queued meanwhile must
            # coalesce, not meet their deadline one at a time.  Only what
            # was queued when the drain began, so that a steady stream
            # cannot hold the deadline checks off.
            queued = inq.qsize()
            while item is not None:
                if item is _STOP:
                    stop = True
                    break
                if item is not _KICK:
                    self._bucket(item, pending, gen, fetchqs)
                item = None
                if queued > 0:
                    queued -= 1
                    try:
                        item = inq.get_nowait()
                    except queue.Empty:
                        pass
            now = time.perf_counter()
            with self._in_flight_lock:
                idle = (self.eager_idle_flush
                        and min(self._in_flight) == 0)
            # oldest bucket first: deadline and idle flushes drain in
            # arrival order
            for key in sorted(pending,
                              key=lambda k: pending[k][0].t_submit):
                if stop or idle or (now - pending[key][0].t_submit
                                    >= self.max_wait_s):
                    self._dispatch(pending.pop(key), gen, fetchqs)
                    with self._in_flight_lock:
                        idle = (self.eager_idle_flush
                                and min(self._in_flight) == 0)

    def _bucket(self, item: _Request,
                pending: Dict[Tuple[int, int], List[_Request]], gen: int,
                fetchqs: "list[queue.SimpleQueue]") -> None:
        """Put one request read off the queue into its shape bucket, and
        flush the bucket if that filled it."""
        if item.expired():
            # dead on arrival at the dispatcher: fail fast BEFORE the
            # request can occupy a bucket slot
            self._finish(item, error=DeadlineExceeded(
                "request deadline passed before dispatch"))
            return
        try:
            key = self.predictor.compact_lane_shape(item.image, self.params)
        except Exception as e:  # noqa: BLE001 — a malformed image must
            # fail ITS future, never the dispatcher
            self._finish(item, error=e)
            return
        item.t_bucket = time.perf_counter()  # queue hop ends
        bucket = pending.setdefault(key, [])
        bucket.append(item)
        if len(bucket) >= self.max_batch:
            self._dispatch(pending.pop(key), gen, fetchqs)

    def _dispatch(self, reqs: List[_Request], gen: int,
                  fetchqs: "list[queue.SimpleQueue]") -> None:
        """Dispatch one shape bucket's batch to the least-loaded device
        replica (async) and queue its fetch.  Runs on the dispatcher
        thread; a dispatch failure fails exactly this batch's futures and
        the loop keeps serving."""
        if gen != self._gen:
            # a prior-generation dispatcher resumed after a restart:
            # its requests were already failed by that generation's
            # drain (exactly-once _finish no-ops) — don't burn device
            # time or touch the live generation's accounting
            for r in reqs:
                self._finish(r, error=RuntimeError("batcher restarted"))
            return
        # a bounded stop fails what it strands, the requests still in a
        # bucket included; the dispatcher flushes those buckets as it
        # leaves, and they cost no device time
        reqs = [r for r in reqs if not r.finished]
        if not reqs:
            return
        if any(r.deadline is not None for r in reqs):
            # last check before device work: expired requests fall out
            # of the batch here (a bucket that waited out max_wait_ms
            # can outlive a tight deadline)
            now = time.perf_counter()
            live = []
            for r in reqs:
                if r.expired(now):
                    self._finish(r, error=DeadlineExceeded(
                        "request deadline passed before dispatch"))
                else:
                    live.append(r)
            reqs = live
            if not reqs:
                return
        with self._in_flight_lock:
            idx = min(range(len(self._replicas)),
                      key=self._in_flight.__getitem__)
        t_dispatch = time.perf_counter()  # batch_formation hop ends
        for r in reqs:
            r.t_dispatch = t_dispatch
            r.replica = idx
        replica = self._replicas[idx]
        if self.device_decode:
            dispatch_one = replica.predict_decoded_async
            dispatch_batch = replica.predict_decoded_batch_async
        else:
            dispatch_one = replica.predict_compact_async
            dispatch_batch = replica.predict_compact_batch_async
        try:
            if len(reqs) == 1:
                # singleton flush: the single-image program skips the
                # batch path's stack/group/concat machinery
                resolve_one = dispatch_one(
                    reqs[0].image, thre1=self.params.thre1,
                    params=self.params)
                resolve = lambda: [resolve_one()]  # noqa: E731
            else:
                resolve = dispatch_batch(
                    [r.image for r in reqs], thre1=self.params.thre1,
                    params=self.params)
        except Exception as e:  # noqa: BLE001 — delivered per request
            for r in reqs:
                self._finish(r, error=e)
            return
        if gen != self._gen:
            # the dispatch call itself can block (a wedged device); a
            # restart may have happened while this thread was parked in
            # it — re-check before touching the live generation's
            # accounting or enqueueing to a dead fetcher
            for r in reqs:
                self._finish(r, error=RuntimeError("batcher restarted"))
            return
        trace = get_tracer()
        if trace.enabled:
            # dispatcher-track marker: when the bucket left coalescing
            trace.instant("dispatch", args={"batch": len(reqs),
                                            "replica": idx})
        self.metrics.on_dispatch(len(reqs))
        with self._in_flight_lock:
            self._in_flight[idx] += 1
        fetchqs[idx].put((reqs, resolve))

    def _run_fetcher(self, idx: int, inq: "queue.SimpleQueue",
                     gen: int) -> None:
        """One replica's fetch stage: block on each batch's single
        device→host transfer (FIFO per replica — a device executes its
        dispatches in order, so waiting in dispatch order is optimal),
        then fan the per-image decodes out to the pool.  Dedicated
        threads so a resolve wait can never occupy a decode worker —
        with every worker stuck fetching, nothing would decode and the
        pipeline would stall."""
        while True:
            item = inq.get()
            if item is _STOP:
                return
            reqs, resolve = item
            trace = get_tracer()
            t_exec = trace.now() if trace.enabled else 0.0
            try:
                results = resolve()
            except Exception as e:  # noqa: BLE001 — delivered per request
                self._batch_done(idx, gen)
                for r in reqs:
                    self._finish(r, error=e)
                continue
            t_fetched = time.perf_counter()  # device hop ends
            for r in reqs:
                r.t_exec = t_fetched
            if trace.enabled:
                trace.add_span_rel("execute", t_exec,
                                   trace.now() - t_exec,
                                   args={"batch": len(reqs),
                                         "replica": idx})
                for r in reqs:
                    # arrowheads bind to the execute slice (ts at its
                    # start): each admitted request's flow ends here
                    trace.flow_finish("serve_req", r.rid, ts=t_exec)
            self._batch_done(idx, gen)
            for r, res in zip(reqs, results):
                signals = None
                if self.device_decode:
                    if self.emit_signals:
                        from ..infer.decode import device_signals

                        # captured BEFORE the overflow demotion below:
                        # the flags are exactly what tells the caller
                        # WHY a fallback-decoded frame is hard
                        signals = device_signals(res)
                    if res.ok:
                        # fused result: the remaining work is an
                        # O(people) coordinate lookup — finish INLINE on
                        # this device-program track (no pool hop; the
                        # `decode` span lands next to `execute`)
                        self.metrics.on_decode(fused=True)
                        self._finish_fused(r, res, signals)
                        continue
                    # overflow flag: demote to the host decode pool on
                    # the compact records the fused buffer shipped
                    self.metrics.on_decode(fused=False)
                    res = res.compact
                else:
                    self.metrics.on_decode(fused=False)
                try:
                    self._pool.submit(self._decode_and_finish, r, res,
                                      signals)
                except RuntimeError:  # pool draining (stop()) — inline
                    self._decode_and_finish(r, res, signals)

    def _batch_done(self, idx: int, gen: int) -> None:
        """One batch's device results landed: drop the replica's
        in-flight count and wake the dispatcher so an idle device gets
        fed at once.  Generation-guarded: a prior-generation fetcher
        resuming after a restart must not decrement (or kick) the live
        pipeline's accounting."""
        if gen != self._gen:
            return
        with self._in_flight_lock:
            self._in_flight[idx] -= 1
            idle = self._in_flight[idx] == 0
        if idle and self._running:
            self._queue.put(_KICK)

    def _finish_fused(self, req: _Request, res, signals=None) -> None:
        """Finish one fused device-decode result on the calling (fetch)
        thread: coordinate lookup + COCO reorder only."""
        from ..infer.decode import decode_device

        try:
            with get_tracer().span("decode", args={"rid": req.rid,
                                                   "lane": "device"}):
                result = decode_device(res, self.skeleton)
            req.t_decode = time.perf_counter()  # decode hop ends
            if self.emit_signals:
                result = (result, signals)
            self._finish(req, result=result)
        except Exception as e:  # noqa: BLE001 — delivered per request
            self._finish(req, error=e)

    def _decode_and_finish(self, req: _Request, res,
                           signals=None) -> None:
        try:
            with get_tracer().span("decode", args={"rid": req.rid,
                                                   "lane": "host"}):
                result = self._decode_one(res, req.image)
            req.t_decode = time.perf_counter()  # decode hop ends
            if self.emit_signals:
                result = (result, signals)
            self._finish(req, result=result)
        except Exception as e:  # noqa: BLE001 — delivered per request
            self._finish(req, error=e)

    def _finish(self, req: _Request, result=None, error=None) -> None:
        """Fulfil one request exactly once: metrics, future, admission
        slot.  Keyed on the request's own once-flag, NOT future.done():
        a caller may cancel() the pending future, and that must not leak
        the admission slot or the metrics depth — the slot is released
        exactly once per admitted request, no matter what."""
        with self._finish_lock:  # atomic once-flag: a double release
            # would blow the bounded admission semaphore
            if req.finished:
                return
            req.finished = True
            self._inflight_reqs.discard(req)
        # ONE end-of-life stamp shared by the hop waterfall, the e2e
        # reservoir and the SLO record: measuring them at different
        # instants would charge this function's own record-assembly
        # work to the request and break the exact hop↔e2e conservation
        t_fin = time.perf_counter()
        if error is None and req.t_decode is not None:
            # the hop waterfall: consecutive boundary stamps partition
            # submit→here, so the five segments sum to the measured e2e
            # by construction (the conservation discipline); fed for
            # EVERY completed request — reqtrace sampling only thins
            # the per-request records, never these reservoirs
            durs = (req.t_bucket - req.t_submit,
                    req.t_dispatch - req.t_bucket,
                    req.t_exec - req.t_dispatch,
                    req.t_decode - req.t_exec,
                    t_fin - req.t_decode)
            if req.ctx.sampled:
                # finish BEFORE the reservoir updates: the node's end
                # stamp must sit next to t_fin, not after ten meter
                # updates — on sub-ms requests that gap alone would
                # break the per-request conservation readout
                req.ctx.finish("ok", hops=list(zip(HOPS, durs)),
                               replica=req.replica)
            self.metrics.on_hops(req.replica, durs)
        elif req.ctx.sampled:
            # error path: record what the request got through before it
            # died (partial waterfall, stamps that exist)
            stamps = [("queue", req.t_submit, req.t_bucket),
                      ("batch_formation", req.t_bucket, req.t_dispatch),
                      ("device", req.t_dispatch, req.t_exec),
                      ("decode", req.t_exec, req.t_decode)]
            hops = [(name, t1 - t0) for name, t0, t1 in stamps
                    if t0 is not None and t1 is not None]
            req.ctx.finish(
                "ok" if error is None
                else f"error:{type(error).__name__}",
                hops=hops, replica=req.replica)
        trace = get_tracer()
        if trace.enabled:
            trace.async_end("request", req.rid, cat="serve",
                            args={"error": error is not None})
        if self._slo is not None:
            self._slo.record(self._qos_class, t_fin - req.t_submit,
                             error=error is not None)
        try:
            if error is not None:
                self.metrics.on_fail(
                    expired=isinstance(error, DeadlineExceeded))
                req.future.set_exception(error)
            else:
                self.metrics.on_complete(t_fin - req.t_submit)
                req.future.set_result(result)
        except Exception:  # noqa: BLE001 — future cancelled by caller;
            # the server-side work still completed and is accounted
            pass
        finally:
            self._slots.release()
