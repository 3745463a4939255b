"""Fault-tolerant replica pool: N shared-nothing ``DynamicBatcher``
engines behind one health-checked, failover-capable router (the port's
own copy of ``improved_body_parts_tpu/serve/pool.py``; on one card the
replicas are ``Predictor.device_replica("cuda")`` copies).

One ``DynamicBatcher`` is one failure domain: a wedged fetcher, a dying
decode pool or one slow device takes every request and every stream
down with it.  :class:`EnginePool` is the control plane above it
(ROADMAP "fleet-scale serving"): each replica is a whole batcher with
its own dispatcher/fetcher/decode threads (shared-nothing — replicas
never share mutable state, only the process), and the pool adds:

- **health-checked routing** — a probe thread samples each replica's
  :meth:`DynamicBatcher.health` (thread liveness + the ``ServeMetrics``
  stall clock: queue depth stuck above zero with no completions for
  ``wedge_timeout_s`` means wedged) and requests route to the
  least-loaded LIVE replica;
- **circuit breaking** — per-replica :class:`serve.breaker
  .CircuitBreaker` fed by request outcomes; a replica whose failure
  rate trips the breaker is treated exactly like a crashed one;
- **fencing + failover** — a replica that wedges, crashes a stage
  thread, stops out from under the pool, or trips its breaker is
  FENCED: routing stops, a drain thread runs the batcher's bounded
  graceful stop, and every in-flight request the drain fails is
  **re-submitted to a healthy replica**.  The pool hands out its own
  futures, so failover is invisible to callers: every ``submit()``
  resolves with a result or a typed error, never silently lost;
- **recovery** — :meth:`restart` (or ``restart_after_s`` for automatic
  probation) brings a fenced replica back: the batcher restarts, and a
  breaker-fenced replica re-enters through HALF-OPEN probes instead of
  full traffic.

The pool keeps a single batcher's ``submit``/``draining`` contract, so
anything that drives a batcher (a ``PolicyClient``, a cascade tier, the
process router's proxies below it) drives a pool unchanged.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs.reqtrace import NULL_NODE, get_reqtrace
from .batcher import DeadlineExceeded, DynamicBatcher, ServerOverloaded
from .breaker import CircuitBreaker
from .metrics import ServeMetrics

_PRID = itertools.count(1)

#: replica lifecycle states -> gauge codes
REPLICA_STATE_CODES = {"live": 0.0, "fenced": 1.0, "restarting": 2.0}


class _PoolRequest:
    __slots__ = ("image", "future", "t_submit", "deadline", "attempts",
                 "tried", "finished", "rid", "ctx", "attempt_log",
                 "last_error_type")

    def __init__(self, image, deadline_s: Optional[float]):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (None if deadline_s is None
                         else self.t_submit + deadline_s)
        self.attempts = 0          # failover re-submissions so far
        self.tried: set = set()    # replica indices that failed it
        self.finished = False
        self.rid = next(_PRID)
        self.ctx = NULL_NODE       # reqtrace node (obs.reqtrace)
        # (child_node, t_admitted) per engine attempt, in order — what
        # lets the finish hop account name the time burned on attempts
        # that failed over before the winner's
        self.attempt_log: list = []
        self.last_error_type: Optional[str] = None

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.perf_counter()


class _Replica:
    __slots__ = ("engine", "breaker", "state", "fence_reason",
                 "fenced_at", "drain")

    def __init__(self, engine, breaker: CircuitBreaker):
        self.engine = engine
        self.breaker = breaker
        self.state = "live"
        self.fence_reason: Optional[str] = None
        self.fenced_at = 0.0
        self.drain: Optional[threading.Thread] = None  # fence's drain


class EnginePool:
    """Health-checked router over N ``DynamicBatcher`` replicas.

    ::

        engines = [DynamicBatcher(pred_a, ...), DynamicBatcher(pred_b, ...)]
        with EnginePool(engines, wedge_timeout_s=2.0) as pool:
            pool.warmup([(256, 256)])
            fut = pool.submit(image)           # same contract as a batcher
            skeletons = fut.result()

    Replicas must be SHARED-NOTHING: each engine gets its own predictor
    (``Predictor.device_replica`` per device, or independent predictors
    on one host) — two batchers driving one predictor object would race
    its state from two dispatcher threads.

    Knobs: ``probe_interval_s`` (health sampling cadence),
    ``wedge_timeout_s`` (stall age past which an in-flight replica is
    wedged), ``drain_timeout_s`` (bound on a fenced replica's graceful
    drain — past it the batcher fails stranded futures and the pool
    fails them over), ``max_failovers`` (re-submission bound per
    request, default one try per replica), ``breaker_kw`` (forwarded to
    each replica's :class:`CircuitBreaker`), ``fence_on_breaker``
    (a tripped breaker fences the replica instead of merely gating
    routing), ``restart_after_s`` (automatic probation for fenced
    replicas; ``None`` = :meth:`restart` is manual).
    """

    def __init__(self, engines: Sequence[DynamicBatcher], *,
                 probe_interval_s: float = 0.2,
                 wedge_timeout_s: float = 10.0,
                 drain_timeout_s: float = 5.0,
                 max_failovers: Optional[int] = None,
                 breaker_kw: Optional[dict] = None,
                 fence_on_breaker: bool = True,
                 restart_after_s: Optional[float] = None,
                 on_fence: Optional[Callable[[int, str], None]] = None,
                 metrics: Optional[ServeMetrics] = None,
                 registry=None, slo=None,
                 qos_class: str = "interactive"):
        if not engines:
            raise ValueError("EnginePool needs at least one engine")
        kw = dict(breaker_kw or {})
        self._replicas = [_Replica(e, CircuitBreaker(**kw))
                          for e in engines]
        self.probe_interval_s = probe_interval_s
        self.wedge_timeout_s = wedge_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.max_failovers = (len(engines) if max_failovers is None
                              else max_failovers)
        self.fence_on_breaker = fence_on_breaker
        self.restart_after_s = restart_after_s
        self._on_fence = on_fence
        # pool-level request accounting rides the same ServeMetrics
        # conservation contract as a single engine: submitted ==
        # completed + failed + depth, across any number of failovers
        # (one pool request is ONE submit no matter how many replicas
        # it visited)
        self.metrics = metrics or ServeMetrics()
        # optional SLO wiring: pool-level outcomes are what the caller
        # experiences (failover absorbed), so this is the natural SLO
        # attachment point for a replicated deployment WITHOUT a
        # hedging PolicyClient above — every hedge is a SECOND pool
        # submit, so under hedging the pool records attempts, not
        # caller requests: attach to the PolicyClient there instead
        # (attach at ONE layer — see DynamicBatcher)
        self._slo = slo
        self._qos_class = qos_class
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "failovers": 0,      # replica attempts that failed over
            "resubmitted": 0,    # re-submissions that were admitted
            "fenced": 0,
            "restarts": 0,
        }
        self._running = False
        self._draining = False
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._drain_threads: List[threading.Thread] = []
        # the batcher's stop discipline, one level up: concurrent
        # stop() callers serialize; the first drains, the rest wait
        self._stop_lock = threading.Lock()
        if registry is not None:
            self.register_into(registry)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "EnginePool":
        if self._running:
            return self
        for r in self._replicas:
            r.engine.start()
        self._running = True
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="pool-probe", daemon=True)
        self._probe_thread.start()
        return self

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Drain the whole pool: admission closes first (the
        ``ServerOverloaded`` rolling-restart contract), every replica
        runs its bounded graceful stop against ONE shared deadline, and
        in-flight pool requests resolve — with results where the drains
        complete, with the drain error where they don't (no failover
        during pool shutdown: there is nowhere left to go).  Idempotent
        and thread-safe under concurrent callers."""
        with self._stop_lock:
            self._stop_locked(drain_timeout_s)

    def _stop_locked(self, drain_timeout_s: Optional[float]) -> None:
        if not self._running and self._probe_thread is None:
            return
        self._draining = True
        self._running = False
        deadline = (None if drain_timeout_s is None
                    else time.perf_counter() + drain_timeout_s)

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(0.0, deadline - time.perf_counter())

        self._probe_stop.set()
        probe, self._probe_thread = self._probe_thread, None
        if probe is not None:
            probe.join(remaining())
        for r in self._replicas:
            r.engine.stop(drain_timeout_s=remaining())
        with self._lock:
            drains = list(self._drain_threads)
            self._drain_threads = []
        for t in drains:
            t.join(remaining())
        self._draining = False

    def __enter__(self) -> "EnginePool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def draining(self) -> bool:
        """True once a pool-wide stop began (the session/policy layers
        read this through the same duck-typed contract as a batcher)."""
        return self._draining

    @property
    def engines(self) -> List[DynamicBatcher]:
        return [r.engine for r in self._replicas]

    def replica_states(self) -> List[dict]:
        """Snapshot of every replica's routing state (JSON-ready)."""
        out = []
        with self._lock:
            replicas = list(self._replicas)
        for i, r in enumerate(replicas):
            out.append({
                "replica": i,
                "state": r.state,
                "fence_reason": r.fence_reason,
                "breaker": r.breaker.state,
                "queue_depth": r.engine.metrics.depth,
            })
        return out

    # ------------------------------------------------------------- warmup
    def warmup(self, image_sizes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> dict:
        """Warm every replica's bucket programs (each replica's
        predictor keeps its own warm set, so each pays its own first
        runs); returns the first replica's summary."""
        out = None
        for r in self._replicas:
            info = r.engine.warmup(image_sizes, batch_sizes=batch_sizes)
            out = out or info
        return out

    # ------------------------------------------------------------- submit
    def submit(self, image, *,
               deadline_s: Optional[float] = None) -> Future:
        """Route one request to the least-loaded healthy replica;
        returns a POOL future that always resolves — with the decoded
        skeletons, with :class:`DeadlineExceeded`, or with the last
        replica error once failover is exhausted.  A replica failure
        mid-flight is retried on another healthy replica without the
        caller noticing.

        :raises ServerOverloaded: every healthy replica shed the
            request (or none is healthy) — the retry-with-backoff
            status, exactly as from a single batcher.
        :raises DeadlineExceeded: ``deadline_s`` non-positive at submit.
        :raises RuntimeError: the pool is not running.
        """
        if self._draining:
            self.metrics.on_reject()
            raise ServerOverloaded(
                "pool is draining (shutdown in progress); retry "
                "against a live pool")
        if not self._running:
            raise RuntimeError("EnginePool is not running "
                               "(use `with pool:` or call start())")
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.on_expire_rejected()
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit")
        preq = _PoolRequest(image, deadline_s)
        rt = get_reqtrace()
        if rt.enabled:
            preq.ctx = rt.begin("pool")
        if not self._route(preq, first=True):
            # the node opened above MUST close on this raise path too:
            # an unfinished node wedges its request's tree forever (the
            # record never emits, the recorder's live entry leaks)
            preq.ctx.finish("error:ServerOverloaded")
            self.metrics.on_reject()
            raise ServerOverloaded(
                "no healthy replica admitted the request (all fenced, "
                "open-breaker, or shedding); retry with backoff")
        return preq.future

    # ------------------------------------------------------------ routing
    def _candidates(self, exclude: set) -> List[int]:
        with self._lock:
            live = [i for i, r in enumerate(self._replicas)
                    if r.state == "live" and i not in exclude]
        # least-loaded first: the replica ServeMetrics depth is the
        # admitted-not-done count, the same signal the dispatcher's
        # in-flight routing uses one level down
        return sorted(live,
                      key=lambda i: self._replicas[i].engine.metrics.depth)

    def _route(self, preq: _PoolRequest, *, first: bool) -> bool:
        """Try to place ``preq`` on a healthy replica.  Returns True
        when the request was admitted somewhere (or resolved on the
        spot); False when every candidate refused — the caller decides
        whether that is a submit-time ``ServerOverloaded`` (first
        placement) or a failover give-up."""
        # the causal hop edge this placement creates: a first placement
        # is a plain submit; a re-placement after a replica failure is
        # a FAILOVER edge annotated with the error that forced it
        kind = "submit" if first else "failover"
        reason = None if first else preq.last_error_type
        for idx in self._candidates(preq.tried):
            r = self._replicas[idx]
            if not r.breaker.allow():
                continue
            with preq.ctx.child_scope(kind, reason) as scope:
                try:
                    fut = r.engine.submit(preq.image,
                                          deadline_s=preq.remaining())
                except ServerOverloaded:
                    # shed is backpressure, not a fault: no breaker
                    # outcome — but give back the half-open probe slot
                    # it consumed
                    r.breaker.release_probe()
                    continue
                except DeadlineExceeded as e:
                    # the GLOBAL deadline lapsed while routing: resolve
                    r.breaker.release_probe()
                    self._finish(preq, error=e, first=first)
                    return True
                except RuntimeError:
                    # replica stopped between the health read and
                    # submit; the probe loop will fence it — move on
                    r.breaker.release_probe()
                    continue
            preq.attempt_log.append((scope.node, time.perf_counter()))
            if first:
                self.metrics.on_submit()
            else:
                with self._lock:
                    self._counters["resubmitted"] += 1
            # attach AFTER the pool-level on_submit so completion
            # accounting can never run ahead of submission accounting
            fut.add_done_callback(
                lambda f, i=idx, nd=scope.node:
                self._on_replica_done(preq, i, f, nd))
            return True
        return False

    def _on_replica_done(self, preq: _PoolRequest, idx: int,
                         fut: Future, node=None) -> None:
        """One replica attempt resolved (runs on that replica's
        completion threads): deliver, or fail over.  ``node`` is the
        attempt's reqtrace child — the ``won_by`` chain link when this
        attempt's outcome is the one delivered."""
        t_done = time.perf_counter()
        try:
            result = fut.result()
            error = None
        except BaseException as e:  # noqa: BLE001 — classified below
            result, error = None, e
        r = self._replicas[idx]
        if error is None:
            r.breaker.record_success()
            self._finish(preq, result=result, node=node, t_done=t_done)
            return
        if isinstance(error, DeadlineExceeded):
            # the deadline is global to the request: another replica
            # cannot un-expire it, and a deadline says nothing about
            # THIS replica's health — no breaker outcome, no failover.
            # But a half-open probe slot consumed at routing must come
            # back (no outcome will ever be recorded for it), or
            # enough expiring probes would wedge the breaker half-open
            r.breaker.release_probe()
            self._finish(preq, error=error, node=node, t_done=t_done)
            return
        r.breaker.record_failure()
        if self.fence_on_breaker and r.breaker.state == "open":
            self.fence(idx, "breaker_open")
        preq.tried.add(idx)
        preq.attempts += 1
        preq.last_error_type = type(error).__name__
        with self._lock:
            self._counters["failovers"] += 1
        if self._draining or preq.attempts > self.max_failovers or \
                (preq.deadline is not None and preq.remaining() <= 0):
            self._finish(preq, error=error, node=node, t_done=t_done)
            return
        try:
            placed = self._route(preq, first=False)
        except Exception as e:  # noqa: BLE001 — a routing bug must fail
            # THIS request, never strand it or kill a fetch thread
            self._finish(preq, error=e, node=node, t_done=t_done)
            return
        if not placed:
            # nowhere healthy left: the caller gets the replica error
            # (typed), not a hang
            self._finish(preq, error=error, node=node, t_done=t_done)

    def _finish(self, preq: _PoolRequest, result=None,
                error: Optional[BaseException] = None,
                first: bool = False, node=None,
                t_done: Optional[float] = None) -> None:
        """Resolve one pool request exactly once (the `_finish`
        discipline one level up: callbacks from a drained replica and a
        successful failover may race here)."""
        with self._lock:
            if preq.finished:
                return
            preq.finished = True
        if preq.ctx.sampled:
            # the pool node's hop bookends around its children's
            # windows: route (candidate selection + admission before
            # the first placement), prior_attempts (the gap hop — time
            # burned on attempts that failed over before the winning
            # one was even submitted), deliver (winner's resolution →
            # pool future).  The winner's own span covers the middle.
            t_fin = time.perf_counter()
            hops = []
            log = preq.attempt_log
            if log:
                hops.append(("route", log[0][1] - preq.t_submit))
                if node is not None:
                    widx = next((i for i, (nd, _) in enumerate(log)
                                 if nd is node), None)
                    if widx:
                        hops.append(("prior_attempts",
                                     log[widx][1] - log[0][1]))
            if t_done is not None:
                hops.append(("deliver", t_fin - t_done))
            preq.ctx.finish(
                "ok" if error is None
                else f"error:{type(error).__name__}",
                hops=hops, won_by=node, failovers=preq.attempts)
        if first:
            # resolved during its own submit() call, before the pool
            # counted it submitted: count both sides so conservation
            # (submitted == completed + failed + depth) stays exact
            self.metrics.on_submit()
        if self._slo is not None:
            self._slo.record(self._qos_class,
                             time.perf_counter() - preq.t_submit,
                             error=error is not None)
        try:
            if error is not None:
                self.metrics.on_fail(
                    expired=isinstance(error, DeadlineExceeded))
                preq.future.set_exception(error)
            else:
                self.metrics.on_complete(time.perf_counter()
                                         - preq.t_submit)
                preq.future.set_result(result)
        except Exception:  # noqa: BLE001 — future cancelled by caller;
            # the outcome is still accounted
            pass

    # ----------------------------------------------------- fence / revive
    def fence(self, idx: int, reason: str) -> bool:
        """Take replica ``idx`` out of routing and drain it in the
        background: the batcher's bounded graceful stop completes what
        it can, fails the rest, and those failures arrive at
        :meth:`_on_replica_done` — which re-submits them to healthy
        replicas.  Idempotent per fence; returns True when this call
        did the fencing."""
        with self._lock:
            r = self._replicas[idx]
            if r.state != "live":
                return False
            r.state = "fenced"
            r.fence_reason = reason
            r.fenced_at = time.monotonic()
            self._counters["fenced"] += 1
            if not self._draining:
                # pool stop() drains every replica itself — a fence
                # racing it must not spawn a drain thread the join
                # snapshot already missed.  The thread is STARTED
                # before it becomes visible (r.drain / the join list /
                # the fenced state other threads react to): a restart
                # or pool stop joining a not-yet-started Thread raises.
                # Dead threads from earlier fence cycles are pruned
                # here so a long-lived pool's join list stays bounded.
                drain = threading.Thread(
                    target=self._drain_replica, args=(idx,),
                    name=f"pool-drain-{idx}", daemon=True)
                drain.start()
                self._drain_threads = [t for t in self._drain_threads
                                       if t.is_alive()] + [drain]
                r.drain = drain
        from ..obs.events import get_sink

        get_sink().emit("replica_fenced", replica=idx, reason=reason)
        cb = self._on_fence
        if cb is not None:
            try:
                cb(idx, reason)
            except Exception:  # noqa: BLE001 — an observer bug must not
                pass           # break fencing
        return True

    def _drain_replica(self, idx: int) -> None:
        try:
            self._replicas[idx].engine.stop(
                drain_timeout_s=self.drain_timeout_s)
        except Exception:  # noqa: BLE001 — a drain crash leaves the
            # replica fenced; its futures were failed by the batcher's
            # own machinery or will fail at pool stop
            pass

    def restart(self, idx: int) -> bool:
        """Bring a fenced replica back into routing.  The batcher
        restarts (its predictor's warm set survives, so no first-run
        costs come back), and a
        breaker-fenced replica re-enters on HALF-OPEN probation —
        bounded probe traffic until the breaker closes — while other
        fences reset the breaker outright.

        The engine starts BEFORE routing resumes, through a transient
        ``restarting`` state the router and probe both skip: flipping
        to live first would let the probe read a not-yet-running engine
        and instantly re-fence it as ``stopped`` (and ``start()`` itself
        waits out any still-draining stop under the engine's stop
        lock, so a restart racing the fence drain cannot have its fresh
        pipeline torn down by the old drain's tail)."""
        with self._lock:
            r = self._replicas[idx]
            if r.state != "fenced":
                return False
            reason, r.fence_reason = r.fence_reason, None
            r.state = "restarting"
            drain, r.drain = r.drain, None
        if drain is not None:
            # the fence's drain may not even have ENTERED engine.stop()
            # yet — starting before it completes would hand the old
            # drain's tail a fresh pipeline to tear down.  The drain is
            # bounded (drain_timeout_s), so this join is too.
            drain.join()
        r.engine.start()
        if reason == "breaker_open":
            r.breaker.probation()
        else:
            r.breaker.reset()
        with self._lock:
            r.state = "live"
            self._counters["restarts"] += 1
        from ..obs.events import get_sink

        get_sink().emit("replica_restarted", replica=idx,
                        after=reason)
        return True

    # -------------------------------------------------------- health loop
    def _probe_loop(self) -> None:
        while not self._probe_stop.wait(self.probe_interval_s):
            for idx in range(len(self._replicas)):
                try:
                    self._probe_one(idx)
                except Exception:  # noqa: BLE001 — a probe bug must not
                    continue       # kill the health loop

    def _probe_one(self, idx: int) -> None:
        r = self._replicas[idx]
        if r.state == "fenced":
            if self.restart_after_s is not None and \
                    time.monotonic() - r.fenced_at >= self.restart_after_s:
                self.restart(idx)
            return
        if r.state != "live":
            return      # restarting: engine mid-start, not probe-able
        if self.fence_on_breaker and r.breaker.state == "open":
            self.fence(idx, "breaker_open")
            return
        h = r.engine.health()
        if not h["running"] and not h["draining"]:
            # stopped out from under the pool (a crash-equivalent):
            # fence so routing stops; the batcher's own stop already
            # failed its in-flight futures into failover
            self.fence(idx, "stopped")
            return
        if h["running"] and (not h["dispatcher_alive"]
                             or h["fetchers_alive"]
                             < h["fetchers_expected"]):
            self.fence(idx, "thread_crashed")
            return
        stall = h["stall_age_s"]
        if stall is not None and stall >= self.wedge_timeout_s:
            self.fence(idx, "wedged")

    # ---------------------------------------------------------- telemetry
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def register_into(self, registry) -> "EnginePool":
        """Export pool request accounting, per-replica routing/breaker
        state and every replica's own ServeMetrics (labeled
        ``{replica=N}``) through a shared ``obs.Registry`` — the
        weakref-collector discipline of ``ServeMetrics.register_into``.
        """
        import weakref

        ref = weakref.ref(self)

        def _collect():
            p = ref()
            return p.collect() if p is not None else []

        registry.register_collector(_collect)
        return self

    def collect(self, prefix: str = "pool"):
        """(name, labels, kind, value) samples for ``obs.Registry``."""
        samples = list(self.metrics.collect(prefix))
        counters = self.counters()
        for name, v in counters.items():
            samples.append((f"{prefix}_{name}_total", {}, "counter",
                            float(v)))
        with self._lock:
            replicas = list(self._replicas)
        for i, r in enumerate(replicas):
            labels = {"replica": str(i)}
            samples += [
                (f"{prefix}_replica_state_code", labels, "gauge",
                 REPLICA_STATE_CODES.get(r.state, -1.0)),
                (f"{prefix}_breaker_state_code", labels, "gauge",
                 r.breaker.state_code),
                (f"{prefix}_breaker_trips_total", labels, "counter",
                 float(r.breaker.trips)),
            ]
            for name, lbl, kind, value in r.engine.metrics.collect(
                    f"{prefix}_engine"):
                samples.append((name, {**lbl, **labels}, kind, value))
        return samples

    def snapshot(self) -> dict:
        """JSON-ready pool state (the chaos-artifact shape)."""
        return {
            "pool": self.metrics.snapshot(),
            "counters": self.counters(),
            "replicas": [
                {**state,
                 "metrics": r.engine.metrics.snapshot()}
                for state, r in zip(self.replica_states(),
                                    self._replicas)],
        }
