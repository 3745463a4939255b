"""Client-side request policy: deadlines, bounded retry-with-backoff,
hedged dispatch (the port's own copy of
``improved_body_parts_tpu/serve/policy.py``).

The server side already speaks the right statuses — ``ServerOverloaded``
is the explicit load-shed/draining signal and ``DeadlineExceeded`` the
server-side fail-fast for stale work — but every caller so far
re-implemented the client half by hand (the benches' fixed 2 ms retry
sleep, the stream session's overload loop).  This module is that half,
once:

- :func:`jittered_backoff` / :func:`submit_with_retry` — the shared
  retry discipline for ``ServerOverloaded``: exponential backoff with
  multiplicative jitter (a fleet of shedding clients must not re-arrive
  in lockstep), bounded attempts, abort hook for draining targets.
- :class:`PolicyClient` — per-request deadlines (enforced client-side
  by a timer AND server-side via ``submit(deadline_s=)``), admission
  retry, and an optional **hedged second dispatch**: past
  ``hedge_after_s`` with no result, the same image is submitted again
  (through the pool's least-loaded routing that usually lands on a
  different replica) and the first result wins — the classic
  tail-latency-at-scale trade of a little extra work for a bounded p99.

Everything here is host-side bookkeeping around futures; no device
state, no threads beyond ``threading.Timer`` fired per armed deadline/
hedge (cancelled on completion).
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Tuple

from ..obs.reqtrace import NULL_NODE, get_reqtrace
from .batcher import DeadlineExceeded, ServerOverloaded


def jittered_backoff(attempt: int, base_s: float = 0.002,
                     max_s: float = 0.25, jitter: float = 0.5,
                     rng: Optional[random.Random] = None) -> float:
    """Delay before retry ``attempt`` (1-based): exponential growth
    capped at ``max_s``, scaled by a uniform multiplicative jitter in
    ``[1 - jitter, 1 + jitter]`` so retrying clients decorrelate."""
    if attempt < 1:
        raise ValueError(f"attempt={attempt} is 1-based")
    delay = min(base_s * (2.0 ** (attempt - 1)), max_s)
    r = rng.random() if rng is not None else random.random()
    return delay * (1.0 - jitter + 2.0 * jitter * r)


def submit_with_retry(submit: Callable[..., Future], *args,
                      max_attempts: Optional[int] = None,
                      base_s: float = 0.002, max_s: float = 0.25,
                      jitter: float = 0.5,
                      rng: Optional[random.Random] = None,
                      should_abort: Optional[Callable[[], bool]] = None,
                      **kwargs) -> Tuple[Future, int]:
    """Call ``submit(*args, **kwargs)``, retrying ``ServerOverloaded``
    with jittered exponential backoff; returns ``(future, retries)`` so
    load generators can report how often they were shed instead of
    counting a shed as a failure.

    ``max_attempts=None`` retries until admitted (the closed-loop bench
    contract); ``should_abort`` (e.g. ``lambda: server.draining``) stops
    retrying against a target that will never admit again and re-raises
    the last ``ServerOverloaded``.
    """
    attempt = 0
    while True:
        try:
            return submit(*args, **kwargs), attempt
        except ServerOverloaded:
            if should_abort is not None and should_abort():
                raise
            attempt += 1
            if max_attempts is not None and attempt >= max_attempts:
                raise
            time.sleep(jittered_backoff(attempt, base_s, max_s, jitter,
                                        rng))


class PolicyStats:
    """Thread-safe counters for one :class:`PolicyClient` (snapshot is
    the JSON-artifact shape; ``register_into`` follows the ServeMetrics
    collector discipline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.admission_retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.deadline_expired = 0

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "admission_retries": self.admission_retries,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "deadline_expired": self.deadline_expired,
            }

    def register_into(self, registry, prefix: str = "policy"
                      ) -> "PolicyStats":
        import weakref

        ref = weakref.ref(self)

        def _collect():
            s = ref()
            if s is None:
                return []
            return [(f"{prefix}_{name}_total", {}, "counter", float(v))
                    for name, v in s.snapshot().items()]

        registry.register_collector(_collect)
        return self


class _Flight:
    """One policy-level request: its caller-facing future, the set of
    engine attempts still outstanding, and the timers armed for it."""

    __slots__ = ("future", "lock", "outstanding", "last_error", "timers",
                 "won_by", "ctx", "t0", "t_admitted", "t_hedge",
                 "last_node")

    def __init__(self):
        self.future: Future = Future()
        self.lock = threading.Lock()
        self.outstanding = 0
        self.last_error: Optional[BaseException] = None
        self.timers: list = []
        self.won_by: Optional[str] = None
        self.ctx = NULL_NODE            # reqtrace node (obs.reqtrace)
        self.t0 = time.perf_counter()
        self.t_admitted: Optional[float] = None
        self.t_hedge: Optional[float] = None  # hedge admission instant
        self.last_node = None           # last attempt's child node


class PolicyClient:
    """Deadline / retry / hedge wrapper around anything with the
    ``submit(image, deadline_s=...)`` contract (a ``DynamicBatcher`` or
    an ``EnginePool``).

    ::

        client = PolicyClient(pool, deadline_s=2.0, hedge_after_s=0.5)
        skeletons = client.submit(img).result()

    - **deadline**: the remaining budget rides into every engine submit
      (server-side fail-fast before device dispatch) AND a client timer
      fails the caller's future with :class:`DeadlineExceeded` the
      moment the budget lapses — the latency promise holds even when
      the engine is wedged.
    - **retry**: admission (``ServerOverloaded``) retries with jittered
      backoff on the caller's thread, bounded by ``max_attempts`` and
      the deadline.
    - **hedge**: with ``hedge_after_s`` set, a request still unresolved
      past that age dispatches a second copy; first RESULT wins, an
      error only surfaces once every outstanding attempt failed.  At
      most one hedge per request — the tail is the target, not a
      retry storm.
    """

    def __init__(self, engine, *, deadline_s: Optional[float] = None,
                 max_attempts: int = 4, backoff_base_s: float = 0.002,
                 backoff_max_s: float = 0.25, jitter: float = 0.5,
                 hedge_after_s: Optional[float] = None, seed: int = 0,
                 stats: Optional[PolicyStats] = None, slo=None,
                 qos_class: str = "interactive"):
        if max_attempts < 1:
            raise ValueError(f"max_attempts={max_attempts} must be >= 1")
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError(f"hedge_after_s={hedge_after_s} must be > 0")
        self.engine = engine
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.hedge_after_s = hedge_after_s
        self.stats = stats or PolicyStats()
        # optional SLO wiring: the policy client is the outermost layer
        # — what it resolves is the caller's experienced outcome, the
        # deadline/hedge machinery included (attach at ONE layer — see
        # DynamicBatcher)
        self._slo = slo
        self._qos_class = qos_class
        self._locked_rng = self._LockedRng(random.Random(seed),
                                           threading.Lock())

    # ------------------------------------------------------------ submit
    def submit(self, image, *,
               deadline_s: Optional[float] = None) -> Future:
        """Submit under policy; returns a future that ALWAYS resolves —
        with the decoded result, the engine's error once every attempt
        failed, or :class:`DeadlineExceeded`.

        :raises ServerOverloaded: admission still shed after
            ``max_attempts`` (nothing in flight — the caller's cue to
            back off at its own layer).
        :raises DeadlineExceeded: the deadline lapsed while still
            retrying admission (nothing was ever admitted).
        """
        budget = self.deadline_s if deadline_s is None else deadline_s
        deadline = (None if budget is None
                    else time.perf_counter() + budget)
        flight = _Flight()
        rt = get_reqtrace()
        if rt.enabled:
            flight.ctx = rt.begin("policy")
        try:
            # raises if never admitted
            fut, node = self._admit(flight, image, deadline)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            flight.ctx.finish(f"error:{type(e).__name__}",
                              hops=[("admit", time.perf_counter()
                                     - flight.t0)])
            raise
        flight.t_admitted = time.perf_counter()
        self.stats.add(submitted=1)
        with flight.lock:
            flight.outstanding += 1
        fut.add_done_callback(
            lambda f: self._on_attempt_done(flight, f, "primary", node))
        if deadline is not None:
            self._arm(flight, max(0.0, deadline - time.perf_counter()),
                      lambda: self._on_deadline(flight))
        if self.hedge_after_s is not None:
            self._arm(flight, self.hedge_after_s,
                      lambda: self._hedge(flight, image, deadline))
        return flight.future

    def call(self, image, *, deadline_s: Optional[float] = None):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(image, deadline_s=deadline_s).result()

    # ---------------------------------------------------------- plumbing
    class _LockedRng:
        """Thread-safe ``random()`` view over the client's seeded RNG
        (submits come from many caller threads)."""

        def __init__(self, rng: random.Random, lock: threading.Lock):
            self._rng, self._lock = rng, lock

        def random(self) -> float:
            with self._lock:
                return self._rng.random()

    def _admit(self, flight: _Flight, image,
               deadline: Optional[float]) -> Tuple[Future, object]:
        """Engine admission with bounded jittered retry; the caller's
        thread sleeps the backoff (a closed-loop client by design).
        Returns ``(engine_future, reqtrace_child_node)`` — a retried
        admission lands as a reason-annotated ``retry`` edge naming how
        many sheds preceded it."""
        attempt = 0
        while True:
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self.stats.add(deadline_expired=1)
                    raise DeadlineExceeded(
                        "deadline lapsed before admission")
            else:
                remaining = None
            try:
                with flight.ctx.child_scope(
                        "submit" if attempt == 0 else "retry",
                        None if attempt == 0
                        else f"sheds={attempt}") as scope:
                    fut = self.engine.submit(image, deadline_s=remaining)
                return fut, scope.node
            except ServerOverloaded:
                attempt += 1
                if attempt >= self.max_attempts or \
                        getattr(self.engine, "draining", False):
                    raise
                self.stats.add(admission_retries=1)
                # the ONE retry discipline (no inline fork of the
                # formula that could drift from the helper's)
                delay = jittered_backoff(
                    attempt, self.backoff_base_s, self.backoff_max_s,
                    self.jitter, rng=self._locked_rng)
                if remaining is not None:
                    delay = min(delay, max(0.0, remaining))
                time.sleep(delay)

    def _arm(self, flight: _Flight, delay_s: float,
             fire: Callable[[], None]) -> None:
        timer = threading.Timer(delay_s, fire)
        timer.daemon = True
        with flight.lock:
            if flight.future.done():
                return
            flight.timers.append(timer)
        timer.start()

    @staticmethod
    def _cancel_timers(flight: _Flight) -> None:
        # caller holds flight.lock
        for t in flight.timers:
            t.cancel()
        flight.timers.clear()

    def _resolve(self, flight: _Flight, kind: str, result=None,
                 error: Optional[BaseException] = None, node=None,
                 t_done: Optional[float] = None) -> bool:
        with flight.lock:
            if flight.future.done():
                return False
            self._cancel_timers(flight)
            flight.won_by = kind
            if flight.ctx.sampled:
                # policy-node hop bookends: admit (admission incl. shed
                # backoff), hedge_wait (the gap hop — time spent
                # waiting on the primary before the winning hedge was
                # even dispatched), deliver (attempt resolution → this
                # future).  The winning attempt's span covers the rest.
                now = time.perf_counter()
                hops = []
                if flight.t_admitted is not None:
                    hops.append(("admit",
                                 flight.t_admitted - flight.t0))
                if kind == "hedge" and flight.t_hedge is not None \
                        and flight.t_admitted is not None:
                    hops.append(("hedge_wait",
                                 flight.t_hedge - flight.t_admitted))
                if t_done is not None:
                    hops.append(("deliver", now - t_done))
                flight.ctx.finish(
                    "ok" if error is None
                    else f"error:{type(error).__name__}",
                    hops=hops, won_by=node, won_kind=kind)
            if self._slo is not None:
                self._slo.record(self._qos_class,
                                 time.perf_counter() - flight.t0,
                                 error=error is not None)
            try:
                if error is not None:
                    flight.future.set_exception(error)
                else:
                    flight.future.set_result(result)
            except Exception:  # noqa: BLE001 — caller cancelled; the
                # outcome is still accounted below
                pass
        return True

    def _on_attempt_done(self, flight: _Flight, fut: Future,
                         kind: str, node=None) -> None:
        t_done = time.perf_counter()
        try:
            result = fut.result()
            error = None
        except BaseException as e:  # noqa: BLE001 — delivered or held
            result, error = None, e
        if error is None:
            if self._resolve(flight, kind, result=result, node=node,
                             t_done=t_done) and kind == "hedge":
                self.stats.add(hedge_wins=1)
            return
        with flight.lock:
            flight.outstanding -= 1
            flight.last_error = error
            flight.last_node = node if node is not None \
                else flight.last_node
            deliver = flight.outstanding <= 0
        if deliver:
            # every outstanding attempt failed: surface the last error
            self._resolve(flight, kind, error=error, node=node,
                          t_done=t_done)

    def _on_deadline(self, flight: _Flight) -> None:
        if self._resolve(flight, "deadline", error=DeadlineExceeded(
                "request deadline exceeded (client policy)")):
            self.stats.add(deadline_expired=1)

    def _hedge(self, flight: _Flight, image,
               deadline: Optional[float]) -> None:
        remaining = (None if deadline is None
                     else deadline - time.perf_counter())
        if remaining is not None and remaining <= 0:
            return
        with flight.lock:
            if flight.future.done():
                return
            # RESERVE the attempt slot before the submit window: a
            # primary failing while this hedge is mid-admission must
            # wait for it (the hedge exists exactly to cover that
            # failure), not race past outstanding==0 and deliver the
            # error while a winnable attempt is seconds from flight
            flight.outstanding += 1
        try:
            with flight.ctx.child_scope(
                    "hedge",
                    f"hedge_after_s={self.hedge_after_s}") as scope:
                fut = self.engine.submit(image, deadline_s=remaining)
        except Exception:  # noqa: BLE001 — a shed/draining hedge is
            # simply not taken; release the reservation, and if the
            # primary already failed while waiting on us, deliver now
            self._attempt_abandoned(flight)
            return
        flight.t_hedge = time.perf_counter()
        self.stats.add(hedges=1)
        fut.add_done_callback(
            lambda f, nd=scope.node:
            self._on_attempt_done(flight, f, "hedge", nd))

    def _attempt_abandoned(self, flight: _Flight) -> None:
        with flight.lock:
            flight.outstanding -= 1
            error = flight.last_error
            # the failed attempt whose error we are delivering: the
            # chain must end at ITS leaf, not dangle at the policy
            # root (an interior chain end is a completeness violation)
            node = flight.last_node
            deliver = flight.outstanding <= 0 and error is not None
        if deliver:
            self._resolve(flight, "primary", error=error, node=node)
