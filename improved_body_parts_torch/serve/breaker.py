"""Failure-rate circuit breaker: stop routing to a replica that keeps
failing, probe it back to life after a cooldown (the port's own copy of
``improved_body_parts_tpu/serve/breaker.py``; plain host code).

The pool's failover machinery (``serve.pool.EnginePool``) re-submits a
failed request to another replica — correct per request, but a replica
whose program is poisoned (raises on every execute) would keep eating a
first attempt from every unlucky request routed to it.  The breaker is
the aggregate view: a sliding window of recent outcomes trips OPEN past
a failure-rate threshold, the replica stops receiving traffic at all,
and after ``cooldown_s`` a bounded number of HALF-OPEN probe requests
test whether it healed — probes all succeed and the breaker closes,
any probe fails and the cooldown restarts.

States (the classic three):

- ``closed``    — healthy, all traffic flows, outcomes recorded;
- ``open``      — tripped, :meth:`allow` is False until the cooldown;
- ``half_open`` — cooldown passed, up to ``half_open_probes`` requests
  are admitted to test the waters.

Thread-safe; every transition is taken under one lock.  The clock is
injectable so tests drive the cooldown deterministically instead of
sleeping.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

#: state -> numeric code for gauges (obs exposition)
STATE_CODES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Sliding-window failure-rate breaker with half-open probing.

    ::

        breaker = CircuitBreaker(failure_threshold=0.5, min_requests=8)
        if breaker.allow():
            try:
                ...  # the guarded call
                breaker.record_success()
            except Exception:
                breaker.record_failure()
                raise

    ``min_requests`` is the volume floor: a window with fewer outcomes
    never trips (one failed request out of one is 100% failure rate but
    zero evidence).
    """

    def __init__(self, *, failure_threshold: float = 0.5,
                 min_requests: int = 8, window: int = 32,
                 cooldown_s: float = 5.0, half_open_probes: int = 2,
                 clock: Optional[Callable[[], float]] = None):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(f"failure_threshold={failure_threshold} "
                             "must be in (0, 1]")
        if min_requests < 1 or window < min_requests:
            raise ValueError(f"need window >= min_requests >= 1, got "
                             f"window={window} min_requests={min_requests}")
        if half_open_probes < 1:
            raise ValueError(f"half_open_probes={half_open_probes} "
                             "must be >= 1")
        self.failure_threshold = failure_threshold
        self.min_requests = min_requests
        self.cooldown_s = cooldown_s
        self.half_open_probes = half_open_probes
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._window: "deque[bool]" = deque(maxlen=window)  # True = fail
        self._state = "closed"
        self._opened_at = 0.0
        self._probes_out = 0       # half-open: probes admitted
        self._probe_successes = 0  # half-open: probes that came back ok
        self.trips = 0             # lifetime open transitions (telemetry)

    # ---------------------------------------------------------- readouts
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    @property
    def state_code(self) -> float:
        """Numeric state for gauges: 0 closed, 1 half-open, 2 open."""
        return STATE_CODES[self.state]

    def failure_rate(self) -> float:
        with self._lock:
            if not self._window:
                return 0.0
            return sum(self._window) / len(self._window)

    # ------------------------------------------------------- transitions
    def _maybe_half_open_locked(self) -> None:
        if self._state == "open" and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._state = "half_open"
            self._probes_out = 0
            self._probe_successes = 0

    def _trip_locked(self) -> None:
        self._state = "open"
        self._opened_at = self._clock()
        self._window.clear()
        self.trips += 1

    def allow(self) -> bool:
        """May one request be routed here right now?  In half-open this
        CONSUMES a probe slot — call it once per actual submission."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == "closed":
                return True
            if self._state == "half_open" and \
                    self._probes_out < self.half_open_probes:
                self._probes_out += 1
                return True
            return False

    def release_probe(self) -> None:
        """Give back a half-open probe slot that was consumed by
        :meth:`allow` but never turned into a real submission (the
        replica shed the request) — without this the slot would stay
        consumed with no outcome ever recorded and the breaker could
        wedge in half-open."""
        with self._lock:
            if self._state == "half_open" and self._probes_out > 0:
                self._probes_out -= 1

    def probation(self) -> None:
        """Straight to half-open (a restarted replica earns its traffic
        back through bounded probes instead of a full reopen)."""
        with self._lock:
            self._state = "half_open"
            self._probes_out = 0
            self._probe_successes = 0
            self._window.clear()

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    # the replica healed: fresh window, full traffic
                    self._state = "closed"
                    self._window.clear()
                return
            if self._state == "closed":
                self._window.append(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                # a probe failed: straight back to open, new cooldown
                self._trip_locked()
                return
            if self._state != "closed":
                return
            self._window.append(True)
            if len(self._window) >= self.min_requests and \
                    sum(self._window) / len(self._window) \
                    >= self.failure_threshold:
                self._trip_locked()

    def reset(self) -> None:
        """Force-close (a replica restart wipes the evidence)."""
        with self._lock:
            self._state = "closed"
            self._window.clear()
            self._probes_out = 0
            self._probe_successes = 0
