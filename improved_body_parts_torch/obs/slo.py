"""Declarative SLOs with multi-window burn-rate and error budgets (the
port's own copy of ``improved_body_parts_tpu/obs/slo.py``).

The serving stack emits per-hop attribution (``obs.reqtrace``,
``serve.metrics``) — raw material.  An autoscaler or deploy gate
(ROADMAP "fleet-scale serving control plane") needs a *decision* signal:
is the service keeping its latency/availability promise, and how fast
is it spending the budget it is allowed to miss by?  This module is
that layer:

- :class:`Objective` — one QoS class's promise, declared as data: a
  request is GOOD when it succeeded AND answered within
  ``latency_ms``; the class must keep ``target`` of its requests good.
- :class:`SLOTracker` — fed one ``record()`` per finished request,
  computes per class:

  - **availability** over each burn window (good / total);
  - **burn rate** per window — ``bad_frac / (1 - target)``: 1.0 means
    spending exactly the sustainable budget, N means the budget burns
    N× too fast (the Google SRE multi-window convention);
  - **error budget remaining** — cumulative over the tracker's life:
    1.0 untouched, 0.0 exhausted;
  - **alarm** — burning faster than ``burn_alarm`` on EVERY window
    simultaneously (the fast window catches the cliff, the slow window
    filters blips) with at least ``min_requests`` in the fast window.
    Alarm *transitions* emit ``slo_alarm`` sink events — the
    autoscaler/pager edge, not a level repeated every scrape.

- Exposition: ``register_into`` publishes gauges/counters on the shared
  registry (``slo_burn_rate{class=,window=}``,
  ``slo_error_budget_remaining{class=}``, …); ``obs.http.MetricsServer``
  serves :meth:`SLOTracker.state` at ``/slo`` (HEAD parity like every
  route) so a stock controller can poll one JSON document.

Wiring: ``DynamicBatcher`` / ``EnginePool`` / ``PolicyClient`` accept
``slo=tracker, qos_class="..."`` and record every finished request.
Attach the tracker at ONE layer per deployment — the outermost one the
caller's promise is made at (recording the same request at two layers
double-counts it).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .events import get_sink


class Objective:
    """One QoS class's declarative promise.

    ``latency_ms``: a request slower than this is BAD even when it
    succeeded (the latency SLO and the availability SLO share one good
    count — a slow success spends the same budget as an error).
    ``target``: the good fraction promised (0 < target < 1).
    ``windows_s``: burn-rate windows, fastest first.
    ``burn_alarm``: the burn-rate multiple that fires the alarm when
    exceeded on every window at once.
    ``min_requests``: volume floor in the FAST window before the alarm
    may fire (ten bad requests out of ten is not a page).
    """

    __slots__ = ("name", "latency_ms", "target", "windows_s",
                 "burn_alarm", "min_requests")

    def __init__(self, name: str, latency_ms: float, target: float = 0.99,
                 windows_s: Sequence[float] = (60.0, 600.0),
                 burn_alarm: float = 2.0, min_requests: int = 10):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target={target} must be in (0, 1) — an "
                             "SLO of 1.0 has no error budget to burn")
        if latency_ms <= 0:
            raise ValueError(f"latency_ms={latency_ms} must be > 0")
        if not windows_s or any(w <= 0 for w in windows_s):
            raise ValueError(f"windows_s={windows_s} must be positive")
        self.name = str(name)
        self.latency_ms = float(latency_ms)
        self.target = float(target)
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.burn_alarm = float(burn_alarm)
        self.min_requests = int(min_requests)

    @classmethod
    def from_dict(cls, name: str, spec: dict) -> "Objective":
        """Build from the declarative config shape::

            {"latency_ms": 250, "target": 0.99,
             "windows_s": [60, 600], "burn_alarm": 2.0,
             "min_requests": 10}
        """
        known = {"latency_ms", "target", "windows_s", "burn_alarm",
                 "min_requests"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"objective {name!r}: unknown keys {sorted(unknown)} "
                f"(known: {sorted(known)})")
        if "latency_ms" not in spec:
            raise ValueError(f"objective {name!r} needs latency_ms")
        return cls(name, **spec)

    def to_dict(self) -> dict:
        return {"latency_ms": self.latency_ms, "target": self.target,
                "windows_s": list(self.windows_s),
                "burn_alarm": self.burn_alarm,
                "min_requests": self.min_requests}


class _ClassState:
    __slots__ = ("obj", "events", "total", "good", "alarm",
                 "alarm_transitions")

    def __init__(self, obj: Objective):
        self.obj = obj
        # (t_mono, good) per request, trimmed past the slowest window
        self.events: deque = deque()
        self.total = 0
        self.good = 0
        self.alarm = False
        self.alarm_transitions = 0


class SLOTracker:
    """Per-class SLO state machine over request outcomes.

    ``objectives``: either :class:`Objective` instances or a declarative
    dict ``{class_name: {objective spec}}``.  ``clock`` is injectable
    (monotonic seconds) so burn windows are testable without sleeping.
    Requests recorded under an undeclared class fall into
    ``default_class`` when set, else they are counted in
    ``unclassified`` and otherwise ignored — a typo'd class must not
    silently vanish, and must not crash the serve thread either.
    """

    def __init__(self, objectives, *, default_class: Optional[str] = None,
                 clock=time.monotonic):
        if isinstance(objectives, dict):
            objectives = [Objective.from_dict(name, dict(spec))
                          for name, spec in objectives.items()]
        if not objectives:
            raise ValueError("SLOTracker needs at least one Objective")
        self._clock = clock
        self._lock = threading.Lock()
        self._classes: Dict[str, _ClassState] = {
            o.name: _ClassState(o) for o in objectives}
        if default_class is not None and default_class not in self._classes:
            raise ValueError(f"default_class={default_class!r} is not a "
                             f"declared objective "
                             f"({sorted(self._classes)})")
        self.default_class = default_class
        self.unclassified = 0

    # ------------------------------------------------------------- record
    def record(self, qos_class: str, latency_s: float,
               error: bool = False) -> None:
        """One finished request: latency in seconds, ``error`` True for
        a failure (which is bad at any latency).  Thread-safe and
        hot-path cheap: one lock, one append, one trim."""
        event = None
        with self._lock:
            cs = self._classes.get(qos_class)
            if cs is None:
                if self.default_class is None:
                    self.unclassified += 1
                    return
                cs = self._classes[self.default_class]
            now = self._clock()
            good = (not error) and latency_s * 1e3 <= cs.obj.latency_ms
            cs.events.append((now, good))
            cs.total += 1
            cs.good += good
            self._trim(cs, now)
            alarm = self._alarm_locked(cs, now)
            if alarm != cs.alarm:
                cs.alarm = alarm
                cs.alarm_transitions += alarm  # count firings only
                event = {"qos_class": cs.obj.name,
                         "state": "firing" if alarm else "resolved",
                         "burn_rates": self._burn_rates_locked(cs, now),
                         "target": cs.obj.target,
                         "burn_alarm": cs.obj.burn_alarm}
        # sink emission outside the lock (the sink has its own)
        if event is not None:
            get_sink().emit("slo_alarm", **event)

    def _trim(self, cs: _ClassState, now: float) -> None:
        horizon = now - cs.obj.windows_s[-1]
        ev = cs.events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    # ------------------------------------------------------------ windows
    def _window_stats(self, cs: _ClassState,
                      now: float) -> List[Tuple[float, int, int]]:
        """[(window_s, total, good)] per configured window (events are
        time-ordered; one reverse scan covers all windows)."""
        stats = [[w, 0, 0] for w in cs.obj.windows_s]
        for t, good in reversed(cs.events):
            age = now - t
            live = False
            for s in stats:
                if age <= s[0]:
                    s[1] += 1
                    s[2] += good
                    live = True
            if not live:
                break       # older than every window
        return [tuple(s) for s in stats]

    def _burn_rates_locked(self, cs: _ClassState,
                           now: float) -> Dict[str, float]:
        budget = 1.0 - cs.obj.target
        out = {}
        for w, total, good in self._window_stats(cs, now):
            bad_frac = (total - good) / total if total else 0.0
            out[f"{w:g}s"] = round(bad_frac / budget, 4)
        return out

    def _alarm_locked(self, cs: _ClassState, now: float) -> bool:
        budget = 1.0 - cs.obj.target
        stats = self._window_stats(cs, now)
        if stats[0][1] < cs.obj.min_requests:
            return False
        for w, total, good in stats:
            bad_frac = (total - good) / total if total else 0.0
            if bad_frac / budget < cs.obj.burn_alarm:
                return False
        return True

    # ------------------------------------------------------------ readout
    def state(self) -> dict:
        """The ``/slo`` document: one JSON-ready dict an autoscaler or
        deploy gate polls.  ``status`` is "ok" unless any class's alarm
        is firing."""
        with self._lock:
            now = self._clock()
            classes = {}
            any_alarm = False
            for name, cs in self._classes.items():
                budget = 1.0 - cs.obj.target
                windows = {}
                for w, total, good in self._window_stats(cs, now):
                    bad_frac = ((total - good) / total) if total else 0.0
                    windows[f"{w:g}s"] = {
                        "requests": total,
                        "availability": (round(good / total, 6)
                                         if total else None),
                        "burn_rate": round(bad_frac / budget, 4),
                    }
                spent = (cs.total - cs.good) / max(cs.total * budget, 1e-12)
                any_alarm = any_alarm or cs.alarm
                classes[name] = {
                    "objective": cs.obj.to_dict(),
                    "requests_total": cs.total,
                    "good_total": cs.good,
                    "error_budget_remaining": round(
                        max(0.0, 1.0 - spent), 6) if cs.total else 1.0,
                    "windows": windows,
                    "alarm": cs.alarm,
                    "alarm_transitions": cs.alarm_transitions,
                }
            return {
                "status": "alarm" if any_alarm else "ok",
                "unclassified_requests": self.unclassified,
                "classes": classes,
            }

    # ---------------------------------------------------------- telemetry
    def register_into(self, registry) -> "SLOTracker":
        """Publish the consumable gauges on a shared ``obs.Registry``
        (weakref collector — the ServeMetrics discipline): burn rates
        per window, budget remaining, alarm level, good/total
        counters."""
        import weakref

        ref = weakref.ref(self)

        def _collect():
            t = ref()
            return t.collect() if t is not None else []

        registry.register_collector(_collect)
        return self

    def collect(self, prefix: str = "slo"):
        state = self.state()
        samples = [(f"{prefix}_unclassified_requests_total", {},
                    "counter", float(state["unclassified_requests"]))]
        for name, cls_state in state["classes"].items():
            labels = {"class": name}
            samples += [
                (f"{prefix}_requests_total", labels, "counter",
                 float(cls_state["requests_total"])),
                (f"{prefix}_good_total", labels, "counter",
                 float(cls_state["good_total"])),
                (f"{prefix}_error_budget_remaining", labels, "gauge",
                 float(cls_state["error_budget_remaining"])),
                (f"{prefix}_alarm", labels, "gauge",
                 1.0 if cls_state["alarm"] else 0.0),
                (f"{prefix}_alarm_transitions_total", labels, "counter",
                 float(cls_state["alarm_transitions"])),
            ]
            for w, win in cls_state["windows"].items():
                samples.append((f"{prefix}_burn_rate",
                                {**labels, "window": w}, "gauge",
                                float(win["burn_rate"])))
        return samples


def default_objectives() -> List[Objective]:
    """A reasonable starting declaration for the serve stack: an
    interactive class on a tight latency bound and a batch class on a
    loose one.  Deployments should declare their own numbers — these
    exist so ``SLOTracker(default_objectives())`` works out of the box
    in tools and tests."""
    return [
        Objective("interactive", latency_ms=250.0, target=0.99,
                  windows_s=(60.0, 600.0), burn_alarm=2.0),
        Objective("batch", latency_ms=2000.0, target=0.999,
                  windows_s=(300.0, 3600.0), burn_alarm=2.0),
    ]
