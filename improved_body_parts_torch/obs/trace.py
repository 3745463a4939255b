"""Lock-cheap span recorder with Chrome/Perfetto ``trace_event`` export
(the port's own copy of ``improved_body_parts_tpu/obs/trace.py``).

The event sink (``obs/events.py``) answers *what happened*; this module
answers *where the time went*: the serving engine records its request
lifecycle into one process-wide ring buffer, and the whole timeline
exports as Chrome ``trace_event`` JSON that loads directly in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``.

Design constraints, in order:

- **Hot-path cheap.** A span record is two ``time.monotonic()`` calls
  and one ``deque.append`` (atomic under the GIL — no lock on the record
  path; the only lock guards first-use track registration).  With
  tracing off every site hits :class:`NullTraceRecorder`, whose methods
  are empty — one attribute check.
- **Bounded memory.** The ring holds ``capacity`` events and evicts the
  oldest; the export stamps how many were dropped so a truncated
  timeline can never read as a complete one.
- **One clock.** Timestamps are seconds on the MONOTONIC clock relative
  to a shared ``t0`` (pass the event sink's ``t0`` so a span's ``ts``
  and an event's ``t`` are the same axis).  ``CLOCK_MONOTONIC`` is
  system-wide on Linux, so :meth:`TraceRecorder.add_span_abs` can place
  a stamp taken in another process among this one's spans.
- **Tracks, not threads.** Every span lands on a named track (default:
  the recording thread's name); tracks map to stable ``tid``s with
  ``thread_name`` metadata so Perfetto labels them.  Cross-thread
  request lifecycles (the dynamic batcher) use async begin/end pairs
  keyed by request id, plus flow arrows from each submit to the batch
  that executed it — batching fan-in is visible as N arrows converging
  on one ``execute`` slice.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTraceRecorder:
    """Tracing disabled: every record is a no-op (the default)."""

    enabled = False
    recorded = 0
    dropped = 0

    def now(self) -> float:
        return 0.0

    def span(self, name: str, track: Optional[str] = None,
             args: Optional[dict] = None) -> _NullSpan:
        return _NULL_SPAN

    def add_span_rel(self, name, ts, dur, track=None, args=None) -> None:
        pass

    def add_span_abs(self, name, t_mono, dur, track=None, args=None) -> None:
        pass

    def instant(self, name, track=None, args=None) -> None:
        pass

    def async_begin(self, name, id, cat="async", args=None) -> None:
        pass

    def async_end(self, name, id, cat="async", args=None) -> None:
        pass

    def flow_start(self, name, id, track=None, ts=None, cat="flow") -> None:
        pass

    def flow_step(self, name, id, track=None, ts=None, cat="flow") -> None:
        pass

    def flow_finish(self, name, id, track=None, ts=None, cat="flow") -> None:
        pass

    def attach_registry(self, registry) -> None:
        pass

    def events(self) -> List[dict]:
        return []

    def export(self) -> dict:
        return {"traceEvents": []}

    def save(self, path: str) -> None:
        pass


class _Span:
    """``with recorder.span("render"): ...`` — records one X event."""

    __slots__ = ("_rec", "_name", "_track", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str,
                 track: Optional[str], args: Optional[dict]):
        self._rec, self._name = rec, name
        self._track, self._args = track, args

    def __enter__(self) -> "_Span":
        self._t0 = self._rec.now()
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        rec.add_span_rel(self._name, self._t0, rec.now() - self._t0,
                         track=self._track, args=self._args)


class TraceRecorder:
    """Ring-buffered span recorder for one process.

    ``t0`` is an absolute ``time.monotonic()`` reading that anchors the
    timeline (pass the event sink's ``t0`` so spans and JSONL events
    share an axis); all recorded timestamps are seconds since it.
    """

    enabled = True

    # event tuple layout: (ph, cat, name, track, ts_s, dur_s, id, args)
    def __init__(self, capacity: int = 65536, t0: Optional[float] = None):
        self.capacity = int(capacity)
        self._t0 = float(t0) if t0 is not None else time.monotonic()
        self._events: deque = deque(maxlen=self.capacity)
        self._appended = 0      # monotonic count; appended - len = dropped
        self._track_lock = threading.Lock()
        self._tracks: Dict[str, int] = {}
        self._pid = os.getpid()

    # ------------------------------------------------------------ clock
    @property
    def t0(self) -> float:
        return self._t0

    def now(self) -> float:
        """Seconds since ``t0`` (monotonic)."""
        return time.monotonic() - self._t0

    # ----------------------------------------------------------- tracks
    def _tid(self, track: Optional[str]) -> int:
        name = track if track is not None else threading.current_thread().name
        tid = self._tracks.get(name)
        if tid is None:
            with self._track_lock:
                tid = self._tracks.setdefault(name, len(self._tracks) + 1)
        return tid

    # ---------------------------------------------------------- records
    def _put(self, ev) -> None:
        # deque.append is atomic under the GIL; the += is bookkeeping
        # only (approximate under a race, never load-bearing)
        self._events.append(ev)
        self._appended += 1

    def span(self, name: str, track: Optional[str] = None,
             args: Optional[dict] = None) -> _Span:
        return _Span(self, name, track, args)

    def add_span_rel(self, name: str, ts: float, dur: float,
                     track: Optional[str] = None,
                     args: Optional[dict] = None) -> None:
        """One complete span at ``ts`` seconds since ``t0`` (what
        :meth:`now` returns) lasting ``dur`` seconds."""
        self._put(("X", None, name, self._tid(track), ts, max(dur, 0.0),
                   None, args))

    def add_span_abs(self, name: str, t_mono: float, dur: float,
                     track: Optional[str] = None,
                     args: Optional[dict] = None) -> None:
        """One complete span whose start is an ABSOLUTE
        ``time.monotonic()`` reading — possibly taken in another
        process."""
        self.add_span_rel(name, t_mono - self._t0, dur, track=track,
                          args=args)

    def instant(self, name: str, track: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        self._put(("i", None, name, self._tid(track), self.now(), None,
                   None, args))

    def async_begin(self, name: str, id: int, cat: str = "async",
                    args: Optional[dict] = None) -> None:
        """Async span begin (Perfetto groups b/e pairs by cat+id onto
        their own track — overlapping lifetimes render side by side)."""
        self._put(("b", cat, name, self._tid(None), self.now(), None,
                   int(id), args))

    def async_end(self, name: str, id: int, cat: str = "async",
                  args: Optional[dict] = None) -> None:
        self._put(("e", cat, name, self._tid(None), self.now(), None,
                   int(id), args))

    def flow_start(self, name: str, id: int, track: Optional[str] = None,
                   ts: Optional[float] = None, cat: str = "flow") -> None:
        """Start a flow arrow (binds to the slice enclosing ``ts`` on the
        recording track).  ``cat`` namespaces the id: flows bind by
        (cat, id), so independent id counters (the batcher's rids, the
        reqtrace request ids) must not share one category."""
        self._put(("s", cat, name, self._tid(track),
                   self.now() if ts is None else ts, None, int(id), None))

    def flow_step(self, name: str, id: int, track: Optional[str] = None,
                  ts: Optional[float] = None, cat: str = "flow") -> None:
        """Intermediate flow point ("t" phase): the arrow threads
        through the slice enclosing ``ts`` — what makes a multi-hop
        request ONE followable arc across engine tracks."""
        self._put(("t", cat, name, self._tid(track),
                   self.now() if ts is None else ts, None, int(id), None))

    def flow_finish(self, name: str, id: int, track: Optional[str] = None,
                    ts: Optional[float] = None, cat: str = "flow") -> None:
        self._put(("f", cat, name, self._tid(track),
                   self.now() if ts is None else ts, None, int(id), None))

    def attach_registry(self, registry) -> None:
        """Expose the ring's drop accounting on a registry (duck-typed:
        any object with ``register_collector``, which the collector is
        handed by weak reference), so a consumer of the registry cannot
        mistake a truncated timeline for a complete one.
        ``trace_spans_dropped_total`` growing during a run is the live
        signal to raise ``capacity`` (or accept the loss knowingly)."""
        import weakref

        ref = weakref.ref(self)

        def _collect():
            t = ref()
            if t is None:
                return []
            return [
                ("trace_spans_dropped_total", {}, "counter",
                 float(t.dropped)),
                ("trace_spans_recorded", {}, "gauge", float(t.recorded)),
            ]

        registry.register_collector(_collect)

    # ----------------------------------------------------------- export
    @property
    def recorded(self) -> int:
        """Events currently in the ring (cheap — no serialization)."""
        return len(self._events)

    @property
    def dropped(self) -> int:
        return max(0, self._appended - len(self._events))

    def events(self) -> List[dict]:
        """The ring's events in Chrome ``trace_event`` dict form,
        parent-before-child ordered (ts ascending, longer span first on
        ties so nesting resolves)."""
        out = []
        for ph, cat, name, tid, ts, dur, id_, args in list(self._events):
            ev = {"name": name, "ph": ph, "ts": round(ts * 1e6, 3),
                  "pid": self._pid, "tid": tid}
            ev["cat"] = cat if cat is not None else "span"
            if dur is not None:
                ev["dur"] = round(dur * 1e6, 3)
            if id_ is not None:
                ev["id"] = id_
            if ph == "f":
                ev["bp"] = "e"  # bind the arrowhead to the enclosing slice
            if ph == "i":
                ev["s"] = "t"   # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        out.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return out

    def export(self) -> dict:
        """Chrome trace JSON object (loads in Perfetto / chrome://tracing)."""
        with self._track_lock:
            tracks = dict(self._tracks)
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "improved_body_parts_torch"}}]
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                         "tid": tid, "args": {"name": name}})
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            # t0_mono: the absolute CLOCK_MONOTONIC anchor — what lets
            # a consumer rebase another process's export onto this one's
            # axis ((t0_other - t0_this) µs shift)
            "otherData": {"dropped_events": self.dropped,
                          "capacity": self.capacity,
                          "t0_mono": self._t0},
        }

    def save(self, path: str) -> str:
        """Write the export to ``path``; returns the absolute path."""
        path = os.path.abspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from .events import strict_dump

        with open(path, "w") as f:
            # span args carry run floats — strict emission so a
            # non-finite value never makes the trace unloadable
            strict_dump(self.export(), f)
        return path


_tracer_lock = threading.Lock()
_tracer = NullTraceRecorder()


def get_tracer():
    """The process's current recorder (``NullTraceRecorder`` when no run
    installed one) — instrumentation sites record through this
    unconditionally."""
    return _tracer


def set_tracer(tracer):
    """Install ``tracer`` as the process default; returns the previous
    one so callers can restore it."""
    global _tracer
    with _tracer_lock:
        prev = _tracer
        _tracer = tracer if tracer is not None else NullTraceRecorder()
        return prev
