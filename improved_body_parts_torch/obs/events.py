"""Structured JSONL run-event sink (the port's own copy of
``improved_body_parts_tpu/obs/events.py``).

One append-only file per run (re-running over the same path stacks
runs); every line is one JSON record:

- the first record is a ``run_start`` header carrying the schema
  version, wall-clock anchor, pid and caller-supplied run metadata;
- every record carries ``t`` — seconds since the sink opened, from the
  MONOTONIC clock, so event spacing survives NTP step adjustments;
- records are schema-versioned (``SCHEMA_VERSION``) so consumers can
  refuse streams from a future schema instead of misreading them.

Writes are line-buffered under a lock, so the stream is tail-able while
the run is live and safe to emit from the serving engine's threads
concurrently.  A process-wide default sink (:func:`set_sink` /
:func:`get_sink`) lets library code (``obs.reqtrace``) report through
the run's stream whenever a run installed one.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1


def _definan(o):
    """Map non-finite floats to their string names ('nan'/'inf'/'-inf'),
    recursively.  ``json.dumps`` would emit bare ``NaN``/``Infinity``
    tokens — not JSON — and the records most likely to carry them (a
    diverged loss) are exactly the ones a strict consumer (jq, Go, JS)
    must be able to parse."""
    if isinstance(o, float) and not math.isfinite(o):
        return repr(o)
    if isinstance(o, dict):
        return {k: _definan(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_definan(v) for v in o]
    return o


def _jsonable(o):
    """numpy scalars / arrays and anything else json chokes on."""
    try:
        import numpy as np

        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
    except Exception:  # noqa: BLE001
        pass
    try:
        return float(o)
    except Exception:  # noqa: BLE001
        return str(o)


def strict_dumps(obj, *, default=None, **kw) -> str:
    """``json.dumps`` that can never emit bare ``NaN``/``Infinity``
    tokens: first try strict (``allow_nan=False`` — the common all-finite
    record pays no scan), and on rejection re-serialize through
    :func:`_definan` so non-finite floats become their string names.

    This is the process-wide emission idiom: the sink and every
    artifact writer route through it, because the records most likely to carry a NaN — a diverged loss, an
    empty histogram's quantiles — are exactly the ones strict consumers
    (jq, Go, JS) must be able to parse.
    """
    d = default if default is not None else _jsonable
    try:
        return json.dumps(obj, default=d, allow_nan=False, **kw)
    except ValueError:  # non-finite float somewhere in the payload
        return json.dumps(_definan(obj), default=lambda o: _definan(d(o)),
                          allow_nan=True, **kw)


def strict_dump(obj, fp, *, default=None, **kw) -> None:
    """:func:`strict_dumps` for file targets (``json.dump`` call
    sites)."""
    fp.write(strict_dumps(obj, default=default, **kw))


class NullSink:
    """Telemetry disabled: every emit is a no-op (the default sink)."""

    enabled = False
    path: Optional[str] = None
    t0: Optional[float] = None

    def emit(self, event: str, **fields) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EventSink:
    """Append-only JSONL event stream for one run."""

    enabled = True

    def __init__(self, path: str, run_meta: Optional[Dict] = None):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)  # line-buffered text
        # public: the run's monotonic anchor — obs.trace.TraceRecorder
        # shares it so span ts and event t are the same axis
        self.t0 = time.monotonic()
        self._closed = False
        # public: what the header carried (run identity for consumers
        # that stamp their own records with it)
        self.run_meta = dict(run_meta or {})
        header = {"event": "run_start", "schema": SCHEMA_VERSION, "t": 0.0,
                  "time_unix": round(time.time(), 3), "pid": os.getpid()}
        header.update(self.run_meta)
        self._write(header)

    def _write(self, rec: dict) -> None:
        line = strict_dumps(rec, separators=(",", ":"))
        with self._lock:
            if not self._closed:
                self._f.write(line + "\n")

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event,
               "t": round(time.monotonic() - self.t0, 6)}
        rec.update(fields)
        self._write(rec)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._f.close()

    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_sink_lock = threading.Lock()
_sink = NullSink()


def get_sink():
    """The process's current default sink (``NullSink`` when no run
    installed one)."""
    return _sink


def set_sink(sink):
    """Install ``sink`` as the process default; returns the previous
    sink so callers can restore it."""
    global _sink
    with _sink_lock:
        prev = _sink
        _sink = sink if sink is not None else NullSink()
        return prev


def read_events(path: str) -> List[dict]:
    """Parse a JSONL event stream back into a list of records (blank
    lines skipped; a torn final line — the writer died mid-record — is
    dropped rather than raised)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
