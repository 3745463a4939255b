"""Telemetry of the port: the pieces the serving engine records through.

- :mod:`events`   — schema-versioned JSONL run-event sink (``EventSink``,
  ``read_events``, process-default ``set_sink`` / ``get_sink``) and the
  strict-JSON emitters (``strict_dumps``, ``strict_dump``);
- :mod:`trace`    — lock-cheap ring-buffered span recorder with
  Chrome/Perfetto ``trace_event`` export (``TraceRecorder``,
  process-default ``set_tracer`` / ``get_tracer``);
- :mod:`reqtrace` — request-scoped causal tracing with per-hop
  waterfalls (``ReqTrace``, ``NULL_NODE``, process-default
  ``set_reqtrace`` / ``get_reqtrace``).

Copies of the JAX package's modules of the same names.  Its registry,
SLO tracker, fleet plane, history store and HTTP endpoint are not ported
yet (ROADMAP.md, Queue 1: telemetry); the serving engine takes a
registry or an SLO tracker duck-typed.
"""
from .events import (
    SCHEMA_VERSION,
    EventSink,
    NullSink,
    get_sink,
    read_events,
    set_sink,
    strict_dump,
    strict_dumps,
)
from .reqtrace import (
    NULL_NODE,
    NullReqTrace,
    ReqTrace,
    get_reqtrace,
    set_reqtrace,
)
from .trace import (
    NullTraceRecorder,
    TraceRecorder,
    get_tracer,
    set_tracer,
)

__all__ = [
    "NULL_NODE", "SCHEMA_VERSION", "EventSink", "NullReqTrace", "NullSink",
    "NullTraceRecorder", "ReqTrace", "TraceRecorder", "get_reqtrace",
    "get_sink", "get_tracer", "read_events", "set_reqtrace", "set_sink",
    "set_tracer", "strict_dump", "strict_dumps",
]
