"""Telemetry of the port (its own copies of the JAX package's ``obs/``
modules, with torch counterparts where the JAX ones read XLA).

- :mod:`registry` — counters / gauges / percentile histograms / span
  timers with Prometheus + JSON exposition (``Registry``,
  ``get_registry``, ``StepPhases`` data-wait/compute attribution);
- :mod:`events`   — schema-versioned JSONL run-event sink (``EventSink``,
  ``read_events``, process-default ``set_sink`` / ``get_sink``) and the
  strict-JSON emitters (``strict_dumps``, ``strict_dump``);
- :mod:`trace`    — lock-cheap ring-buffered span recorder with
  Chrome/Perfetto ``trace_event`` export (``TraceRecorder``,
  process-default ``set_tracer`` / ``get_tracer``);
- :mod:`reqtrace` — request-scoped causal tracing with per-hop
  waterfalls (``ReqTrace``, ``NULL_NODE``, process-default
  ``set_reqtrace`` / ``get_reqtrace``);
- :mod:`http`     — background ``/metrics`` + ``/snapshot`` +
  ``/healthz`` + ``/slo`` + ``/fleet`` + ``/history`` + ``/query``
  endpoint (``MetricsServer``,
  ``ROUTES``);
- :mod:`recompile` — first runs of unwarmed lane shapes after warmup,
  the port's compile event (``CompileWatch``);
- :mod:`memory`   — the CUDA caching allocator's gauges, run watermark
  and OOM forensics for one device (``DeviceMemory``);
- :mod:`slo`      — declarative per-QoS-class latency/availability
  objectives, multi-window burn rate, error budgets and alarm events
  (``SLOTracker``, ``Objective``; served at ``/slo``);
- :mod:`fleet`    — cross-process fleet observability over the shm
  wire: worker-side telemetry publisher (``WorkerTelemetry``), the
  parent-side merge registry (``FleetRegistry``; served at ``/fleet``)
  and the crash flight recorder (``build_postmortem``,
  ``verify_postmortem``);
- :mod:`health`   — loss/grad-norm divergence sentinel with a
  ``warn|halt|skip_step`` policy (``HealthSentinel``,
  ``DivergenceError``; its state backs ``/healthz``);
- :mod:`history`  — bounded multi-resolution telemetry history with
  explicit gap accounting, strict-JSON shard persistence, offline
  replay and the derived control-plane signal feed (``HistoryStore``;
  served at ``/history`` + ``/query``; fitted into replica counts by
  ``serve.capacity.CapacityModel``);
- :mod:`run`      — the per-run bundle (``RunTelemetry``).
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
from .fleet import (
    TELEM_VERSION,
    FleetRegistry,
    WorkerTelemetry,
    build_postmortem,
    decode_telem,
    flow_id,
    read_block,
    read_flight_records,
    verify_postmortem,
)
from .health import POLICIES, DivergenceError, HealthSentinel
from .history import (
    HISTORY_SCHEMA,
    HistoryStore,
    discover_history_shards,
    history_path_for,
    series_key,
)
from .http import ROUTES, MetricsServer
from .memory import DeviceMemory
from .recompile import COMPILE_EVENT, CompileWatch
from .registry import (
    INPUT_BOUND_FRAC,
    Counter,
    Gauge,
    Histogram,
    Registry,
    StepPhases,
    get_registry,
)
from .reqtrace import (
    NULL_NODE,
    NullReqTrace,
    ReqTrace,
    get_reqtrace,
    set_reqtrace,
)
from .run import RunTelemetry, resolve_sink_path
from .slo import Objective, SLOTracker, default_objectives
from .trace import (
    NullTraceRecorder,
    TraceRecorder,
    get_tracer,
    set_tracer,
)

__all__ = [
    "COMPILE_EVENT", "HISTORY_SCHEMA", "INPUT_BOUND_FRAC", "NULL_NODE",
    "POLICIES", "ROUTES", "SCHEMA_VERSION", "TELEM_VERSION",
    "CompileWatch", "Counter", "DeviceMemory", "DivergenceError",
    "EventSink", "FleetRegistry", "Gauge", "HealthSentinel", "Histogram",
    "HistoryStore", "MetricsServer", "NullReqTrace", "NullSink",
    "NullTraceRecorder", "Objective", "Registry", "ReqTrace",
    "RunTelemetry", "SLOTracker", "StepPhases", "TraceRecorder",
    "WorkerTelemetry", "build_postmortem", "decode_telem",
    "default_objectives", "discover_history_shards", "flow_id",
    "get_registry", "get_reqtrace", "get_sink", "get_tracer",
    "history_path_for", "read_block", "read_events",
    "read_flight_records", "resolve_sink_path", "series_key",
    "set_reqtrace", "set_sink", "set_tracer", "strict_dump",
    "strict_dumps", "verify_postmortem",
]
