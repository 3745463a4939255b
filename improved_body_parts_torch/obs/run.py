"""One run's telemetry bundle: registry + JSONL sink + compile watch +
span trace + device-memory accounting + run-health sentinel + optional
live metrics endpoint, assembled from the config knobs
(``TrainConfig.telemetry_sink`` / ``telemetry_port`` /
``telemetry_sample`` / ``telemetry_trace`` / ``on_divergence``) or
directly by the CLIs (the port's own copy of
``improved_body_parts_tpu/obs/run.py``).

::

    with RunTelemetry("events.jsonl", http_port=0,
                      trace_path="trace.json", device="cuda",
                      run_meta={"tool": "train"}) as tele:
        fit(state, step, cfg, make_batches, epochs, telemetry=tele)

``device`` is the device whose allocator :class:`obs.memory.DeviceMemory`
reads: the trainer's.  It defaults to the card; on the CPU
(``device="cpu"``) the memory sampler is the explicit zero sampler.

Installing the bundle also installs its sink as the process default
(``obs.events.set_sink``) so library helpers (``utils.profiling.timed``)
report through the run's stream instead of stdout, and its span recorder
as the process default tracer (``obs.trace.set_tracer``) so
instrumentation sites the bundle is never plumbed to — the shm-ring
consumer, the prefetch producer thread, the serving engine — land on the
same timeline; ``close()`` restores both, saves the trace (when a path
was configured) and emits a ``trace_export`` event pointing at it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from .events import EventSink, NullSink, set_sink
from .health import HealthSentinel
from .http import MetricsServer
from .memory import DeviceMemory
from .recompile import CompileWatch
from .registry import Registry, StepPhases, get_registry
from .reqtrace import NullReqTrace, ReqTrace, set_reqtrace
from .trace import NullTraceRecorder, TraceRecorder, set_tracer

# the span ring's length: the last 65536 spans of a run
TRACE_CAPACITY = 65536


class RunTelemetry:
    def __init__(self, sink_path: Optional[str] = None,
                 http_port: Optional[int] = None,
                 registry: Optional[Registry] = None,
                 run_meta: Optional[Dict] = None,
                 step_sample: int = 1,
                 watch_compiles: bool = True,
                 trace_path: Optional[str] = None,
                 on_divergence: str = "warn",
                 grad_norm_limit: float = 0.0,
                 history=None,
                 device="cuda"):
        from .. import resolve_device

        # resolved before anything is installed: asked for the card on a
        # host without one, the bundle raises and leaves no default behind
        device = resolve_device(device)
        self.registry = registry if registry is not None else get_registry()
        self.sink = (EventSink(sink_path, run_meta=run_meta)
                     if sink_path else NullSink())
        self._prev_sink = None
        self._installed_sink = False
        if self.sink.enabled:
            self._prev_sink = set_sink(self.sink)
            self._installed_sink = True
        self.compile_watch = CompileWatch(self.registry, self.sink)
        if watch_compiles:
            self.compile_watch.install()
        # span recorder: on when a trace path was configured or whenever
        # the sink is — an in-memory ring is cheap and keeps the overhead
        # A/B honest about what a real run pays
        self.trace = (TraceRecorder(capacity=TRACE_CAPACITY,
                                    t0=self.sink.t0)
                      if trace_path or self.sink.enabled
                      else NullTraceRecorder())
        self.trace_path = trace_path
        self._prev_tracer = None
        self._installed_tracer = False
        if self.trace.enabled:
            self._prev_tracer = set_tracer(self.trace)
            self._installed_tracer = True
            # satellite: a lossy ring must be visible on /metrics, not
            # only as a stamp buried in the export
            self.trace.attach_registry(self.registry)
        # request-scoped causal tracing (obs.reqtrace): on whenever the
        # sink is (records emit through it), every request sampled
        self.reqtrace = (ReqTrace(sample=1, t0=self.sink.t0)
                         if self.sink.enabled else NullReqTrace())
        self._prev_reqtrace = None
        self._installed_reqtrace = False
        if self.reqtrace.enabled:
            self._prev_reqtrace = set_reqtrace(self.reqtrace)
            self._installed_reqtrace = True
            self.reqtrace.attach_registry(self.registry)
        # optional telemetry-history store (obs.history): its sampler
        # runs for the life of the bundle, its meta-signals join the
        # registry, and the endpoint serves it at /history + /query;
        # close() stops the sampler and flushes its shards
        self.history = history
        if history is not None:
            history.register_into(self.registry)
            history.start()
        # device-memory accounting of the caller's device (an explicit
        # zero sampler on the CPU)
        self.memory = DeviceMemory(self.registry, self.sink, device=device)
        # run-health sentinel; its state backs the endpoint's /healthz
        self.health = HealthSentinel(self.registry, self.sink,
                                     policy=on_divergence,
                                     grad_norm_limit=grad_norm_limit)
        # emit every Nth per-print_freq step record (cheap runs keep 1;
        # multi-week runs can thin the stream without losing the split,
        # which accumulates in counters regardless)
        self.step_sample = max(1, int(step_sample))
        self.server = (MetricsServer(self.registry, port=http_port,
                                     extra=self._server_extra,
                                     health=self.health.state,
                                     history=history)
                       if http_port is not None and http_port >= 0 else None)
        self._phases: Dict[str, StepPhases] = {}
        self._closed = False

    def _server_extra(self) -> dict:
        return {"events": self.sink.path, "trace": self.trace_path,
                "health": self.health.state()}

    # ----------------------------------------------------------- accessors
    def phases(self, prefix: str = "train") -> StepPhases:
        """Get-or-create the data-wait/compute attribution counters for
        one consumer loop (train and eval keep separate prefixes)."""
        p = self._phases.get(prefix)
        if p is None:
            p = self._phases[prefix] = StepPhases(self.registry, prefix)
        return p

    def emit(self, event: str, **fields) -> None:
        self.sink.emit(event, **fields)

    def mark_warm(self, label: str = "") -> None:
        self.compile_watch.mark_warm(label)

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.server is not None:
            self.server.close()
        if self.history is not None:
            self.history.close()
        self.compile_watch.uninstall()
        if self.trace.enabled and self.trace_path:
            # count via the ring's length — events() would serialize the
            # whole ring a second time just to be len()'d
            n = self.trace.recorded
            path = self.trace.save(self.trace_path)
            self.sink.emit("trace_export", path=path, events=n,
                           dropped=self.trace.dropped)
        if self._installed_reqtrace:
            set_reqtrace(self._prev_reqtrace)
        if self._installed_tracer:
            set_tracer(self._prev_tracer)
        if self._installed_sink:
            set_sink(self._prev_sink)
        self.sink.close()

    def __enter__(self) -> "RunTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_sink_path(configured: str, checkpoint_dir: str,
                      default_name: str = "events.jsonl"
                      ) -> Optional[str]:
    """Map a ``TrainConfig.telemetry_sink`` / ``telemetry_trace`` value
    to a concrete path: ``""`` → disabled (None), ``"auto"`` →
    ``<checkpoint_dir>/<default_name>``, anything else is the path
    itself."""
    if not configured:
        return None
    if configured == "auto":
        return os.path.join(checkpoint_dir, default_name)
    return configured
