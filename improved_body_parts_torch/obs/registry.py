"""Process-wide telemetry registry: counters, gauges, percentile
histograms and low-overhead span timers with one exposition path (the
port's own copy of ``improved_body_parts_tpu/obs/registry.py``).

The reference instruments training with ad-hoc ``AverageMeter`` prints
around ``cuda.synchronize`` (reference: train_distributed.py:285-298);
every signal dies in stdout.  Here every layer — the train loop, the
host→device prefetch thread, the shm-ring input pipeline, the serving
engine — registers into one :class:`Registry`, which renders the whole
process's state two ways:

- :meth:`Registry.prometheus` — Prometheus text exposition 0.0.4 (the
  ``/metrics`` endpoint, ``obs.http.MetricsServer``);
- :meth:`Registry.snapshot` — one JSON-ready dict (``/snapshot``).

Metric objects are cheap to mutate on hot paths: a counter ``inc`` is a
lock + float add (~1 µs), histograms reuse ``utils.meters.PercentileMeter``
(bounded-memory reservoir, exact mean/count).  Sources whose state
already lives behind their own lock (``serve.metrics.ServeMetrics``)
plug in as *collectors* — callables sampled at scrape time — instead of
mirroring every mutation into a second object.
"""
from __future__ import annotations

import functools
import re
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from ..utils.meters import PercentileMeter

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# (name, labels, kind, value) — kind "counter"|"gauge"; collectors yield
# these and histogram quantiles are expanded into them at render time
Sample = Tuple[str, Dict[str, str], str, float]


@functools.lru_cache(maxsize=4096)
def _sanitize(name: str) -> str:
    """Prometheus metric-name charset; everything else becomes ``_``.
    Cached: metric names are a small fixed set, and scrape-time callers
    (``_flat``, the history sampler) hit this once per sample per tick."""
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (_sanitize(str(k)),
                     str(v).replace("\\", r"\\").replace('"', r'\"')
                     .replace("\n", r"\n"))
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


class Counter:
    """Monotonically increasing float (events, seconds-of)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value — settable, or computed at scrape time via
    ``fn`` (e.g. ring-slot occupancy read off the live free list)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._fn = fn
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a dead source reads as 0
                return 0.0
        return self._value


class Histogram:
    """Distribution with exact mean/count and reservoir-estimated tails
    (``PercentileMeter``); exposed as a Prometheus *summary* (quantile
    samples + ``_sum``/``_count``), since reservoir sampling estimates
    quantiles directly rather than fixed buckets."""

    kind = "histogram"
    QUANTILES = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 capacity: int = 4096, seed: int = 0):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._lock = threading.Lock()
        self._meter = PercentileMeter(capacity=capacity, seed=seed)

    def observe(self, v: float) -> None:
        with self._lock:
            self._meter.update(float(v))

    @property
    def count(self) -> int:
        return self._meter.count

    @property
    def sum(self) -> float:
        return self._meter.sum

    def summary(self, scale: float = 1.0) -> dict:
        with self._lock:
            return self._meter.summary(scale=scale)

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._meter.percentile(q)


class _Span:
    """``with registry.span("shard_batch"): ...`` — one perf_counter pair
    per entry, observed into a ``*_seconds`` histogram on exit."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


class Registry:
    """Named get-or-create store for metrics + scrape-time collectors.

    Creation is idempotent: ``counter("x")`` twice returns the same
    object (so instrumentation sites don't coordinate), and a name/kind
    clash raises instead of silently shadowing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    # ------------------------------------------------------ construction
    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kw):
        key = (cls.kind, _sanitize(name), _label_key(labels))
        with self._lock:
            m = self._metrics.get(key[1:])
            if m is None:
                m = cls(key[1], help, labels, **kw)
                self._metrics[key[1:]] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key[1]!r}{key[2]} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help, labels, fn=fn)
        if fn is not None:
            # rebind on every registration: a new source re-attaching
            # under the same name (a fresh ShmRingInput after the old
            # one closed) must supersede the dead closure, or the gauge
            # reads the dead source's 0 forever
            g._fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  capacity: int = 4096, seed: int = 0) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         capacity=capacity, seed=seed)

    def span(self, name: str,
             labels: Optional[Dict[str, str]] = None) -> _Span:
        """Span timer: times a ``with`` block into ``<name>_seconds``."""
        n = name if name.endswith("_seconds") else name + "_seconds"
        return _Span(self.histogram(n, labels=labels))

    def register_collector(self,
                           fn: Callable[[], Iterable[Sample]]) -> None:
        """Add a scrape-time sample source (a callable returning
        ``(name, labels, kind, value)`` tuples).  For subsystems whose
        counters already live behind their own lock (``ServeMetrics``)
        — sampled once per scrape, zero hot-path cost."""
        with self._lock:
            self._collectors.append(fn)

    # -------------------------------------------------------- exposition
    def _flat(self) -> Iterator[Tuple[str, Dict[str, str], str, float,
                                      str]]:
        """(name, labels, kind, value, help) for every sample, histograms
        expanded to quantile/sum/count samples."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            if isinstance(m, Histogram):
                s = m.summary()
                for q, key in Histogram.QUANTILES:
                    yield (m.name, {**m.labels, "quantile": str(q)},
                           "summary", s[key], m.help)
                yield (m.name + "_sum", dict(m.labels), "counter",
                       m.sum, m.help)
                yield (m.name + "_count", dict(m.labels), "counter",
                       float(s["count"]), m.help)
            else:
                yield (m.name, dict(m.labels), m.kind, m.value, m.help)
        for fn in collectors:
            try:
                for tup in fn():
                    # collectors yield (name, labels, kind, value) or,
                    # with help text, (name, labels, kind, value, help)
                    # — the fleet merge uses the 5-tuple form so worker
                    # families render HELP like first-class metrics
                    name, labels, kind, value = tup[:4]
                    help = tup[4] if len(tup) > 4 else ""
                    yield (_sanitize(name), dict(labels or {}), kind,
                           float(value), help)
            except Exception:  # noqa: BLE001 — one dead collector must
                continue       # not take down the whole exposition

    def iter_samples(self) -> Iterator[Tuple[str, Dict[str, str], str,
                                             float, str]]:
        """Public sample walk: ``(name, labels, kind, value, help)`` for
        every signal the registry would expose — histograms expanded to
        quantile/_sum/_count samples, collectors folded in.  The shared
        ingestion surface for consumers that are neither Prometheus nor
        JSON (``obs.history.HistoryStore`` samples it on a cadence)."""
        return self._flat()

    def prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        typed: set = set()
        for name, labels, kind, value, help in self._flat():
            # a summary's _sum/_count samples ride under the base
            # metric's family without TYPE lines of their own
            family = name
            for suffix in ("_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in typed:
                    family = None
                    break
            if family is not None and family not in typed:
                typed.add(family)
                if help:
                    lines.append(f"# HELP {family} {help}")
                lines.append(f"# TYPE {family} "
                             f"{'summary' if kind == 'summary' else kind}")
            lines.append(f"{name}{_render_labels(labels)} {float(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """One JSON-ready dict of every registered signal."""
        out: Dict[str, object] = {}
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            key = m.name + _render_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = m.summary()
            else:
                out[key] = m.value
        for fn in collectors:
            try:
                for tup in fn():
                    name, labels, _kind, value = tup[:4]
                    out[_sanitize(name) + _render_labels(labels or {})] = \
                        float(value)
            except Exception:  # noqa: BLE001
                continue
        return out


# the fraction of consumer wall time spent waiting on data above which a
# run is INPUT-BOUND — the one verdict threshold shared by every
# consumer of the StepPhases split (the JAX package's
# tools/telemetry_report.py and tools/trace_report.py read the same
# value), so two reports can never contradict each other about one run
INPUT_BOUND_FRAC = 0.4


class StepPhases:
    """Data-wait vs device-compute attribution for a consumer loop.

    Wraps a batch iterator (:meth:`attribute`): time the consumer blocks
    in ``next()`` is **data wait** (the input pipeline failed to stay
    ahead), time between a yield and the consumer's re-entry is
    **compute** (the training step holds the thread — under throttled
    readback this is device compute plus dispatch overhead, since the
    per-window ``float(loss)`` sync parks the thread until the device
    drains).  The two sum to the loop's wall time, which is what lets a
    report issue an input-bound vs compute-bound verdict
    (:data:`INPUT_BOUND_FRAC`) instead of a bare step time.
    """

    def __init__(self, registry: Registry, prefix: str = "train"):
        self.wait = registry.counter(
            f"{prefix}_data_wait_seconds_total",
            "time the consumer blocked waiting for the next batch")
        self.hold = registry.counter(
            f"{prefix}_compute_seconds_total",
            "time the consumer held the thread between batches "
            "(device step + dispatch + readback)")
        self.batches = registry.counter(f"{prefix}_batches_total",
                                        "batches consumed")
        # start of the hold segment currently in progress (the consumer
        # is between batches); consumer-thread-only
        self._open_t: Optional[float] = None

    def attribute(self, iterable: Iterable) -> Iterator:
        def gen():
            from .trace import get_tracer

            it = iter(iterable)
            while True:
                # the process tracer can be (re)installed mid-run; one
                # global read per batch keeps the split and the timeline
                # in lockstep without plumbing
                trace = get_tracer()
                tr0 = trace.now() if trace.enabled else 0.0
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self.wait.inc(time.perf_counter() - t0)
                    return
                t1 = time.perf_counter()
                self.wait.inc(t1 - t0)
                self.batches.inc()
                if trace.enabled:
                    tr1 = trace.now()
                    trace.add_span_rel("data_wait", tr0, tr1 - tr0)
                self._open_t = t1
                yield item
                self._open_t = None
                self.hold.inc(time.perf_counter() - t1)
                if trace.enabled:
                    trace.add_span_rel("compute", tr1, trace.now() - tr1)

        return gen()

    def totals(self) -> Tuple[float, float]:
        """(data_wait_seconds, compute_seconds) so far — callers diff
        consecutive readings for per-window splits.

        The in-progress hold segment is included: the train loop reads
        this right after a window's readback sync, i.e. from INSIDE the
        current batch's hold segment (the counter itself only advances
        when the consumer asks for the next batch).  Without the
        in-progress part, every window's sync — the bulk of realized
        device compute under async dispatch — would be attributed to
        the FOLLOWING window, and the epoch's last sync to none at all.
        """
        hold = self.hold.value
        open_t = self._open_t
        if open_t is not None:
            hold += time.perf_counter() - open_t
        return self.wait.value, hold


_DEFAULT = Registry()


def get_registry() -> Registry:
    """The process-wide registry (train, input pipeline and serving all
    default to it, so one ``/metrics`` endpoint exposes everything)."""
    return _DEFAULT
