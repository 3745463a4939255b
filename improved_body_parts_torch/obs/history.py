"""Bounded in-process telemetry history: every point-in-time signal the
registry exposes, kept over time — with derived load signals a control
loop can actually consume (the port's own copy of
``improved_body_parts_tpu/obs/history.py``; its shards and the JAX
package's replay in each other bit for bit).

The registry, ``/slo`` and the fleet scrape answer *what is p99 / queue
depth right now*; nothing in the process can answer *what was it a
minute ago* or *which way is it trending*, and ROADMAP item 1's
autoscaler needs exactly those. :class:`HistoryStore` closes the gap:

- a fixed-cadence sampler thread snapshots ``Registry.iter_samples()``
  (which already folds in every collector — ``ServeMetrics``, the pool,
  the ``FleetRegistry`` merged view, SLO burn rates) into one
  per-series time series per sample family;
- **multi-resolution retention in bounded memory**: each series keeps a
  raw ring (default 1024 points ≈ 4.3 min at the 0.25 s cadence) plus
  min/max/sum/count/last aggregate rings at 5 s (720 buckets ≈ 1 h) and
  60 s (1440 buckets ≈ 24 h) — hours of history, O(series · capacity)
  memory, no allocation growth over a multi-day run;
- **gaps are marked, never interpolated**: a sampler stall (GIL
  convoy, suspended process, stopped thread) shows up as an explicit
  gap record — a controller reading a rate across a blackout must see
  the blackout, not a fabricated straight line;
- **strict-JSON shard persistence** following the ``*_events.jsonl`` /
  ``.pN`` precedent (header record, self-describing series
  declarations, one record per tick, ``shard_records`` ticks per file);
- :meth:`HistoryStore.replay` reconstructs the store — folds, gaps and
  every derived signal — **bit-identically** from committed shards, so
  a control law is regression-testable against recorded traffic with no
  fleet running.  Three properties make that exact rather than
  approximate: sample times are rounded to 1 µs *at ingestion* (live
  and replay fold the same float), values round-trip exactly through
  JSON (``repr`` shortest-round-trip floats), and live sampling and
  replay share one fold path (``_ingest``), including gap detection.

Derived-signals API (:meth:`rate`, :meth:`trend`,
:meth:`window_quantiles`, :meth:`burn_rate`, :meth:`signals`): the
inputs ROADMAP item 1 names — queue depth, admitted-depth, per-hop p99,
``hop_conservation_frac``, burn rate — plus rates and slopes over any
counter.  All default ``now`` to the **last sample time**, not the wall
clock: a sampled store's "now" is its newest tick, and it is what keeps
live-computed and replayed signal values identical.

Served at ``/history`` (store document) and ``/query`` (one series over
time, ``?series=&since=&step=``) by ``obs.http.MetricsServer``;
``serve.capacity.CapacityModel`` fits replica capacity from it.
"""
from __future__ import annotations

import collections
import glob
import math
import os
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .events import read_events, strict_dumps
from .registry import Registry, _render_labels, _sanitize

HISTORY_SCHEMA = 1

#: (bucket_width_s, ring_capacity) per downsampling level, coarsest
#: last: 5 s buckets for 1 h, 1 min buckets for 24 h.
DEFAULT_LEVELS: Tuple[Tuple[float, int], ...] = ((5.0, 720), (60.0, 1440))

#: hard cap on points/buckets per ``query()`` response — the /query
#: route must stay bounded no matter what retention the store carries
QUERY_LIMIT = 2000


def history_path_for(events_path: str) -> str:
    """The conventional history-shard path next to a run's event stream:
    ``events.jsonl`` → ``events_history.jsonl`` (rotated shards append
    ``.p1``, ``.p2``, … — the same suffix scheme as worker sinks, so
    one glob discovers both the same way)."""
    base, ext = os.path.splitext(events_path)
    return base + "_history" + (ext or ".jsonl")


def discover_history_shards(path: str) -> List[str]:
    """``[path, path.p1, path.p2, …]`` — every shard of one history
    stream in write order (numeric suffix sort, not lexical: ``.p10``
    after ``.p9``).  Mirrors the worker-sink discovery contract."""
    out: List[str] = []
    if os.path.exists(path):
        out.append(path)
    extra: List[Tuple[int, str]] = []
    for p in glob.glob(glob.escape(path) + ".p*"):
        suffix = p[len(path) + 2:]
        if suffix.isdigit():
            extra.append((int(suffix), p))
    out.extend(p for _, p in sorted(extra))
    return out


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """The store's series identity: the registry's snapshot key format,
    ``name{label="v",…}`` with sorted labels — so a /snapshot reader and
    a history reader name the same signal the same way."""
    return _sanitize(name) + _render_labels(dict(labels or {}))


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted sequence,
    ``q`` in [0, 100] — the exact math of
    ``utils.meters.PercentileMeter.percentile``, so a window quantile
    and a reservoir quantile over the same points agree."""
    if not sorted_vals:
        return 0.0
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return (sorted_vals[lo]
            + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo))


class _SeriesLevel:
    """One downsampling resolution of one series: a ring of finalized
    (t0, min, max, sum, count, last) buckets plus the open bucket.
    Folding is driven purely by the (t, v) stream — no clock reads — so
    replaying the same ticks rebuilds the same buckets bit-for-bit."""

    __slots__ = ("width", "buckets", "_idx", "_min", "_max", "_sum",
                 "_count", "_last")

    def __init__(self, width: float, capacity: int):
        self.width = float(width)
        self.buckets: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._idx: Optional[int] = None

    def add(self, t: float, v: float) -> None:
        idx = int(t // self.width)
        if idx == self._idx:
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._sum += v
            self._count += 1
            self._last = v
            return
        if self._idx is not None:
            self.buckets.append(self._freeze())
        self._idx = idx
        self._min = self._max = self._sum = self._last = v
        self._count = 1

    def _freeze(self) -> Tuple[float, float, float, float, int, float]:
        return (self._idx * self.width, self._min, self._max, self._sum,
                self._count, self._last)

    def snapshot(self) -> List[Tuple[float, float, float, float, int,
                                     float]]:
        """Finalized buckets plus the open one (a query must see the
        current partial bucket, or the freshest ``width`` seconds of
        history would read as missing)."""
        out = list(self.buckets)
        if self._idx is not None:
            out.append(self._freeze())
        return out


class _Series:
    """One sample family over time: raw ring + every aggregate level."""

    __slots__ = ("key", "name", "labels", "kind", "raw", "levels")

    def __init__(self, key: str, name: str, labels: Dict[str, str],
                 kind: str, raw_capacity: int,
                 level_spec: Sequence[Tuple[float, int]]):
        self.key = key
        self.name = name
        self.labels = dict(labels)
        self.kind = kind
        self.raw: collections.deque = collections.deque(
            maxlen=int(raw_capacity))
        self.levels = [_SeriesLevel(w, c) for w, c in level_spec]

    def add(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        for lv in self.levels:
            lv.add(t, v)


class HistoryStore:
    """Bounded multi-resolution time-series store over a telemetry
    registry (see the module docstring for the full design).

    ``registry=None`` builds a source-less store — what :meth:`replay`
    uses, and what a test feeds directly through :meth:`sample_now`
    sources.  An :class:`obs.slo.SLOTracker`'s burn-rate series arrive
    through the registry it is registered into.  ``clock`` is injectable for tests; production leaves it on the
    monotonic clock, the same axis as the event sink's ``t``.
    """

    def __init__(self, registry: Optional[Registry] = None, *,
                 cadence_s: float = 0.25, raw_capacity: int = 1024,
                 levels: Sequence[Tuple[float, int]] = DEFAULT_LEVELS,
                 max_series: int = 512,
                 persist_path: Optional[str] = None,
                 shard_records: int = 4096,
                 run_id: Optional[str] = None,
                 sources: Optional[Iterable[Callable[[], Iterable]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 gap_factor: float = 2.5):
        if cadence_s <= 0:
            raise ValueError(f"cadence_s must be > 0, got {cadence_s}")
        self.cadence_s = float(cadence_s)
        self.raw_capacity = int(raw_capacity)
        self.levels = tuple((float(w), int(c)) for w, c in levels)
        self.max_series = int(max_series)
        self.shard_records = int(shard_records)
        self.run_id = run_id
        self.gap_factor = float(gap_factor)
        self._clock = clock
        self._registry = registry
        self._sources: List[Callable[[], Iterable]] = list(sources or [])
        # reentrant: signals() composes rate()/latest() under one
        # consistent view without handing the lock back between them
        self._lock = threading.RLock()
        self._series: Dict[str, _Series] = {}
        self._last_t: Optional[float] = None
        self._samples = 0
        self._sample_errors = 0
        self._gaps: collections.deque = collections.deque(maxlen=256)
        self._gap_count = 0
        self._dropped_keys: set = set()
        self._dropped_overflow = 0
        # (name, sorted-label-items) → (key, sanitized name, labels):
        # key rendering is regex work and the identity never changes, so
        # paying it once per series instead of once per series per tick
        # is most of the sampler's steady-state cost; bounded like the
        # series map so a label explosion cannot grow it without limit
        self._key_memo: Dict[Tuple, Tuple[str, str, Dict[str, str]]] = {}
        # ------------------------------------------------- persistence
        self._base = persist_path
        self._f = None
        self._shard = 0
        self._shard_ticks = 0
        self._persist_records = 0
        if persist_path:
            self._open_shard()
        # ---------------------------------------------------- sampler
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # ------------------------------------------------------- persistence
    def _shard_path(self, shard: int) -> str:
        return self._base if shard == 0 else f"{self._base}.p{shard}"

    def _write_line(self, rec: dict) -> None:
        self._f.write(strict_dumps(rec, separators=(",", ":")) + "\n")
        self._persist_records += 1

    def _open_shard(self) -> None:
        path = self._shard_path(self._shard)
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered text
        self._write_line({
            "event": "history_start", "schema": HISTORY_SCHEMA,
            "time_unix": round(time.time(), 3), "pid": os.getpid(),
            "run_id": self.run_id, "cadence_s": self.cadence_s,
            "gap_factor": self.gap_factor,
            "raw_capacity": self.raw_capacity,
            "levels": [list(lv) for lv in self.levels],
            "max_series": self.max_series, "shard": self._shard})
        # re-declare every live series: each shard is self-describing
        # (the report tool can summarize one shard without its siblings)
        for s in self._series.values():
            self._write_line({"event": "history_series", "key": s.key,
                              "name": s.name, "labels": s.labels,
                              "kind": s.kind})
        self._shard_ticks = 0

    def _rotate_if_full(self) -> None:
        if self._f is not None and self._shard_ticks >= self.shard_records:
            self._f.close()
            self._shard += 1
            self._open_shard()

    # --------------------------------------------------------- ingestion
    def sample_now(self, t: Optional[float] = None) -> float:
        """Take one sample tick: gather every source's current samples,
        fold them in, persist the tick.  Returns the (rounded) tick
        time.  Thread-safe against every reader and against itself —
        gathering runs outside the store lock (a registry scrape in a
        collector must never wait on a history query)."""
        t = round(float(self._clock() if t is None else t), 6)
        items: Dict[str, Tuple[str, Dict[str, str], str, float]] = {}
        sources: List[Callable[[], Iterable]] = []
        if self._registry is not None:
            sources.append(self._registry.iter_samples)
        sources.extend(self._sources)
        memo = self._key_memo
        for src in sources:
            try:
                for tup in src():
                    name, labels, kind, value = tup[:4]
                    mk = (name, tuple(sorted(labels.items()))
                          if labels else ())
                    ent = memo.get(mk)
                    if ent is None:
                        labels = dict(labels or {})
                        ent = (series_key(name, labels),
                               _sanitize(name), labels)
                        if len(memo) < 8192:
                            memo[mk] = ent
                    items[ent[0]] = (ent[1], ent[2], kind, float(value))
            except Exception:  # noqa: BLE001 — one dead source must not
                with self._lock:  # kill the whole tick
                    self._sample_errors += 1
        with self._lock:
            self._ingest(t, items, persist=True)
        return t

    def _ingest(self, t: float,
                items: Dict[str, Tuple[str, Dict[str, str], str, float]],
                persist: bool) -> None:
        """Fold one tick — THE shared path between live sampling and
        :meth:`replay`, which is what makes replay bit-identical.
        Caller holds the lock; ``t`` is already µs-rounded."""
        if persist:
            self._rotate_if_full()
        if self._last_t is not None:
            dt = t - self._last_t
            if dt > self.gap_factor * self.cadence_s:
                gap = {"t_prev": self._last_t, "t": t,
                       "missed": max(1, int(dt / self.cadence_s) - 1)}
                self._gaps.append(gap)
                self._gap_count += 1
                if persist and self._f is not None:
                    self._write_line({"event": "history_gap", **gap})
        self._last_t = t
        vrec: Dict[str, float] = {}
        for key, (name, labels, kind, value) in items.items():
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    # bounded by design: a label-cardinality explosion
                    # drops NEW series (loudly, via the counter), never
                    # grows without limit
                    if len(self._dropped_keys) < 4096:
                        self._dropped_keys.add(key)
                    else:
                        self._dropped_overflow += 1
                    continue
                s = self._series[key] = _Series(
                    key, name, labels, kind, self.raw_capacity,
                    self.levels)
                if persist and self._f is not None:
                    self._write_line({"event": "history_series",
                                      "key": key, "name": name,
                                      "labels": labels, "kind": kind})
            s.add(t, value)
            vrec[key] = value
        self._samples += 1
        if persist and self._f is not None:
            self._write_line({"event": "history_sample", "t": t,
                              "v": vrec})
            self._shard_ticks += 1

    # ----------------------------------------------------------- sampler
    def start(self) -> "HistoryStore":
        """Start the fixed-cadence sampler thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="obs-history-sampler", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_evt.wait(self.cadence_s):
            try:
                self.sample_now()
            except Exception:  # noqa: BLE001 — a sampler bug must stall
                with self._lock:  # history, never kill the thread
                    self._sample_errors += 1

    def stop(self) -> None:
        """Stop the sampler thread (joined); the store stays queryable
        and :meth:`sample_now` still works (the audit's quiescent
        conservation check depends on exactly that)."""
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop_evt.set()
            thread.join(timeout=5.0)

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        self.stop()
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "HistoryStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- exposition
    def register_into(self, registry: Registry) -> "HistoryStore":
        """Export the store's own meta-signals through the registry —
        which the store then samples, so history is self-describing
        (gap/drop counters have history too).  Weakref collector, per
        the ServeMetrics/SLO/fleet precedent."""
        ref = weakref.ref(self)

        def _collect():
            st = ref()
            if st is None:
                return []
            with st._lock:
                return [
                    ("history_samples_total", {}, "counter",
                     float(st._samples), "history sample ticks taken"),
                    ("history_gaps_total", {}, "counter",
                     float(st._gap_count),
                     "sampler gaps detected (never interpolated)"),
                    ("history_series", {}, "gauge",
                     float(len(st._series)), "live series tracked"),
                    ("history_series_dropped_total", {}, "counter",
                     float(len(st._dropped_keys) + st._dropped_overflow),
                     "new series dropped at the max_series bound"),
                    ("history_sample_errors_total", {}, "counter",
                     float(st._sample_errors),
                     "sample ticks that raised (source or sampler bug)"),
                    ("history_persist_records_total", {}, "counter",
                     float(st._persist_records),
                     "records written across all shards"),
                    ("history_persist_shards", {}, "gauge",
                     float(st._shard + 1 if st._base else 0),
                     "shard files opened so far"),
                ]

        registry.register_collector(_collect)
        return self

    # ---------------------------------------------------------- readers
    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, key: str) -> Optional[Tuple[float, float]]:
        """Newest ``(t, value)`` of one series, or None."""
        with self._lock:
            s = self._series.get(key)
            if s is None or not s.raw:
                return None
            return s.raw[-1]

    def _now(self, now: Optional[float]) -> Optional[float]:
        """Derived signals default "now" to the last sample tick — the
        sampled store's notion of the present, and the anchor that makes
        live and replayed derived values identical."""
        return self._last_t if now is None else now

    def _points(self, key: str, t_lo: float, t_hi: float
                ) -> List[Tuple[float, float]]:
        s = self._series.get(key)
        if s is None:
            return []
        return [(t, v) for t, v in s.raw if t_lo <= t <= t_hi]

    def rate_series(self, key: str
                    ) -> List[Tuple[float, float, float, bool]]:
        """Per-interval rates over the raw ring: ``(t, dt, rate,
        gap)`` for each consecutive sample pair, rate assigned at the
        interval's END.  ``gap`` marks intervals wider than the gap
        threshold — a consumer integrating across one knows it is
        bridging a blackout.  ``Σ rate·dt`` telescopes back to
        ``v_last − v_first`` (the audit's integral-conservation gate)."""
        with self._lock:
            s = self._series.get(key)
            raw = list(s.raw) if s is not None else []
        out: List[Tuple[float, float, float, bool]] = []
        thresh = self.gap_factor * self.cadence_s
        for (t0, v0), (t1, v1) in zip(raw, raw[1:]):
            dt = t1 - t0
            if dt <= 0:
                continue
            out.append((t1, dt, (v1 - v0) / dt, dt > thresh))
        return out

    def integrate_rate(self, key: str) -> float:
        """``Σ rate·dt`` over the raw ring (fsum — no accumulation
        drift); equals the counter delta across the ring by
        construction, which is what the audit asserts."""
        return math.fsum(r * dt for _, dt, r, _ in self.rate_series(key))

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Average rate of change over the trailing window (units/s):
        ``(v_last − v_first) / (t_last − t_first)`` over the raw points
        in ``[now − window_s, now]``.  None with < 2 points — an
        unknown rate is not a zero rate."""
        with self._lock:
            now = self._now(now)
            if now is None:
                return None
            pts = self._points(key, now - window_s, now)
            if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
                return None
            return ((pts[-1][1] - pts[0][1])
                    / (pts[-1][0] - pts[0][0]))

    def trend(self, key: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Least-squares slope (units/s) over the trailing window — the
        "which way is it going" signal for gauges, where :meth:`rate`'s
        endpoint difference would be hostage to two noisy samples."""
        with self._lock:
            now = self._now(now)
            if now is None:
                return None
            pts = self._points(key, now - window_s, now)
        if len(pts) < 2:
            return None
        tm = math.fsum(t for t, _ in pts) / len(pts)
        vm = math.fsum(v for _, v in pts) / len(pts)
        den = math.fsum((t - tm) * (t - tm) for t, _ in pts)
        if den <= 0:
            return None
        num = math.fsum((t - tm) * (v - vm) for t, v in pts)
        return num / den

    def window_quantiles(self, key: str, window_s: float,
                         qs: Sequence[float] = (50.0, 95.0, 99.0),
                         now: Optional[float] = None
                         ) -> Optional[Dict[str, float]]:
        """Exact quantiles of the raw samples in the trailing window
        (same interpolation as ``PercentileMeter``), keyed ``p50`` /
        ``p95`` / ``p99`` / ``p99.9``-style.  None with no points."""
        with self._lock:
            now = self._now(now)
            if now is None:
                return None
            pts = self._points(key, now - window_s, now)
        if not pts:
            return None
        vals = sorted(v for _, v in pts)
        return {"p%g" % q: _percentile(vals, q) for q in qs}

    def burn_rate(self, qos_class: str, window: str = "5m",
                  now: Optional[float] = None) -> Optional[float]:
        """Latest SLO burn rate for one class/window from the bridged
        ``slo_burn_rate{class=,window=}`` series (None when the tracker
        never reported it)."""
        key = series_key("slo_burn_rate",
                         {"class": qos_class, "window": window})
        with self._lock:
            now = self._now(now)
            if now is None:
                return None
            return self._value_at(key, now)

    def _value_at(self, key: str, now: float) -> Optional[float]:
        """Newest value at or before ``now`` (lock held)."""
        s = self._series.get(key)
        if s is None:
            return None
        for t, v in reversed(s.raw):
            if t <= now:
                return v
        return None

    def _scan(self, name: str) -> List[_Series]:
        return [s for s in self._series.values() if s.name == name]

    def _scan_suffix(self, suffix: str) -> List[_Series]:
        """Series whose family name ends with ``suffix`` — the serving
        stack exports one family set under layer prefixes (``serve_``
        for a batcher, ``pool_`` / ``pool_engine_`` for the replicated
        tiers), and the control-plane signals must not care which layer
        is deployed."""
        return [s for s in self._series.values()
                if s.name.endswith(suffix)]

    def signals(self, now: Optional[float] = None,
                rate_window_s: float = 10.0) -> dict:
        """The control-plane feed: exactly the autoscaler inputs ROADMAP
        item 1 names, derived from history at one consistent instant.
        Absent signals are None — a controller must know "not measured"
        from "zero".  Multi-model deployments sum depths and take the
        worst (max) per-hop p99 / worst (min) conservation across
        models: capacity decisions key off the binding constraint."""
        with self._lock:
            now = self._now(now)
            if now is None:
                return {"t": None}

            def _sum_over(name):
                vals = [self._value_at(s.key, now)
                        for s in self._scan(name)]
                vals = [v for v in vals if v is not None]
                return math.fsum(vals) if vals else None

            hop_p99: Dict[str, float] = {}
            for s in self._scan_suffix("_hop_latency_seconds"):
                if s.labels.get("quantile") != "0.99":
                    continue
                v = self._value_at(s.key, now)
                if v is None:
                    continue
                hop = s.labels.get("hop", "")
                if hop not in hop_p99 or v > hop_p99[hop]:
                    hop_p99[hop] = v
            cons = [self._value_at(s.key, now)
                    for s in self._scan_suffix("_hop_conservation_frac")]
            cons = [v for v in cons if v is not None]
            burn: Dict[str, Dict[str, float]] = {}
            for s in self._scan("slo_burn_rate"):
                v = self._value_at(s.key, now)
                if v is None:
                    continue
                cls = s.labels.get("class", "")
                burn.setdefault(cls, {})[s.labels.get("window", "")] = v
            # one family, many layer prefixes: count each request once
            # by preferring the engine-facing family and falling back a
            # tier only when it is absent (pool_engine_* and pool_*
            # describe the SAME traffic — summing both would double it)
            comp = (self._scan("serve_completed_total")
                    or self._scan("pool_completed_total"))
            rates = [self.rate(s.key, rate_window_s, now=now)
                     for s in comp]
            rates = [r for r in rates if r is not None]
            return {
                "t": now,
                "queue_depth": (_sum_over("serve_queue_depth")
                                if self._scan("serve_queue_depth")
                                else _sum_over("pool_engine_queue_depth")),
                "admitted_depth": _sum_over("pool_queue_depth"),
                "hop_p99_s": dict(sorted(hop_p99.items())),
                "hop_conservation_frac": min(cons) if cons else None,
                "burn_rate": {c: dict(sorted(w.items()))
                              for c, w in sorted(burn.items())},
                "completed_rate": (math.fsum(rates) if rates else None),
            }

    def query(self, key: str, since: Optional[float] = None,
              step: Optional[float] = None,
              limit: int = QUERY_LIMIT) -> dict:
        """One series over time, bounded.  ``step`` selects resolution:
        absent/0 reads the raw ring; otherwise the finest aggregate
        level with ``width ≥ step`` serves min/max/sum/count/last
        buckets (the coarsest level when every width is finer).  Always
        returns the NEWEST ``limit`` entries (``truncated`` flags a
        cut), plus the gap records overlapping the range.  Raises
        ``KeyError`` for an unknown series (the /query 404)."""
        limit = max(1, min(int(limit), QUERY_LIMIT))
        t_lo = float(since) if since is not None else float("-inf")
        with self._lock:
            s = self._series.get(key)
            if s is None:
                raise KeyError(key)
            if step and step > 0:
                level = None
                for lv in s.levels:
                    if lv.width >= step:
                        level = lv
                        break
                if level is None and s.levels:
                    level = s.levels[-1]
                buckets = [b for b in level.snapshot()
                           if b[0] + level.width > t_lo]
                truncated = len(buckets) > limit
                entries = [
                    {"t": b[0], "min": b[1], "max": b[2], "sum": b[3],
                     "count": b[4], "last": b[5]}
                    for b in buckets[-limit:]]
                step_used = level.width
            else:
                pts = [(t, v) for t, v in s.raw if t >= t_lo]
                truncated = len(pts) > limit
                entries = [[t, v] for t, v in pts[-limit:]]
                step_used = 0.0
            gaps = [dict(g) for g in self._gaps
                    if g["t"] >= t_lo]
            return {"series": key, "name": s.name, "labels": s.labels,
                    "kind": s.kind, "step": step_used,
                    "points": entries, "truncated": truncated,
                    "gaps": gaps}

    def doc(self) -> dict:
        """The /history document: configuration, retention, gap and
        persistence accounting, and the series index — everything an
        operator (or the audit) needs to know what the store holds."""
        with self._lock:
            return {
                "run_id": self.run_id,
                "cadence_s": self.cadence_s,
                "gap_factor": self.gap_factor,
                "raw_capacity": self.raw_capacity,
                "levels": [list(lv) for lv in self.levels],
                "max_series": self.max_series,
                "sampler_alive": self._thread is not None,
                "series": len(self._series),
                "series_dropped": (len(self._dropped_keys)
                                   + self._dropped_overflow),
                "samples": self._samples,
                "sample_errors": self._sample_errors,
                "last_t": self._last_t,
                "gaps": {"count": self._gap_count,
                         "recent": [dict(g)
                                    for g in list(self._gaps)[-10:]]},
                "persist": ({"path": self._base,
                             "shards": self._shard + 1,
                             "records": self._persist_records,
                             "shard_records": self.shard_records}
                            if self._base else None),
                "keys": sorted(self._series),
            }

    # ------------------------------------------------------------ replay
    @classmethod
    def replay(cls, path: str) -> "HistoryStore":
        """Rebuild a store offline from committed shards: read
        ``path`` (+ ``.pN`` siblings) in write order, re-ingest every
        tick through the SAME fold path live sampling used.  The result
        answers every derived-signal call bit-identically to the live
        store at its final tick — recorded traffic becomes a control-law
        regression fixture with no fleet running."""
        shards = discover_history_shards(path)
        if not shards:
            raise FileNotFoundError(
                f"no history shards at {path!r} (nor {path!r}.pN)")
        store: Optional[HistoryStore] = None
        decl: Dict[str, Tuple[str, Dict[str, str], str]] = {}
        for p in shards:
            for rec in read_events(p):
                ev = rec.get("event")
                if ev == "history_start":
                    if rec.get("schema", 0) > HISTORY_SCHEMA:
                        raise ValueError(
                            f"history shard {p!r} has schema "
                            f"{rec.get('schema')} > supported "
                            f"{HISTORY_SCHEMA}")
                    if store is None:
                        store = cls(
                            registry=None,
                            cadence_s=float(rec.get("cadence_s", 0.25)),
                            raw_capacity=int(rec.get("raw_capacity",
                                                     1024)),
                            levels=tuple(
                                (float(w), int(c)) for w, c in
                                rec.get("levels", DEFAULT_LEVELS)),
                            max_series=int(rec.get("max_series", 512)),
                            run_id=rec.get("run_id"),
                            gap_factor=float(rec.get("gap_factor",
                                                     2.5)))
                elif ev == "history_series":
                    decl[rec["key"]] = (
                        rec.get("name", rec["key"]),
                        dict(rec.get("labels") or {}),
                        rec.get("kind", "gauge"))
                elif ev == "history_sample" and store is not None:
                    items = {}
                    for key, v in rec.get("v", {}).items():
                        name, labels, kind = decl.get(
                            key, (key, {}, "gauge"))
                        items[key] = (name, labels, kind, float(v))
                    with store._lock:
                        # gap records in the stream are NOT consumed:
                        # _ingest re-detects them from tick spacing,
                        # which keeps gap accounting on the same shared
                        # path (the report tool cross-checks recorded
                        # vs re-detected gaps instead)
                        store._ingest(float(rec["t"]), items,
                                      persist=False)
        if store is None:
            raise ValueError(
                f"{path!r}: no history_start header in any shard")
        return store
