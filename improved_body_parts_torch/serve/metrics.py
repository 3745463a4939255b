"""Per-stage serving metrics: admission counters, queue depth, batch
occupancy histogram, end-to-end latency percentiles, the hop waterfall
(the port's own copy of ``improved_body_parts_tpu/serve/metrics.py``).

Built on ``utils.meters`` (``PercentileMeter`` reservoir for tail
latency); every mutator is thread-safe — submit happens on N client
threads, dispatch on the batcher thread, completion on the decode pool.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..utils.meters import PercentileMeter

#: the batcher's per-request hop waterfall, in pipeline order.  The
#: five segments PARTITION the submit→finish window with shared
#: boundary stamps, so their sum equals the measured e2e latency by
#: construction — the conservation discipline (hop sums must account
#: for ≥95% of e2e) holds exactly at this layer and the cross-hop
#: layers above it only lose callback-handoff microseconds.
#:
#: - ``queue``: submit → the dispatcher buckets the request;
#: - ``batch_formation``: bucketed → the bucket flushes to a device;
#: - ``device``: dispatch → the batch's single fetch lands (forward +
#:   compact extraction + on-device assembly on the fused lane);
#: - ``decode``: fetch → skeletons (inline O(people) finish on the
#:   fused lane; the decode pool's queue+work on the host-pool lane
#:   and for overflow fallbacks);
#: - ``deliver``: decoded → the future resolves.
HOPS = ("queue", "batch_formation", "device", "decode", "deliver")


class ServeMetrics:
    """Counters and histograms for one :class:`serve.DynamicBatcher`.

    Stages and their signals (queue depth, batch occupancy histogram,
    p50/p95/p99 latency, imgs/sec):

    - admission: ``submitted`` / ``rejected`` (load-shed) counts and the
      current/peak in-flight depth;
    - coalescing: ``occupancy`` — dispatched-batch-size → batch count
      (full ``max_batch`` entries mean the deadline never fired; a spike
      at 1 means traffic is too sparse for the configured wait);
    - completion: ``completed`` / ``failed`` counts, a latency reservoir
      (submit → decoded-result, seconds), and the wall-clock window for
      the imgs/sec readout;
    - decode routing: ``decode_fused`` (the request's skeletons came out
      of the fused device program) vs ``decode_host_fallback`` (an
      overflow flag routed it to the host decode pool) — the observable
      fallback rate of the device-decode lane.  The host-pool lane
      (``device_decode=False``) counts everything as fallback.

    ``model`` adds a ``{model="..."}`` label dimension to every exported
    sample: a multi-model deployment registers one ServeMetrics per
    model into the SAME registry and the traffic split stays separable
    without a second registry or prefix forks.
    """

    def __init__(self, latency_reservoir: int = 4096,
                 model: Optional[str] = None):
        self.model = model
        self._lock = threading.Lock()
        self.latency = PercentileMeter(latency_reservoir)
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        # deadline accounting: requests that died of DeadlineExceeded.
        # An ADMITTED request that expires is also counted in `failed`
        # (conservation: submitted == completed + failed + depth must
        # keep holding); a submit-time expiry is counted here only —
        # like `rejected`, it was never admitted.
        self.expired = 0
        self.decode_fused = 0
        self.decode_host_fallback = 0
        self.depth = 0              # in-flight requests (admitted, not done)
        self.depth_peak = 0
        self.occupancy: Dict[int, int] = {}
        # per-hop latency reservoirs: aggregate (the snapshot/bench
        # block) + per-replica (the {model=,replica=,hop=} labeled
        # exposition) — both fed once per COMPLETED request
        self.hops: Dict[str, PercentileMeter] = {
            h: PercentileMeter(latency_reservoir) for h in HOPS}
        self._hops_by_replica: Dict[int, Dict[str, PercentileMeter]] = {}
        self._hop_reservoir = latency_reservoir
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._t_busy: Optional[float] = None  # last idle->busy instant

    # ------------------------------------------------------------- hooks
    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            self.depth += 1
            self.depth_peak = max(self.depth_peak, self.depth)
            if self.depth == 1:
                # idle -> busy transition: the stall clock anchors HERE,
                # never at the last completion of a previous busy period
                # — or a request admitted after an idle gap would be
                # born with stall_age == the idle time, and a router
                # would call a healthy replica wedged the instant new
                # work lands on it
                self._t_busy = time.perf_counter()
            if self._t_first is None:
                self._t_first = time.perf_counter()

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def on_dispatch(self, batch_size: int) -> None:
        with self._lock:
            self.occupancy[batch_size] = self.occupancy.get(
                batch_size, 0) + 1

    def on_decode(self, fused: bool) -> None:
        """One request routed to its decode stage: the fused device
        program's inline finish, or the host decode pool (overflow
        fallback / host-pool lane)."""
        with self._lock:
            if fused:
                self.decode_fused += 1
            else:
                self.decode_host_fallback += 1

    def on_hops(self, replica: int, durations) -> None:
        """One completed request's hop waterfall: ``durations`` aligned
        with :data:`HOPS` (seconds).  Fed alongside ``on_complete`` so
        hop sums and the e2e reservoir describe the same request set —
        what makes the conservation check (Σ hop sums ≥ 95% of
        Σ e2e) well-defined."""
        with self._lock:
            per = self._hops_by_replica.get(replica)
            if per is None:
                per = self._hops_by_replica[replica] = {
                    h: PercentileMeter(self._hop_reservoir)
                    for h in HOPS}
            for hop, d in zip(HOPS, durations):
                d = max(float(d), 0.0)
                self.hops[hop].update(d)
                per[hop].update(d)

    def completed_by_replica(self) -> Dict[int, int]:
        """Requests completed on each replica (those whose hops were
        recorded), by replica index."""
        with self._lock:
            return {r: per[HOPS[0]].count
                    for r, per in sorted(self._hops_by_replica.items())}

    def on_complete(self, latency_s: float) -> None:
        with self._lock:
            self.completed += 1
            self.depth -= 1
            self.latency.update(latency_s)
            self._t_last = time.perf_counter()

    def on_fail(self, expired: bool = False) -> None:
        with self._lock:
            self.failed += 1
            if expired:
                self.expired += 1
            self.depth -= 1
            self._t_last = time.perf_counter()

    def on_expire_rejected(self) -> None:
        """A submit whose deadline was already non-positive: refused at
        the door, never admitted (no depth/submitted movement)."""
        with self._lock:
            self.expired += 1

    def stall_age_s(self) -> Optional[float]:
        """Seconds since the pipeline last made progress while work is
        IN FLIGHT — ``None`` when idle.  Progress is a completion or
        failure; the anchor is the LATER of the last progress and the
        start of the current busy period (idle time before the current
        work was admitted is not a stall).  The health-probe signal a
        router uses to call a replica wedged: depth stuck above zero
        with a growing stall age means admitted work stopped moving."""
        with self._lock:
            if self.depth <= 0:
                return None
            anchor = self._t_busy
            if self._t_last is not None and (anchor is None
                                             or self._t_last > anchor):
                anchor = self._t_last
            if anchor is None:
                return None
            return time.perf_counter() - anchor

    # --------------------------------------------------------- telemetry
    def register_into(self, registry, prefix: str = "serve"
                      ) -> "ServeMetrics":
        """Export every signal through a shared ``obs.Registry`` (or any
        object with ``register_collector(fn)``, where ``fn()`` returns
        :meth:`collect`'s samples).

        Registered as a scrape-time collector rather than mirrored
        metric objects: the counters already live behind this object's
        lock, so sampling at scrape time adds zero hot-path cost and
        can never drift from :meth:`snapshot`.  The collector holds
        only a weakref — a registry that outlives its batcher (the
        process-global one) scrapes a dead source as no samples instead
        of pinning it forever.
        """
        import weakref

        ref = weakref.ref(self)

        def _collect():
            m = ref()
            return m.collect(prefix) if m is not None else []

        registry.register_collector(_collect)
        return self

    def collect(self, prefix: str = "serve"):
        """(name, labels, kind, value) samples for a registry."""
        with self._lock:
            counts = (("submitted", self.submitted),
                      ("rejected", self.rejected),
                      ("completed", self.completed),
                      ("failed", self.failed),
                      ("expired", self.expired),
                      ("decode_fused", self.decode_fused),
                      ("decode_host_fallback", self.decode_host_fallback))
            depth, peak = self.depth, self.depth_peak
            occupancy = dict(self.occupancy)
            lat = self.latency.summary()   # seconds
            lat_sum = self.latency.sum
            hop_samples = [
                (str(replica), hop, m.summary(), m.sum)
                for replica, per in sorted(self._hops_by_replica.items())
                for hop, m in per.items()]
            hop_sum_total = sum(m.sum for m in self.hops.values())
        # the per-tier label dimension: one dict merged into EVERY
        # sample's labels, so a shared registry separates student vs
        # teacher traffic without a second registry or prefix fork
        base = {"model": self.model} if self.model else {}
        samples = [(f"{prefix}_{name}_total", dict(base), "counter",
                    float(v))
                   for name, v in counts]
        samples += [
            (f"{prefix}_queue_depth", dict(base), "gauge", float(depth)),
            (f"{prefix}_queue_depth_peak", dict(base), "gauge",
             float(peak)),
        ]
        for size, n in sorted(occupancy.items()):
            samples.append((f"{prefix}_batches_total",
                            {**base, "size": str(size)}, "counter",
                            float(n)))
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            samples.append((f"{prefix}_latency_seconds",
                            {**base, "quantile": q}, "gauge", lat[key]))
        samples += [
            (f"{prefix}_latency_seconds_sum", dict(base), "counter",
             lat_sum),
            (f"{prefix}_latency_seconds_count", dict(base), "counter",
             float(lat["count"])),
            (f"{prefix}_imgs_per_sec", dict(base), "gauge",
             self.throughput()),
            # the conservation invariant as a scrapeable gauge.  1.0
            # is the vacuous reading — before any completion, and at
            # layers that never receive on_hops — because a 0.0 would
            # read as a hard accounting break
            (f"{prefix}_hop_conservation_frac", dict(base), "gauge",
             (hop_sum_total / lat_sum
              if lat_sum > 0 and hop_sum_total > 0 else 1.0)),
            # mean images per dispatched batch — the occupancy headroom
            (f"{prefix}_batch_occupancy_mean", dict(base), "gauge",
             (sum(k * v for k, v in occupancy.items())
              / sum(occupancy.values()) if occupancy else 0.0)),
        ]
        # the per-hop attribution families: {model=,replica=,hop=}
        # labeled quantiles + _sum/_count, one series set per hop per
        # replica — the registry-level half of the request waterfall
        # (the per-request half is obs.reqtrace)
        for replica, hop, s, hop_sum in hop_samples:
            labels = {**base, "replica": replica, "hop": hop}
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                samples.append((f"{prefix}_hop_latency_seconds",
                                {**labels, "quantile": q}, "gauge",
                                s[key]))
            samples += [
                (f"{prefix}_hop_latency_seconds_sum", labels, "counter",
                 hop_sum),
                (f"{prefix}_hop_latency_seconds_count", labels,
                 "counter", float(s["count"])),
            ]
        return samples

    # ----------------------------------------------------------- readout
    def mean_occupancy(self) -> float:
        """Mean images per dispatched batch (0.0 before any dispatch)."""
        with self._lock:
            n_batches = sum(self.occupancy.values())
            n_images = sum(k * v for k, v in self.occupancy.items())
        return n_images / n_batches if n_batches else 0.0

    def throughput(self) -> float:
        """Completed imgs/sec over the first-submit → last-completion
        window (0.0 until at least one request completed)."""
        with self._lock:
            if (self._t_first is None or self._t_last is None
                    or self._t_last <= self._t_first):
                return 0.0
            return self.completed / (self._t_last - self._t_first)

    def snapshot(self) -> dict:
        """One JSON-ready dict of every signal (latencies in ms)."""
        with self._lock:
            occupancy = dict(sorted(self.occupancy.items()))
            out = {
                **({"model": self.model} if self.model else {}),
                "submitted": self.submitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "failed": self.failed,
                "expired": self.expired,
                "decode_fused": self.decode_fused,
                "decode_host_fallback": self.decode_host_fallback,
                "queue_depth": self.depth,
                "queue_depth_peak": self.depth_peak,
                "occupancy_histogram": {str(k): v
                                        for k, v in occupancy.items()},
                "latency_ms": self.latency.summary(scale=1e3),
                # the per-hop decomposition block (ms): p50/p95/p99 +
                # exact mean/count/sum per hop, aggregated over
                # replicas
                "hops_ms": {
                    h: {**m.summary(scale=1e3),
                        "sum": round(m.sum * 1e3, 3)}
                    for h, m in self.hops.items()},
                "hop_conservation_frac": (
                    round(sum(m.sum for m in self.hops.values())
                          / self.latency.sum, 4)
                    if self.latency.sum > 0 else None),
            }
        out["mean_batch_occupancy"] = round(self.mean_occupancy(), 3)
        out["imgs_per_sec"] = round(self.throughput(), 3)
        return out
