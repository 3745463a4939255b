"""Fleet observability plane: worker-process telemetry over the shm
wire, merged into ONE parent-side exposition surface (the port's own
copy of ``improved_body_parts_tpu/obs/fleet.py``; the block and ring
layouts are the JAX package's, byte for byte).

Serving replicas that are worker processes (``serve/router.py``) make
the obs stack (registry / ``/metrics`` / ``/slo`` / Perfetto / reqtrace)
process-local: the parent sees only the router side, while each
``serve/worker.py`` child would be a telemetry black hole — a bare
event-sink shard plus four heartbeat floats.  This module closes the
boundary in both directions without any new IPC channel:

- **Worker side** (:class:`WorkerTelemetry`): each worker process runs
  its own ``Registry`` + ``CompileWatch`` + bounded ``TraceRecorder``
  ring + ``DeviceMemory`` gauges and measures the device/decode hops,
  batch occupancy and served/failed counters *in the process that pays
  them*.  Snapshots are published through an **extended heartbeat
  region** at the tail of the existing shared-memory wire: a
  fixed-shape float64 block (:data:`TELEM_FLOATS` wide, versioned by
  :data:`TELEM_VERSION`) written under the same seqlock parity
  discipline the slot rows use — no pickling, no queues, readable at
  any moment by the parent.  The 4-float heartbeat survives
  unchanged at its v1 offset as the degenerate case (telemetry off →
  only the heartbeat block moves).
- **Parent side** (:class:`FleetRegistry`): merges every worker's
  snapshot block into the router's registry **at scrape time** under
  ``worker=``/``pid=`` labels, so one ``MetricsServer`` serves
  fleet-wide ``/metrics``, ``/snapshot``, ``/slo`` and the new
  ``/fleet`` route (per-worker liveness, respawn/crash-budget counters,
  heartbeat staleness).  A cross-process conservation check compares
  router-view submitted against Σ worker-view served + in-flight.
- **Flight recorder**: the worker mirrors its last-N request milestones
  into a crash-persistent shm ring (:data:`REC_SLOTS` × fixed-width
  records).  When the supervisor detects a dead worker — including
  SIGKILL, where no user code gets to run — the router exhumes the
  ring (:func:`read_flight_records`) and emits a ``worker_postmortem``
  naming the in-flight slot/seq, the last completed hop and the last
  recorded milestones (:func:`build_postmortem`,
  :func:`verify_postmortem`).

Staleness discipline: a worker whose telemetry block was never
published (version word still 0 — spawn zeroes the region) exports
ONLY liveness/staleness families, never fresh zeros; a published block
older than the staleness threshold exports its last-known values plus
a ``fleet_worker_stale`` marker.  Timestamps are ``time.perf_counter``
(CLOCK_MONOTONIC — system-wide on Linux, the ``serve/worker.py``
wire-stamp precedent), so heartbeat age is directly comparable across
the process boundary.

Double-count hazard: the worker-side hop reservoirs
exported here are a *second view* of the same requests the router's
``ServeMetrics.on_hops`` already feeds from wire stamps.  Exactly ONE
of the two may feed the SLO tracker — the router's, which sees the
full submit→deliver window; the fleet families exist for attribution
(is the device hop slow *inside* worker 1?), not for objectives.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils.meters import PercentileMeter
from .events import NullSink
from .registry import Registry
from .trace import NullTraceRecorder, TraceRecorder

# --------------------------------------------------------------------- #
# telemetry block layout (float64 indices)                              #
# --------------------------------------------------------------------- #
#: layout version stamped into every published block; the parent
#: refuses to decode an unknown version (same build normally — spawn,
#: not network peers — so this is a debugging aid like WIRE_VERSION)
TELEM_VERSION = 1

T_PARITY = 0        # seqlock word: odd while the worker writes
T_VERSION = 1       # TELEM_VERSION; 0 = never published
T_STAMP = 2         # perf_counter at publish (CLOCK_MONOTONIC)
T_PID = 3
T_SERVED = 4        # requests served, any status (ok+error+expired)
T_OK = 5
T_ERRORS = 6
T_EXPIRED = 7
T_COMPILES = 8      # worker-process compiles (CompileWatch: first runs)
T_RECOMPILES = 9    # post-warmup recompiles
T_COMPILE_S = 10    # wall seconds spent compiling
T_BURSTS = 11       # token bursts drained back-to-back (occupancy)
T_BURST_REQS = 12   # requests across those bursts
T_DEV_BYTES = 13    # device bytes_in_use (0 on statless backends)
T_DEV_PEAK = 14
T_SPANS_RECORDED = 15
T_SPANS_DROPPED = 16
T_HOP0 = 17         # per-hop summary block starts here

#: hops measured IN the worker process (the router's on_hops sees the
#: same requests from wire stamps; see the double-count hazard above)
WORKER_HOPS = ("device", "decode")
#: per-hop summary fields published in the block, seconds
HOP_FIELDS = ("count", "sum_s", "p50_s", "p95_s", "p99_s")

#: block width: 17 fixed + len(WORKER_HOPS)*len(HOP_FIELDS) = 27 used,
#: the rest headroom for the next layout version
TELEM_FLOATS = 32
assert T_HOP0 + len(WORKER_HOPS) * len(HOP_FIELDS) <= TELEM_FLOATS

# --------------------------------------------------------------------- #
# flight-recorder ring layout                                           #
# --------------------------------------------------------------------- #
#: ring header: [parity, total records written, ring slots, record width]
REC_HEADER = 4
REC_SLOTS = 32
REC_WIDTH = 6       # [code, t_mono, slot, seq, a, b]
REC_FLOATS = REC_HEADER + REC_SLOTS * REC_WIDTH

#: record codes — request milestones double as "last completed hop"
REC_PICKUP = 1.0    # token picked up (queue hop done); a=deadline_abs
REC_EXEC_DONE = 2.0  # predictor returned (device hop done)
REC_DONE = 3.0      # response written + token sent (decode done); a=status
REC_BEAT = 4.0      # idle heartbeat tick
REC_WARMUP = 5.0    # warmup handled; a=1 ok / 0 failed

REC_NAMES = {1: "pickup", 2: "exec_done", 3: "done", 4: "beat",
             5: "warmup"}
#: milestone → the last serve hop that COMPLETED before it was written
REC_LAST_HOP = {1: "queue", 2: "device", 3: "decode"}


def flow_id(worker: int, slot: int, seq: int) -> int:
    """Stable Perfetto flow-arc id for one request crossing the process
    boundary — router submit, worker serve and router deliver all stamp
    the same ``(cat="proc", id)`` so the three slices join as one arc."""
    return (((worker + 1) << 44) ^ ((slot & 0xFFF) << 32)
            ^ (seq & 0xFFFFFFFF))


# --------------------------------------------------------------------- #
# seqlock-consistent block reads                                        #
# --------------------------------------------------------------------- #
def read_block(view, retries: int = 64) -> Optional[np.ndarray]:
    """Consistent copy of a parity-worded float64 block (index 0 is the
    seqlock word: odd while the writer mutates).  Bounded retries; a
    persistently torn block — writer died mid-write, or rewriting
    faster than we can copy — returns ``None``."""
    for _ in range(retries):
        p0 = float(view[0])
        if p0 % 2.0 != 0.0:
            continue
        arr = np.array(view, dtype=np.float64)   # copy
        if float(view[0]) == p0 and float(arr[0]) == p0:
            return arr
    return None


def decode_telem(arr: Optional[np.ndarray],
                 staleness_s: float = 5.0,
                 now: Optional[float] = None) -> dict:
    """Decode one telemetry block copy into a JSON-ready dict.

    ``arr=None`` (torn read) and a never-published block (version word
    0) both come back ``{"published": False, ...}`` — the caller must
    not export their zeros as fresh samples."""
    if arr is None:
        return {"published": False, "torn": True}
    version = int(arr[T_VERSION])
    if version == 0:
        return {"published": False, "torn": False}
    if version != TELEM_VERSION:
        return {"published": False, "torn": False,
                "version_mismatch": version}
    now = time.perf_counter() if now is None else now
    age = max(0.0, now - float(arr[T_STAMP]))
    bursts = float(arr[T_BURSTS])
    hops = {}
    for i, hop in enumerate(WORKER_HOPS):
        off = T_HOP0 + i * len(HOP_FIELDS)
        hops[hop] = {f: float(arr[off + j])
                     for j, f in enumerate(HOP_FIELDS)}
    return {
        "published": True,
        "torn": False,
        "version": version,
        "stamp": float(arr[T_STAMP]),
        "age_s": round(age, 3),
        "stale": bool(age > staleness_s),
        "pid": int(arr[T_PID]),
        "served": int(arr[T_SERVED]),
        "ok": int(arr[T_OK]),
        "errors": int(arr[T_ERRORS]),
        "expired": int(arr[T_EXPIRED]),
        "compiles": int(arr[T_COMPILES]),
        "recompiles_post_warmup": int(arr[T_RECOMPILES]),
        "compile_seconds": float(arr[T_COMPILE_S]),
        "bursts": int(bursts),
        "burst_requests": int(arr[T_BURST_REQS]),
        "batch_occupancy_mean": (float(arr[T_BURST_REQS]) / bursts
                                 if bursts else 0.0),
        "device_bytes_in_use": int(arr[T_DEV_BYTES]),
        "device_peak_bytes": int(arr[T_DEV_PEAK]),
        "trace_spans_recorded": int(arr[T_SPANS_RECORDED]),
        "trace_spans_dropped": int(arr[T_SPANS_DROPPED]),
        "hops": hops,
    }


def read_flight_records(view) -> dict:
    """Exhume the flight-recorder ring — tolerant by design: a SIGKILL
    mid-write leaves the parity word odd forever, so after the bounded
    consistent-read attempts fail we take a best-effort copy and flag
    it ``torn`` instead of refusing (a postmortem with one possibly-
    garbled record beats no postmortem)."""
    arr = read_block(view, retries=8)
    torn = arr is None
    if torn:
        arr = np.array(view, dtype=np.float64)
    count = int(max(0.0, arr[1]))
    slots = int(arr[2]) or REC_SLOTS
    width = int(arr[3]) or REC_WIDTH
    records: List[dict] = []
    if 0 < slots <= REC_SLOTS and width == REC_WIDTH:
        for w in range(max(0, count - slots), count):
            base = REC_HEADER + (w % slots) * width
            code = int(arr[base])
            if code not in REC_NAMES:
                continue            # unwritten or garbled slot
            records.append({
                "code": code,
                "kind": REC_NAMES[code],
                "t_mono": float(arr[base + 1]),
                "slot": int(arr[base + 2]),
                "seq": int(arr[base + 3]),
                "a": float(arr[base + 4]),
                "b": float(arr[base + 5]),
            })
    return {"records": records, "count": count, "torn": torn}


# --------------------------------------------------------------------- #
# worker-side publisher                                                 #
# --------------------------------------------------------------------- #
class WorkerTelemetry:
    """The worker process's own obs stack + shm publisher.

    Owns a private :class:`Registry` (this process's families never
    collide with the parent's), a :class:`CompileWatch` armed in the
    process that pays the first runs, a bounded :class:`TraceRecorder`
    ring and a :class:`DeviceMemory` sampler of ``device`` (the worker
    predictor's).  :meth:`publish` writes
    the whole snapshot into the telemetry block under seqlock parity;
    :meth:`record` appends one milestone to the flight-recorder ring.

    ``enabled=False`` is the explicit OFF arm of the overhead A/B
    (``cli.fleet_audit``): the trace recorder is the null one, hop
    meters / flight records / publishes are skipped, and only the
    4-float heartbeat keeps moving — the degenerate case, chosen
    deliberately so the A/B never degenerates to A/A.
    """

    def __init__(self, worker_idx: int, telem=None, rec=None, *,
                 enabled: bool = True, sink=None,
                 trace_capacity: int = 8192,
                 trace_t0: Optional[float] = None,
                 publish_min_interval_s: float = 0.05,
                 device="cpu"):
        self.worker_idx = int(worker_idx)
        self.enabled = bool(enabled)
        self._telem = telem
        self._rec = rec
        self._sink = sink if sink is not None else NullSink()
        self.registry = Registry()
        from .recompile import CompileWatch

        self.watch = CompileWatch(registry=self.registry,
                                  sink=self._sink).install()
        if self.enabled:
            self.trace: object = TraceRecorder(capacity=trace_capacity,
                                               t0=trace_t0)
        else:
            self.trace = NullTraceRecorder()
        from .memory import DeviceMemory

        # the worker predictor's device: its allocator on a card, the
        # explicit zero sampler on the CPU
        self.memory = DeviceMemory(registry=self.registry,
                                   sink=NullSink(), device=device)
        self.hops: Dict[str, PercentileMeter] = {
            h: PercentileMeter(capacity=1024, seed=worker_idx)
            for h in WORKER_HOPS}
        self.served = 0
        self.ok = 0
        self.errors = 0
        self.expired = 0
        self.bursts = 0
        self.burst_reqs = 0
        self._dev_bytes = 0.0
        self._dev_peak = 0.0
        self._last_publish = 0.0
        self._publish_min = float(publish_min_interval_s)
        import os

        self._pid = os.getpid()
        self._rec_count = 0
        if self.enabled and rec is not None:
            # stamp the ring geometry so an exhumer never guesses it
            rec[0] += 1
            rec[2] = float(REC_SLOTS)
            rec[3] = float(REC_WIDTH)
            rec[0] += 1

    # ------------------------------------------------------------ inputs
    def count_status(self, status_ok: bool, expired: bool = False) -> None:
        self.served += 1
        if expired:
            self.expired += 1
        elif status_ok:
            self.ok += 1
        else:
            self.errors += 1

    def observe_hops(self, device_s: float, decode_s: float) -> None:
        if not self.enabled:
            return
        self.hops["device"].update(max(0.0, float(device_s)))
        self.hops["decode"].update(max(0.0, float(decode_s)))

    def on_burst(self, n: int) -> None:
        if n > 0:
            self.bursts += 1
            self.burst_reqs += int(n)

    def sample_memory(self) -> None:
        """Device allocator stats — idle-tick cadence only (walking
        the allocator per request would be real overhead; the CPU
        backends no-op)."""
        if not self.enabled:
            return
        per_dev = self.memory.sample()
        if per_dev:
            self._dev_bytes = float(sum(d["bytes_in_use"]
                                        for d in per_dev.values()))
            self._dev_peak = float(sum(d["peak_bytes"]
                                       for d in per_dev.values()))

    # --------------------------------------------------------- flight ring
    def record(self, code: float, slot: int = 0, seq: int = 0,
               a: float = 0.0, b: float = 0.0) -> None:
        """Append one milestone under the ring's seqlock parity.  Cheap
        enough for the hot path: seven float stores."""
        rec = self._rec
        if rec is None or not self.enabled:
            return
        base = REC_HEADER + (self._rec_count % REC_SLOTS) * REC_WIDTH
        rec[0] += 1                    # odd: writing
        rec[base] = float(code)
        rec[base + 1] = time.perf_counter()
        rec[base + 2] = float(slot)
        rec[base + 3] = float(seq)
        rec[base + 4] = float(a)
        rec[base + 5] = float(b)
        self._rec_count += 1
        rec[1] = float(self._rec_count)
        rec[0] += 1                    # even: consistent

    # ------------------------------------------------------------ publish
    def publish(self, force: bool = False) -> bool:
        """Write the snapshot block under seqlock parity.

        Split hot/cold: the counters are ~20 float stores and publish
        on EVERY call (so a quiescent parent always reads current
        served/ok/error counts — the conservation check's input); the
        per-hop quantile summaries sort the reservoirs, so they
        refresh at most once per ``publish_min_interval_s`` unless
        forced."""
        telem = self._telem
        if telem is None or not self.enabled:
            return False
        now = time.perf_counter()
        do_hops = force or now - self._last_publish >= self._publish_min
        telem[T_PARITY] += 1           # odd: writing
        telem[T_VERSION] = float(TELEM_VERSION)
        telem[T_STAMP] = now
        telem[T_PID] = float(self._pid)
        telem[T_SERVED] = float(self.served)
        telem[T_OK] = float(self.ok)
        telem[T_ERRORS] = float(self.errors)
        telem[T_EXPIRED] = float(self.expired)
        telem[T_COMPILES] = float(self.watch.compiles.value)
        telem[T_RECOMPILES] = float(self.watch.recompiles.value)
        telem[T_COMPILE_S] = float(self.watch.compile_seconds.value)
        telem[T_BURSTS] = float(self.bursts)
        telem[T_BURST_REQS] = float(self.burst_reqs)
        telem[T_DEV_BYTES] = self._dev_bytes
        telem[T_DEV_PEAK] = self._dev_peak
        telem[T_SPANS_RECORDED] = float(self.trace.recorded)
        telem[T_SPANS_DROPPED] = float(self.trace.dropped)
        if do_hops:
            self._last_publish = now
            for i, hop in enumerate(WORKER_HOPS):
                m = self.hops[hop]
                s = m.summary()
                off = T_HOP0 + i * len(HOP_FIELDS)
                telem[off] = float(s["count"])
                telem[off + 1] = float(m.sum)
                telem[off + 2] = float(s["p50"])
                telem[off + 3] = float(s["p95"])
                telem[off + 4] = float(s["p99"])
        telem[T_PARITY] += 1           # even: consistent
        return True

    def flush_trace(self, path: Optional[str]) -> Optional[str]:
        """Write the worker's trace ring to its per-worker span file
        (``TraceRecorder.save``, which carries the ``t0_mono`` anchor);
        same-axis stitching happens in ``cli.trace_report``.  Returns
        the path written, or None when disabled, given no path, or when
        the write fails (a full disk must not kill the serve loop)."""
        if path and self.enabled and getattr(self.trace, "enabled", False):
            try:
                return self.trace.save(path)
            except Exception:  # noqa: BLE001 — never raise into the
                return None    # serve loop
        return None


# --------------------------------------------------------------------- #
# postmortem                                                            #
# --------------------------------------------------------------------- #
def build_postmortem(worker_idx: int, pid: Optional[int],
                     exitcode: Optional[int],
                     flight: dict,
                     in_flight: Iterable[Tuple[int, int]]) -> dict:
    """Assemble the ``worker_postmortem`` record from an exhumed ring
    plus the router's in-flight ledger.  Each in-flight ``(slot, seq)``
    is matched against the ring newest-first: the newest milestone for
    that request names the last hop it completed before the process
    died (``None`` = the worker never picked it up)."""
    records = list(flight.get("records", []))
    inflight_out = []
    for slot, seq in in_flight:
        last_hop = None
        last_kind = None
        for r in reversed(records):
            if r["slot"] == int(slot) and r["seq"] == int(seq) \
                    and r["code"] in REC_LAST_HOP:
                last_hop = REC_LAST_HOP[r["code"]]
                last_kind = r["kind"]
                break
        inflight_out.append({"slot": int(slot), "seq": int(seq),
                             "last_completed_hop": last_hop,
                             "last_milestone": last_kind})
    overall = None
    for r in reversed(records):
        if r["code"] in REC_LAST_HOP:
            overall = REC_LAST_HOP[r["code"]]
            break
    return {
        "worker": int(worker_idx),
        "pid": pid,
        "exitcode": exitcode,
        "torn": bool(flight.get("torn", False)),
        "records_written": int(flight.get("count", 0)),
        "in_flight": inflight_out,
        "last_completed_hop": overall,
        "last_records": records[-10:],
    }


def verify_postmortem(pm: dict, require_in_flight: bool = True
                      ) -> Tuple[bool, List[str]]:
    """Structural verifier for a ``worker_postmortem`` record — the
    chaos harness's assertion that the exhumed ring actually identifies
    the killed batch, not merely that a dict exists."""
    problems: List[str] = []
    if not isinstance(pm, dict):
        return False, ["postmortem is not a dict"]
    if not isinstance(pm.get("worker"), int):
        problems.append("missing integer 'worker'")
    if "exitcode" not in pm:
        problems.append("missing 'exitcode'")
    recs = pm.get("last_records")
    if not isinstance(recs, list):
        problems.append("missing 'last_records' list")
        recs = []
    for r in recs:
        if not (isinstance(r, dict) and r.get("code") in REC_NAMES
                and isinstance(r.get("t_mono"), float)):
            problems.append(f"malformed record: {r!r}")
            break
    inflight = pm.get("in_flight")
    if not isinstance(inflight, list):
        problems.append("missing 'in_flight' list")
        inflight = []
    for e in inflight:
        if not (isinstance(e, dict) and isinstance(e.get("slot"), int)
                and e.get("slot") >= 0 and isinstance(e.get("seq"), int)
                and e.get("seq") > 0):
            problems.append(f"in-flight entry lacks slot/seq: {e!r}")
            break
    hops = set(REC_LAST_HOP.values()) | {None}
    if pm.get("last_completed_hop") not in hops:
        problems.append(
            f"last_completed_hop {pm.get('last_completed_hop')!r} is "
            f"not a known hop")
    if require_in_flight:
        if not inflight:
            problems.append("no in-flight slot/seq named (the killed "
                            "batch is unidentified)")
        elif not any(e.get("last_completed_hop") for e in inflight):
            problems.append("no in-flight request matched a recorded "
                            "milestone — the ring does not identify "
                            "the killed batch")
    return not problems, problems


# --------------------------------------------------------------------- #
# parent-side merge                                                     #
# --------------------------------------------------------------------- #
_Q = (("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s"))


class FleetRegistry:
    """Scrape-time merge of worker snapshot blocks into one registry.

    Workers register as ``(idx, telem_fn, info_fn)``: ``telem_fn``
    returns a consistent block copy (or ``None``), ``info_fn`` the
    router-side view (liveness, crash budget, in-flight, submitted).
    Nothing is cached — every scrape reads the live shm blocks, so a
    merge-under-rewrite is torn-read-safe purely through the seqlock
    (hammered by the tier-1 suite).
    """

    def __init__(self, staleness_s: float = 5.0):
        self.staleness_s = float(staleness_s)
        self._lock = threading.Lock()
        self._workers: List[Tuple[int, Callable, Callable]] = []

    def add_worker(self, idx: int, telem_fn: Callable[[], object],
                   info_fn: Callable[[], dict]) -> None:
        with self._lock:
            self._workers = [w for w in self._workers if w[0] != idx]
            self._workers.append((int(idx), telem_fn, info_fn))
            self._workers.sort(key=lambda w: w[0])

    def add_engine(self, engine) -> None:
        """Convenience for ``ProcessWorkerEngine``-shaped sources."""
        self.add_worker(engine.worker_idx, engine.telem_read,
                        engine.worker_info)

    # ------------------------------------------------------------ readout
    def _rows(self) -> List[dict]:
        with self._lock:
            workers = list(self._workers)
        now = time.perf_counter()
        rows = []
        for idx, telem_fn, info_fn in workers:
            try:
                info = dict(info_fn() or {})
            except Exception:  # noqa: BLE001 — a dead engine reads as
                info = {}      # a down worker, not a scrape crash
            try:
                arr = telem_fn()
            except Exception:  # noqa: BLE001
                arr = None
            telem = decode_telem(arr, staleness_s=self.staleness_s,
                                 now=now)
            rows.append({"worker": idx, "info": info, "telemetry": telem})
        return rows

    def conservation(self, rows: Optional[List[dict]] = None) -> dict:
        """Router-view submitted vs Σ worker-view served + in-flight.

        At quiescence on a clean run the two sides are EQUAL (frac 1.0);
        worker crashes lose their in-flight served-side counts, so the
        audit gate is ≥ 0.95 over a run with chaos in it.  Falls back to
        the 4-float heartbeat's served counter for workers that have not
        published (a worker still starting, one killed before its first
        publish, or one with telemetry off)."""
        rows = self._rows() if rows is None else rows
        submitted = 0
        served = 0
        in_flight = 0
        for r in rows:
            info, telem = r["info"], r["telemetry"]
            submitted += int(info.get("submitted", 0))
            in_flight += int(info.get("in_flight", 0))
            if telem.get("published"):
                served += int(telem["served"])
            else:
                served += int(info.get("hb_served", 0))
        frac = (served + in_flight) / submitted if submitted else None
        return {"router_submitted": submitted,
                "workers_served": served,
                "in_flight": in_flight,
                "frac": round(frac, 4) if frac is not None else None}

    def fleet_state(self) -> dict:
        """The ``/fleet`` route body."""
        rows = self._rows()
        out_workers = []
        for r in rows:
            info, telem = r["info"], r["telemetry"]
            out_workers.append({
                "worker": r["worker"],
                **info,
                "telemetry": telem,
            })
        return {"workers": out_workers,
                "staleness_threshold_s": self.staleness_s,
                "conservation": self.conservation(rows)}

    def health_extra(self) -> dict:
        """The ``/healthz`` fleet block (``HealthSentinel.set_extra``):
        per-worker alive/backing-off/gave-up + heartbeat staleness, and
        a non-ok status once any worker is past its crash budget — the
        sentinel escalates that to the probe's 503."""
        rows = self._rows()
        workers = []
        exhausted = []
        for r in rows:
            info, telem = r["info"], r["telemetry"]
            gave_up = bool(info.get("gave_up", False))
            if gave_up:
                exhausted.append(r["worker"])
            workers.append({
                "worker": r["worker"],
                "alive": bool(info.get("alive", False)),
                "backing_off": bool(info.get("backing_off", False)),
                "gave_up": gave_up,
                "consecutive_failures": int(
                    info.get("consecutive_failures", 0)),
                "crash_budget": int(info.get("crash_budget", 0)),
                "heartbeat_age_s": info.get("hb_age_s"),
                "stale": bool(telem.get("stale", False)),
            })
        status = ("worker_crash_budget_exhausted" if exhausted else "ok")
        return {"status": status, "workers": workers,
                "exhausted": exhausted}

    # --------------------------------------------------------- exposition
    def attach(self, registry) -> "FleetRegistry":
        """Register the scrape-time collector (weakref — a registry
        outliving its fleet scrapes no samples instead of pinning it)."""
        import weakref

        ref = weakref.ref(self)

        def _collect():
            fleet = ref()
            return fleet.samples() if fleet is not None else []

        registry.register_collector(_collect)
        return self

    def samples(self) -> List[tuple]:
        """``(name, labels, kind, value, help)`` samples for every
        worker — the registry accepts the 5-tuple collector form so
        fleet families carry HELP text like first-class metrics."""
        out: List[tuple] = []
        rows = self._rows()
        for r in rows:
            idx, info, telem = r["worker"], r["info"], r["telemetry"]
            pid = telem.get("pid") or info.get("pid")
            lab = {"worker": str(idx),
                   "pid": str(pid if pid is not None else "none")}
            up = bool(info.get("alive", False)
                      and info.get("running", False))
            out += [
                ("fleet_worker_up", lab, "gauge", float(up),
                 "1 while the worker process is alive and serving"),
                ("fleet_worker_stale", lab, "gauge",
                 float(bool(telem.get("stale", False))),
                 "1 while the worker's telemetry block is older than "
                 "the staleness threshold"),
                ("fleet_worker_heartbeat_age_seconds", lab, "gauge",
                 float(info.get("hb_age_s") or 0.0),
                 "seconds since the worker's last heartbeat stamp"),
                ("fleet_worker_restarts_total", lab, "counter",
                 float(info.get("restarts", 0)),
                 "times this worker slot was (re)spawned"),
                ("fleet_worker_gave_up", lab, "gauge",
                 float(bool(info.get("gave_up", False))),
                 "1 once the worker exhausted its crash budget"),
                ("fleet_worker_consecutive_failures", lab, "gauge",
                 float(info.get("consecutive_failures", 0)),
                 "consecutive no-progress spawns (crash-budget input)"),
                ("fleet_worker_crash_budget", lab, "gauge",
                 float(info.get("crash_budget", 0)),
                 "configured crash budget"),
                ("fleet_worker_in_flight", lab, "gauge",
                 float(info.get("in_flight", 0)),
                 "router-view requests currently pinned to this "
                 "worker's slots"),
            ]
            if not telem.get("published"):
                # never-published / torn block: liveness families only —
                # a worker that has not reported must not export fresh
                # zeros that read as 'served nothing, using no memory'
                continue
            out += [
                ("fleet_worker_served_total", lab, "counter",
                 float(telem["served"]),
                 "requests served by this worker (any status), counted "
                 "in the worker process"),
                ("fleet_worker_ok_total", lab, "counter",
                 float(telem["ok"]), "requests served OK"),
                ("fleet_worker_errors_total", lab, "counter",
                 float(telem["errors"]), "requests that errored in the "
                 "worker"),
                ("fleet_worker_expired_total", lab, "counter",
                 float(telem["expired"]),
                 "requests that expired before serving"),
                ("fleet_worker_xla_compiles_total", lab, "counter",
                 float(telem["compiles"]),
                 "compiles in the worker process (first runs of an "
                 "unwarmed lane shape)"),
                ("fleet_worker_xla_recompiles_post_warmup_total", lab,
                 "counter", float(telem["recompiles_post_warmup"]),
                 "post-warmup recompiles in the worker process"),
                ("fleet_worker_xla_compile_seconds_total", lab,
                 "counter", float(telem["compile_seconds"]),
                 "wall seconds the worker spent compiling"),
                ("fleet_worker_batch_bursts_total", lab, "counter",
                 float(telem["bursts"]),
                 "back-to-back token bursts drained"),
                ("fleet_worker_burst_requests_total", lab, "counter",
                 float(telem["burst_requests"]),
                 "requests across those bursts"),
                ("fleet_worker_batch_occupancy_mean", lab, "gauge",
                 float(telem["batch_occupancy_mean"]),
                 "mean requests per drained burst"),
                ("fleet_worker_device_bytes_in_use", lab, "gauge",
                 float(telem["device_bytes_in_use"]),
                 "worker-process device allocator bytes in use"),
                ("fleet_worker_device_peak_bytes", lab, "gauge",
                 float(telem["device_peak_bytes"]),
                 "worker-process device allocator peak bytes"),
                ("fleet_worker_trace_spans_recorded", lab, "gauge",
                 float(telem["trace_spans_recorded"]),
                 "spans currently in the worker's trace ring"),
                ("fleet_worker_trace_spans_dropped_total", lab,
                 "counter", float(telem["trace_spans_dropped"]),
                 "spans evicted from the worker's trace ring"),
            ]
            for hop, s in telem["hops"].items():
                hlab = {**lab, "hop": hop}
                for q, key in _Q:
                    out.append(("fleet_worker_hop_latency_seconds",
                                {**hlab, "quantile": q}, "gauge",
                                float(s[key]),
                                "per-hop latency measured in the worker "
                                "process"))
                out += [
                    ("fleet_worker_hop_latency_seconds_sum", hlab,
                     "counter", float(s["sum_s"]), ""),
                    ("fleet_worker_hop_latency_seconds_count", hlab,
                     "counter", float(s["count"]), ""),
                ]
        cons = self.conservation(rows)
        out += [
            ("fleet_router_submitted_total", {}, "counter",
             float(cons["router_submitted"]),
             "router-view requests submitted across the fleet"),
            ("fleet_workers_served_total", {}, "counter",
             float(cons["workers_served"]),
             "worker-view requests served across the fleet"),
            ("fleet_in_flight", {}, "gauge", float(cons["in_flight"]),
             "requests currently crossing the process boundary"),
        ]
        if cons["frac"] is not None:
            out.append(("fleet_conservation_frac", {}, "gauge",
                        float(cons["frac"]),
                        "(workers served + in-flight) / router "
                        "submitted — 1.0 at clean-run quiescence"))
        return out
