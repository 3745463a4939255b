"""Process-isolated serving worker: the slot-row serve loop one
:class:`~improved_body_parts_torch.serve.router.ProcessWorkerEngine`
drives over the shared-memory wire (the port's own copy of
``improved_body_parts_tpu/serve/worker.py``; the wire layout is the JAX
package's).

One worker process = one predictor = one CUDA context.  The router
writes each request's image into a preallocated shared-memory slot row
and posts ``("req", slot, seq)`` on the task channel; the worker
serves it (fused device decode with the documented host overflow
fallback) and writes the FIXED-SHAPE person table — ``(max_people,
num_parts, 3)`` float64 keypoints + per-person scores + the free
escalation signals — back into the same slot's response fields.  No
pickling of payloads on either hop: only tiny ``(kind, slot, seq)``
tokens cross the token channels, exactly the ``data.shm_ring``
discipline (seqlock headers, spawn workers, orphan watchdog,
resource-tracker-quiet attach) — with one deliberate upgrade: the
channels are raw one-way ``multiprocessing.Pipe`` connections instead
of ``mp.Queue``.  A Queue puts a FEEDER THREAD on every hop (put →
feeder wake → pipe → reader), and on the serve request path each
thread wake is a scheduler round-trip that lands straight in the
latency budget; a bare pipe sends the token synchronously in the
caller.

The worker's predictor comes from an importable **factory spec**
(``"module:callable"`` + JSON-safe kwargs) so the child process builds
its own instance — tests and fault drills point the spec at
:func:`constant_predictor` (deterministic, no model), the
bench at a planted-weights real predictor.  A factory result that
exposes ``serve_one(image) -> (people, signals)`` is used directly;
anything with the ``Predictor.predict_decoded`` contract gets the
fused-decode + overflow-fallback serve path built around it.

Timestamps on the wire are ``time.perf_counter()`` from the worker
process: on Linux that is CLOCK_MONOTONIC, which is system-wide, so
worker-side hop boundaries land on the same axis as the router's
submit/finish stamps (the ``data.shm_ring`` render-span precedent).
"""
import importlib
import json
import os
import time
import traceback
from typing import Optional, Tuple

import numpy as np

from ..data.shm_ring import (
    _align,
    _attach_shm,
    _HEADER_INTS,
    _quiet_close,
    _slot_layout,
    _slot_views,
)
from ..obs.fleet import (
    REC_DONE,
    REC_EXEC_DONE,
    REC_FLOATS,
    REC_PICKUP,
    REC_WARMUP,
    TELEM_FLOATS,
    WorkerTelemetry,
    flow_id,
)
from ..train.supervisor import chaos_kill_point

#: wire schema version — bumped whenever the slot field list changes;
#: router and worker are always the same build (spawned, not network
#: peers) so this is a debugging aid, not a negotiation.
#: v2: the region grew two trailing blocks after the heartbeat row —
#: the worker telemetry snapshot block and the crash-persistent flight
#: recorder ring (``obs.fleet`` owns both layouts); the 4-float
#: heartbeat survives at its v1 offset.
WIRE_VERSION = 2

#: response status codes (meta_out[0])
STATUS_OK = 0.0
STATUS_ERROR = 1.0
STATUS_EXPIRED = 2.0

#: bytes reserved for a worker-side error message (utf-8, truncated)
ERR_BYTES = 256

#: trailing per-worker heartbeat block (after the slot rows):
#: [perf_counter stamp, served_total, recompiles_post_warmup, pid]
HB_FLOATS = 4


def wire_format(max_hw: Tuple[int, int], num_parts: int,
                max_people: int):
    """(names, shapes, dtypes) of one request/response slot.

    Request fields: the uint8 image row (padded to the worker's max
    bucket) + ``meta_in`` = [h, w, deadline_abs (0 = none), t_submit].
    Response fields: the fixed-shape person table (``kps`` rows are
    (x, y, present) — float64 so the table is bit-identical to the
    in-process decode), per-person ``scores``, the escalation-signal
    vector ``sig`` = [has, n_people, peak_ovf, cand_ovf, person_ovf,
    min_mean_score, fused, reserved], ``meta_out`` = [status, n_encoded,
    t_pickup, t_exec0, t_exec1, t_decode, n_truncated, reserved] and an
    ``err`` utf-8 message row.
    """
    h, w = max_hw
    names = ("img", "meta_in", "kps", "scores", "sig", "meta_out", "err")
    shapes = ((h, w, 3), (4,), (max_people, num_parts, 3),
              (max_people,), (8,), (8,), (ERR_BYTES,))
    dtypes = ("uint8", "float64", "float64", "float64", "float64",
              "float64", "uint8")
    return names, shapes, dtypes


def region_size(slots: int, shapes, dtypes) -> int:
    """Total shared-memory bytes: seqlock headers + slot rows + the
    trailing heartbeat block + the telemetry snapshot block + the
    flight-recorder ring (wire v2)."""
    _, slot_bytes = _slot_layout(shapes, dtypes)
    return (_align(slots * _HEADER_INTS * 8) + slots * slot_bytes
            + _align(HB_FLOATS * 8) + _align(TELEM_FLOATS * 8)
            + _align(REC_FLOATS * 8))


def hb_view(buf, slots: int, shapes, dtypes, writeable: bool):
    """The 4-float heartbeat row after the slot rows (its v1
    offset)."""
    _, slot_bytes = _slot_layout(shapes, dtypes)
    off = _align(slots * _HEADER_INTS * 8) + slots * slot_bytes
    v = np.frombuffer(buf, np.float64, HB_FLOATS, offset=off)
    v.flags.writeable = writeable
    return v


def telem_view(buf, slots: int, shapes, dtypes, writeable: bool):
    """The worker telemetry snapshot block (``obs.fleet`` layout,
    seqlock-parity word at index 0) after the heartbeat row."""
    _, slot_bytes = _slot_layout(shapes, dtypes)
    off = (_align(slots * _HEADER_INTS * 8) + slots * slot_bytes
           + _align(HB_FLOATS * 8))
    v = np.frombuffer(buf, np.float64, TELEM_FLOATS, offset=off)
    v.flags.writeable = writeable
    return v


def rec_view(buf, slots: int, shapes, dtypes, writeable: bool):
    """The crash-persistent flight-recorder ring at the region tail —
    what the router exhumes after a worker death."""
    _, slot_bytes = _slot_layout(shapes, dtypes)
    off = (_align(slots * _HEADER_INTS * 8) + slots * slot_bytes
           + _align(HB_FLOATS * 8) + _align(TELEM_FLOATS * 8))
    v = np.frombuffer(buf, np.float64, REC_FLOATS, offset=off)
    v.flags.writeable = writeable
    return v


def encode_people(people, signals, kps, scores, sig, meta_out) -> None:
    """Write one request's decoded people into the slot's response
    views.  ``people`` is the engine result shape (``decode_device`` /
    ``decode_compact`` output: a list of ``(keypoints, score)`` with
    ``keypoints`` a per-part list of ``None`` or ``(x, y)``); entries
    past the table capacity are dropped and counted in
    ``meta_out[6]``."""
    max_people, num_parts = kps.shape[:2]
    kps[:] = 0.0
    scores[:] = 0.0
    n = min(len(people), max_people)
    for p in range(n):
        parts, score = people[p]
        scores[p] = float(score)
        for j in range(min(len(parts), num_parts)):
            kp = parts[j]
            if kp is not None:
                kps[p, j, 0] = float(kp[0])
                kps[p, j, 1] = float(kp[1])
                kps[p, j, 2] = 1.0
    sig[:] = 0.0
    if signals is not None:
        sig[0] = 1.0
        sig[1] = float(signals.n_people)
        sig[2] = float(signals.peak_overflow)
        sig[3] = float(signals.cand_overflow)
        sig[4] = float(signals.person_overflow)
        sig[5] = float(signals.min_mean_score)
        sig[6] = float(signals.fused)
    meta_out[1] = float(n)
    meta_out[6] = float(len(people) - n)


def decode_people(kps, scores, sig):
    """Inverse of :func:`encode_people`: the engine result (list of
    ``(keypoints, score)``) plus the :class:`EscalationSignals` (or
    ``None``) — copies out of the shared views so the slot can be
    recycled."""
    from ..infer.decode import EscalationSignals

    # n_encoded rides meta_out; infer from the table alone so decoding
    # needs only the three payload views
    present = kps[:, :, 2] != 0.0
    used = np.flatnonzero(present.any(axis=1) | (scores != 0.0))
    n = int(used[-1] + 1) if used.size else 0
    people = []
    for p in range(n):
        parts = []
        for j in range(kps.shape[1]):
            if kps[p, j, 2] != 0.0:
                parts.append((float(kps[p, j, 0]), float(kps[p, j, 1])))
            else:
                parts.append(None)
        people.append((parts, float(scores[p])))
    signals = None
    if sig[0] != 0.0:
        signals = EscalationSignals(
            n_people=int(sig[1]), peak_overflow=bool(sig[2]),
            cand_overflow=bool(sig[3]), person_overflow=bool(sig[4]),
            min_mean_score=float(sig[5]), fused=bool(sig[6]))
    return people, signals


# --------------------------------------------------------------------- #
# predictor factories (importable from the spawned child)               #
# --------------------------------------------------------------------- #
class _ConstantPredictor:
    """Deterministic fake worker predictor: people derived from integer
    image content only (bit-identical in any process), optional per-
    request delay to hold work in flight for crash/drain tests."""

    def __init__(self, num_parts: int = 18, n_people: int = 2,
                 delay_s: float = 0.0, fail_every: int = 0):
        self.num_parts = num_parts
        self.n_people = n_people
        self.delay_s = delay_s
        self.fail_every = fail_every
        self._calls = 0

    def serve_one(self, image):
        from ..infer.decode import EscalationSignals

        if self.delay_s:
            time.sleep(self.delay_s)
        self._calls += 1
        if self.fail_every and self._calls % self.fail_every == 0:
            raise ValueError("injected predictor failure "
                             f"(call {self._calls})")
        base = float(int(image[0, 0, 0])) if image.size else 0.0
        h, w = image.shape[:2]
        people = []
        for p in range(self.n_people):
            parts = []
            for j in range(self.num_parts):
                if (p + j) % 5 == 4:
                    parts.append(None)     # a missing part per person
                else:
                    parts.append((base + p * 7.0 + j * 3.0,
                                  float(h - p) + j * 2.0))
            people.append((parts, base + float(w % 97) + p))
        signals = EscalationSignals(
            n_people=len(people), peak_overflow=False,
            cand_overflow=False, person_overflow=False,
            min_mean_score=base + 1.0, fused=True)
        return people, signals


def constant_predictor(num_parts: int = 18, n_people: int = 2,
                       delay_s: float = 0.0,
                       fail_every: int = 0) -> _ConstantPredictor:
    """Factory spec target for tests and fault drills: no model, bit-deterministic
    output from the image's integer content alone.  ``delay_s`` holds
    each request in flight (crash/drain windows); ``fail_every=n``
    raises on every n-th call (error-delivery path)."""
    return _ConstantPredictor(num_parts=num_parts, n_people=n_people,
                              delay_s=delay_s, fail_every=fail_every)


def load_predictor(spec: str, kwargs: Optional[dict] = None):
    """Build the worker's predictor from an importable factory spec
    ``"module:callable"`` — the child process owns its own instance
    (and its own CUDA context when the factory builds a real one)."""
    mod_name, _, fn_name = spec.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(f"predictor spec {spec!r} is not "
                         "'module:callable'")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(**(kwargs or {}))


def _build_serve_fn(pred):
    """``serve(image) -> (people, signals)`` for either worker
    predictor contract: ``serve_one`` (fakes) or the real
    ``predict_decoded`` fused path with the documented host overflow
    fallback."""
    if hasattr(pred, "serve_one"):
        return pred.serve_one
    from ..infer.decode import device_signals
    from ..infer.pipeline import device_decode_fn

    decode_one = device_decode_fn(pred)

    def serve(image):
        dev = pred.predict_decoded(image)
        signals = device_signals(dev)
        return decode_one(dev, image), signals

    return serve


def _kernel_launches() -> dict:
    """This process's launch counts of the port's kernel wrappers (the
    plain versions, which a CPU predictor runs, count nothing)."""
    from ..cli import kernel_launches

    return kernel_launches()


def _warmup(pred, image_sizes, batch_sizes, max_batch: int) -> dict:
    if not hasattr(pred, "predict_decoded"):
        return {"bucket_shapes": [], "batch_sizes": [],
                "newly_compiled": 0}
    from .warmup import precompile

    return precompile([pred], [tuple(s) for s in image_sizes],
                      max_batch, batch_sizes=batch_sizes, decode=True)


# --------------------------------------------------------------------- #
# worker main (spawn target)                                             #
# --------------------------------------------------------------------- #
def worker_main(worker_idx: int, shm_name: str, slots: int,
                shapes, dtypes, spec: str, spec_kwargs_json: str,
                task_rx, done_tx, parent_pid: int,
                sink_path: Optional[str] = None,
                max_batch: int = 4,
                telemetry: bool = True,
                trace_path: Optional[str] = None,
                run_id: Optional[str] = None) -> None:
    """Worker process entry (spawn target — module importable).

    ``task_rx`` / ``done_tx`` are the one-way pipe connections of the
    token channels (read tasks, write answers).  Serve loop: poll the
    task channel (2 s timeout doubling as the orphan watchdog +
    heartbeat tick), serve each ``("req", slot, seq)`` under the slot
    seqlock, answer with ``("done", worker_idx, slot, seq)``.
    ``("warmup", sizes, batch_sizes)`` precompiles the predictor's
    bucket programs and arms the worker's own ``CompileWatch`` so
    post-warmup recompiles are counted IN the process that would pay
    them (published through the telemetry block; mirrored into the
    heartbeat row for the degenerate case).  A factory/attach failure
    answers ``("init_err", worker_idx, tb)`` and exits — the router's
    lifecycle discipline decides whether to respawn.

    ``telemetry=False`` is the explicit OFF arm of the fleet-obs A/B
    (``cli.fleet_audit``): null sink, null tracer, no snapshot
    publishes, no flight records — only the 4-float heartbeat moves.
    ``trace_path`` names this worker's span-file shard (the parent
    composes the ``.pN`` suffix; flushed every :data:`TRACE_FLUSH_S` on
    the busy path, on idle beats past it, and at the poison pill);
    ``run_id`` stamps the sink shard with the parent run's identity so
    the report tools can refuse a stray shard from another run.
    """
    shm = None
    try:
        try:
            import cv2

            cv2.setNumThreads(0)
        except Exception:  # noqa: BLE001 — cv2 optional in the child
            pass
        from ..obs.events import EventSink, NullSink, set_sink

        sink = None
        if sink_path and telemetry:
            # the multi-process rule: non-lead processes write
            # their own sink shard so streams never interleave
            meta = {"role": "serve_worker", "worker": worker_idx}
            if run_id:
                meta["run_id"] = run_id
            sink = EventSink(sink_path + f".p{worker_idx + 1}",
                             run_meta=meta)
            set_sink(sink)
            sink.emit("worker_start", worker=worker_idx,
                      pid=os.getpid(), spec=spec)
        else:
            # the OFF arm installs the null sink EXPLICITLY (not "no
            # sink happened to be configured") — the A/A hazard rule
            set_sink(NullSink())
        pred = load_predictor(spec, json.loads(spec_kwargs_json))
        serve = _build_serve_fn(pred)
        shm = _attach_shm(shm_name)
        header, views = _slot_views(shm.buf, slots, shapes, dtypes,
                                    writeable=True)
        hb = hb_view(shm.buf, slots, shapes, dtypes, writeable=True)
        hb[3] = float(os.getpid())
        telem = telem_view(shm.buf, slots, shapes, dtypes,
                           writeable=True)
        rec = rec_view(shm.buf, slots, shapes, dtypes, writeable=True)
        wt = WorkerTelemetry(worker_idx, telem, rec, enabled=telemetry,
                             sink=sink,
                             trace_t0=sink.t0 if sink is not None
                             else None,
                             device=getattr(pred, "device", "cpu"))
        from ..obs.trace import set_tracer

        # worker-process tracer: the bounded ring the trace shard
        # flushes from; the null recorder on the OFF arm
        set_tracer(wt.trace)
    except BaseException:  # noqa: BLE001 — surfaced to the router
        try:
            done_tx.send(("init_err", worker_idx,
                          traceback.format_exc()))
        except (OSError, ValueError, BrokenPipeError):
            pass            # router already gone
        if shm is not None:
            _quiet_close(shm)
        return

    try:
        _serve_loop(worker_idx, header, views, hb, task_rx, done_tx,
                    parent_pid, sink, serve, pred, wt, max_batch,
                    trace_path)
    finally:
        # live views make a plain close() raise BufferError at
        # interpreter teardown; detach quietly (the shm_ring worker
        # exit discipline) — the router owns the region's lifetime
        _quiet_close(shm)


#: seconds between periodic worker trace-shard flushes (busy path);
#: idle beats and the poison-pill exit also flush, so a clean stop
#: never loses spans — only a crash does, which is what the flight
#: recorder ring is for
TRACE_FLUSH_S = 5.0


def _serve_loop(worker_idx, header, views, hb, task_rx, done_tx,
                parent_pid, sink, serve, pred, wt,
                max_batch: int, trace_path: Optional[str]) -> None:
    served = 0
    watch = wt.watch
    tracer = wt.trace
    track = f"worker{worker_idx}-serve"
    last_flush = time.perf_counter()
    burst = 0

    def beat(force: bool = False) -> None:
        hb[0] = time.perf_counter()
        hb[1] = float(served)
        hb[2] = float(watch.recompiles.value)
        # busy-path publishes stay throttled (the snapshot sorts the
        # hop reservoirs — hot-loop cost); the idle tick forces, so a
        # quiescent parent reads CURRENT counters within one tick
        wt.publish(force=force)

    def flush_trace(now: float) -> float:
        wt.flush_trace(trace_path)
        return now

    beat()

    def serve_slot(idx: int, seq: int) -> None:
        nonlocal served
        img_v, meta_in, kps, scores, sig, meta_out, err = views[idx]
        t_pickup = time.perf_counter()
        h, w = int(meta_in[0]), int(meta_in[1])
        deadline = float(meta_in[2])
        image = img_v[:h, :w]
        # flight record BEFORE any kill point: a SIGKILL mid-serve must
        # still leave the pickup milestone for the postmortem to name
        wt.record(REC_PICKUP, idx, seq, a=deadline)
        # response write under the slot seqlock: odd while mutating,
        # back to even (seq + 2) when consistent — a router that reads
        # a mismatched seq discards the slot as stale
        header[idx, 0] = seq + 1
        err[:] = 0
        meta_out[:] = 0.0
        meta_out[2] = t_pickup
        t0 = time.perf_counter()
        meta_out[3] = t0
        try:
            if deadline > 0.0 and t0 > deadline:
                meta_out[0] = STATUS_EXPIRED
            else:
                chaos_kill_point("worker_serve")
                people, signals = serve(image)
                meta_out[4] = time.perf_counter()
                wt.record(REC_EXEC_DONE, idx, seq)
                chaos_kill_point("worker_respond")
                encode_people(people, signals, kps, scores, sig,
                              meta_out)
                meta_out[0] = STATUS_OK
        except BaseException:  # noqa: BLE001 — delivered per request
            meta_out[0] = STATUS_ERROR
            msg = traceback.format_exc(limit=3).encode()[-ERR_BYTES:]
            err[:len(msg)] = np.frombuffer(msg, np.uint8)
        if meta_out[4] == 0.0:
            meta_out[4] = time.perf_counter()
        t_done = time.perf_counter()
        meta_out[5] = t_done
        header[idx, 0] = seq + 2
        status = float(meta_out[0])
        wt.record(REC_DONE, idx, seq, a=status)
        wt.count_status(status == STATUS_OK,
                        expired=status == STATUS_EXPIRED)
        if status == STATUS_OK:
            # the hops this process pays, measured where they happen
            # (the router sees the same stamps from the wire — its
            # on_hops feed stays the SLO input; see obs.fleet)
            wt.observe_hops(float(meta_out[4]) - float(meta_out[3]),
                            t_done - float(meta_out[4]))
        if tracer.enabled:
            tracer.add_span_abs("serve", t_pickup, t_done - t_pickup,
                                track=track,
                                args={"slot": idx, "seq": seq,
                                      "status": int(status)})
            tracer.add_span_abs("device", float(meta_out[3]),
                                float(meta_out[4]) - float(meta_out[3]),
                                track=track)
            tracer.add_span_abs("decode", float(meta_out[4]),
                                t_done - float(meta_out[4]),
                                track=track)
            # flow step: threads the router's submit→deliver arc
            # through this worker's serve slice — keyed (cat, id) so
            # every (worker, slot, seq) is its own arc
            tracer.flow_step("req", flow_id(worker_idx, idx, seq),
                             track=track, cat="proc",
                             ts=(t_pickup - tracer.t0)
                             + (t_done - t_pickup) / 2.0)
        served += 1
        # the heartbeat counts a request before its answer leaves: a
        # parent that reads worker_stats() once the future resolved must
        # not see a count one short (the loop's beat() comes after)
        hb[1] = float(served)
        done_tx.send(("done", worker_idx, idx, seq))

    while True:
        try:
            if not task_rx.poll(2.0):
                if burst:
                    wt.on_burst(burst)
                    burst = 0
                wt.sample_memory()
                beat(force=True)
                now = time.perf_counter()
                if trace_path and now - last_flush > TRACE_FLUSH_S:
                    last_flush = flush_trace(now)
                if parent_pid and os.getppid() != parent_pid:
                    return  # orphaned: the router is gone
                continue
            task = task_rx.recv()
        except (EOFError, OSError, ValueError):
            return          # router closed the channel / died
        if task is None:
            if burst:
                wt.on_burst(burst)
            wt.publish(force=True)
            if trace_path:
                flush_trace(time.perf_counter())
            if sink is not None:
                sink.emit("worker_stop", worker=worker_idx,
                          served=served,
                          kernel_launches=_kernel_launches())
                sink.close()
            return
        kind = task[0]
        if kind == "req":
            burst += 1
            serve_slot(task[1], task[2])
            if not task_rx.poll(0):
                # burst over: no token waiting — the occupancy signal
                # (mean requests drained back-to-back per wakeup)
                wt.on_burst(burst)
                burst = 0
                now = time.perf_counter()
                if trace_path and now - last_flush > TRACE_FLUSH_S:
                    last_flush = flush_trace(now)
            beat()
        elif kind == "warmup":
            try:
                info = _warmup(pred, task[1], task[2], max_batch)
                watch.mark_warm("worker warmup precompile")
                wt.record(REC_WARMUP, a=1.0)
                if sink is not None:
                    # the kernels' launches and the requests served so
                    # far: a reader subtracts them from worker_stop's to
                    # get the serving run's
                    sink.emit("worker_warm", worker=worker_idx,
                              served=served,
                              kernel_launches=_kernel_launches())
                done_tx.send(("warmup_done", worker_idx, info))
            except BaseException:  # noqa: BLE001 — warmup failure is
                # an answer, not a crash: the router decides
                wt.record(REC_WARMUP, a=0.0)
                done_tx.send(("warmup_err", worker_idx,
                              traceback.format_exc()))
            wt.publish(force=True)
            beat()
