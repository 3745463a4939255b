"""Per-stream sessions over the serving engine: ordered async frame
pipelines with bounded in-flight depth, temporal tracking and optional
smoothing (the port's own copy of
``improved_body_parts_tpu/stream/session.py``).

``serve.DynamicBatcher`` answers *one image → skeletons* for many
concurrent callers; a video stream needs more: results delivered **in
frame order** (the tracker is sequential state), an **in-flight bound**
per stream (a webcam must not buffer unboundedly behind a slow engine),
and an explicit **backpressure policy** when the bound is hit —
``"block"`` (hold the producer: offline transcoding, every frame
matters) or ``"drop_oldest"`` (drop the stalest undelivered frame:
live viewing, freshness matters).  Dropped frames are *accounted* (a
counter, a failed future, a trace instant), never silent.

Threading model: sessions spawn **no threads**.  ``submit_frame``
enqueues the frame and hands the image to the batcher; delivery rides
the batcher's own completion threads via ``Future.add_done_callback`` —
an internal deliver lock serializes per-session delivery and a frame is
only delivered once every earlier frame of its stream was, so tracker
updates are strictly frame-ordered no matter which engine thread
finishes first.  The batcher guarantees every submitted future
completes (on time, by drain deadline, or with the stop error), which
is exactly what makes :meth:`StreamSession.close` compose with
``DynamicBatcher.stop``: close never strands a session future.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.reqtrace import NULL_NODE, get_reqtrace
from ..obs.trace import get_tracer
from ..serve.batcher import ServerOverloaded
from ..serve.policy import jittered_backoff
from ..utils.meters import PercentileMeter
from .fastpath import (FASTPATH_REASONS, TIERS, FastPath, FastPathConfig,
                       paste_back, signals_from_people, split_result)
from .smooth import KeypointSmoother
from .track import Tracker


class FrameDropped(RuntimeError):
    """The frame was dropped by the session's ``drop_oldest``
    backpressure policy (or by close) — delivered on the frame's own
    future so a pipelined producer learns *which* frames never made it.
    """


class _Frame:
    __slots__ = ("seq", "future", "t_submit", "tr0", "ready", "dropped",
                 "result", "error", "image", "epoch", "engine_submitted",
                 "ctx", "attempt_nodes", "won_node", "t_ready", "t_admit",
                 "tier", "roi_off")

    def __init__(self, seq: int, t_submit: float, tr0: float, image):
        self.seq = seq
        self.future: Future = Future()
        self.t_submit = t_submit
        self.tr0 = tr0              # tracer timestamp at submit
        self.ready = False          # engine result (or error) landed
        self.dropped = False        # future already failed FrameDropped
        self.result = None
        self.error: Optional[BaseException] = None
        self.ctx = NULL_NODE        # reqtrace node (obs.reqtrace)
        self.attempt_nodes: Dict[int, object] = {}  # epoch -> child
        self.won_node = None        # the attempt whose outcome landed
        self.t_ready: Optional[float] = None
        self.t_admit: Optional[float] = None
        # retained until the frame resolves so a migration off a fenced
        # replica can RE-SUBMIT it (bounded by max_in_flight frames per
        # stream); freed the moment ready/dropped lands
        self.image = image
        # engine-attempt generation: a migration bumps it, and an ERROR
        # from a stale attempt (the fenced replica's drain failure) is
        # discarded — the re-submitted attempt owns the frame's outcome.
        # A RESULT from any epoch wins (real work is never thrown away).
        self.epoch = 0
        self.engine_submitted = False   # an engine future is wired
        # fast-path routing (stream.fastpath): which tier answers this
        # frame, and — ROI tier — the crop's (x, y) full-frame offset
        self.tier: Optional[str] = None
        self.roi_off: Optional[tuple] = None


class StreamMetrics:
    """Per-stream counters + e2e latency reservoir (thread-safe; the
    ``ServeMetrics`` pattern one level up the stack)."""

    def __init__(self, latency_reservoir: int = 2048):
        self._lock = threading.Lock()
        self.latency = PercentileMeter(latency_reservoir)
        self.submitted = 0
        self.delivered = 0
        self.dropped = 0
        self.failed = 0
        # engine-admission retries (ServerOverloaded absorbed by the
        # session's jittered backoff instead of surfacing as a failure)
        self.shed_retries = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            if self._t_first is None:
                self._t_first = time.perf_counter()

    def on_deliver(self, latency_s: float) -> None:
        with self._lock:
            self.delivered += 1
            self.latency.update(latency_s)
            self._t_last = time.perf_counter()

    def on_drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def on_shed_retry(self) -> None:
        with self._lock:
            self.shed_retries += 1

    def on_fail(self) -> None:
        with self._lock:
            self.failed += 1
            self._t_last = time.perf_counter()

    def fps(self) -> float:
        """Delivered frames/sec over the first-submit → last-delivery
        window (0.0 until one frame delivered)."""
        with self._lock:
            if (self._t_first is None or self._t_last is None
                    or self._t_last <= self._t_first):
                return 0.0
            return self.delivered / (self._t_last - self._t_first)

    def sample(self):
        """One consistent (counts, latency_summary, latency_sum) read
        for the registry collector."""
        with self._lock:
            counts = (("frames_submitted", self.submitted),
                      ("frames_delivered", self.delivered),
                      ("frames_dropped", self.dropped),
                      ("frames_failed", self.failed),
                      ("engine_shed_retries", self.shed_retries))
            return counts, self.latency.summary(), self.latency.sum

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "frames_submitted": self.submitted,
                "frames_delivered": self.delivered,
                "frames_dropped": self.dropped,
                "frames_failed": self.failed,
                "engine_shed_retries": self.shed_retries,
                "e2e_latency_ms": self.latency.summary(scale=1e3),
            }
        out["fps"] = round(self.fps(), 3)
        return out


class StreamSession:
    """One video stream's ordered pipeline over a ``DynamicBatcher``.

    ::

        session = manager.open("cam0")
        fut = session.submit_frame(frame_bgr)     # Future[TrackedPerson list]
        people = fut.result()                     # in-frame-order delivery
        session.close()

    Built by :class:`SessionManager` (which owns the registry wiring);
    constructing directly is supported for tests.

    Backpressure (``policy``): with ``max_in_flight`` undelivered frames
    outstanding, ``"block"`` makes ``submit_frame`` wait for a slot,
    ``"drop_oldest"`` fails the stalest undelivered frame's future with
    :class:`FrameDropped` and admits the new frame — the new frame's
    engine work still runs; only *delivery* (and the tracker update) of
    the dropped frame is skipped, so the tracker sees a gap exactly
    where the stream skipped.
    """

    def __init__(self, stream_id: str, batcher, *,
                 tracker: Optional[Tracker] = None,
                 smoother: Optional[KeypointSmoother] = None,
                 max_in_flight: int = 4, policy: str = "block",
                 metrics: Optional[StreamMetrics] = None,
                 overload_timeout_s: float = 30.0,
                 fastpath: Optional[FastPathConfig] = None,
                 on_close: Optional[Callable[["StreamSession"], None]]
                 = None):
        if policy not in ("block", "drop_oldest"):
            raise ValueError(f"policy={policy!r} must be 'block' or "
                             "'drop_oldest'")
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight={max_in_flight} must be >= 1")
        self.stream_id = str(stream_id)
        self.batcher = batcher
        self.tracker = tracker if tracker is not None else Tracker()
        self.smoother = smoother
        # temporal-coherence fast path (stream.fastpath): per-session
        # policy state — tier decisions ride the submit ordering below,
        # outcome observations ride the deliver lock
        self.fastpath = (FastPath(fastpath) if fastpath is not None
                         else None)
        self.max_in_flight = int(max_in_flight)
        self.policy = policy
        self.metrics = metrics or StreamMetrics()
        self.overload_timeout_s = float(overload_timeout_s)
        self._on_close = on_close
        self._cond = threading.Condition()
        self._pending: "deque[_Frame]" = deque()   # submit order
        self._deliver_lock = threading.Lock()      # serializes delivery
        self._seq = 0
        # futures handed out whose result/exception is not yet set —
        # what close() drains on (NOT _pending: a frame is popped from
        # the deque BEFORE its future resolves, so waiting on the deque
        # alone would let close return a beat ahead of the last result)
        self._unresolved = 0
        self._closed = False
        self._track = f"stream/{self.stream_id}"   # Perfetto lane

    # ------------------------------------------------------------ submit
    @property
    def in_flight(self) -> int:
        """Undelivered, undropped frames currently in the pipeline."""
        with self._cond:
            return self._depth_locked()

    def _depth_locked(self) -> int:
        return sum(1 for f in self._pending if not f.dropped)

    @property
    def closed(self) -> bool:
        return self._closed

    def submit_frame(self, image_bgr: np.ndarray) -> Future:
        """Enqueue one frame; returns a future resolving to this frame's
        ``list[TrackedPerson]`` — futures resolve strictly in submit
        order per session.

        :raises RuntimeError: the session is closed (including a
            ``block``-policy submit unblocked by a concurrent close).
        """
        trace = get_tracer()
        with self._cond:
            if self._closed:
                raise RuntimeError(
                    f"stream session {self.stream_id!r} is closed")
            if self.policy == "block":
                while (self._depth_locked() >= self.max_in_flight
                       and not self._closed):
                    self._cond.wait()
                if self._closed:
                    raise RuntimeError(
                        f"stream session {self.stream_id!r} closed while "
                        "blocked on backpressure")
            else:
                while self._depth_locked() >= self.max_in_flight:
                    self._drop_oldest_locked(trace)
            frame = _Frame(self._seq, time.perf_counter(),
                           trace.now() if trace.enabled else 0.0,
                           image_bgr)
            if self.fastpath is not None:
                # decided UNDER _cond so decisions are strictly in
                # submit (= delivery) order
                decision = self.fastpath.decide(image_bgr.shape[0],
                                                image_bgr.shape[1])
                frame.tier = decision.tier
            self._seq += 1
            self._pending.append(frame)
            self._unresolved += 1
        self.metrics.on_submit()
        if self.fastpath is not None:
            self.fastpath.metrics.on_submit(decision.tier,
                                            decision.reason)
        rt = get_reqtrace()
        if rt.enabled:
            extra = {} if frame.tier is None else {"tier": frame.tier}
            frame.ctx = rt.begin("stream", stream=self.stream_id,
                                 seq=frame.seq, **extra)
        if frame.tier == "tracker":
            # the tracker tier never touches the engine: the frame is
            # ready NOW; _advance delivers it in order and the tracker's
            # constant-velocity prediction answers it at delivery time
            self._ready_with(frame)
            return frame.future
        if frame.tier == "roi":
            # width-only crop (see stream.fastpath: the scale protocol
            # renormalizes height, so width is the one cheap dimension),
            # anchored so the fixed window is fully image-backed.  The
            # CROP becomes the frame's retained image — a migration
            # re-submits the crop, keeping paste-back exact.
            x0 = decision.roi_x0
            crop = np.ascontiguousarray(
                image_bgr[:, x0:x0 + self.fastpath.config.roi_width])
            frame.roi_off = (x0, 0)
            with self._cond:
                if not frame.dropped:
                    frame.image = crop
            self._submit_to_engine(frame, crop)
            return frame.future
        self._submit_to_engine(frame, image_bgr)
        return frame.future

    def _drop_oldest_locked(self, trace) -> None:
        """Fail the stalest undelivered frame (policy drop_oldest).
        Caller holds ``_cond`` — which is what makes marking even a
        ready-but-undelivered head safe: ``_advance`` pops under the
        same lock and discards dropped frames."""
        for f in self._pending:
            if not f.dropped:
                victim = f
                break
        else:
            return
        victim.dropped = True
        victim.image = None
        victim.ctx.finish("error:FrameDropped")
        self.metrics.on_drop()
        if self.fastpath is not None and victim.tier is not None:
            self.fastpath.metrics.on_drop(victim.tier)
        if trace.enabled:
            trace.instant("frame_dropped", track=self._track,
                          args={"stream": self.stream_id,
                                "seq": victim.seq})
        self._fail_future(victim, FrameDropped(
            f"stream {self.stream_id!r} frame {victim.seq} dropped "
            f"(drop_oldest backpressure, max_in_flight="
            f"{self.max_in_flight})"))
        self._unresolved -= 1       # caller holds _cond (re-entrant)
        self._cond.notify_all()

    def _submit_to_engine(self, frame: _Frame, image_bgr,
                          epoch: int = 0) -> None:
        """Hand the frame to the engine (batcher or pool); bounded
        jittered-backoff retry on load-shed (``serve.policy`` is the one
        retry discipline).  Admission failure is delivered ON the
        frame's future (in order), so a pipelined producer never loses
        a frame silently.  ``epoch`` tags the engine attempt so a
        migration can supersede it (see :meth:`migrate`)."""
        deadline = time.perf_counter() + self.overload_timeout_s
        attempt = 0
        while True:
            # re-read each attempt: migrate() may swap the engine while
            # this producer is parked in backoff
            engine = self.batcher
            try:
                # epoch 0 is the frame's first engine attempt; a bumped
                # epoch is a MIGRATE edge — the session re-submitted the
                # frame after its replica was fenced (or the admission
                # raced a migrate)
                with frame.ctx.child_scope(
                        "submit" if epoch == 0 else "migrate",
                        f"sheds={attempt}" if attempt else
                        (f"epoch={epoch}" if epoch else None)) as scope:
                    bf = engine.submit(image_bgr)
                frame.attempt_nodes[epoch] = scope.node
                if epoch == 0:
                    frame.t_admit = time.perf_counter()
                break
            except ServerOverloaded as e:
                draining = getattr(self.batcher, "draining", False)
                now = time.perf_counter()
                if draining or now >= deadline:
                    self._ready_with(frame, error=e, epoch=epoch)
                    return
                attempt += 1
                self.metrics.on_shed_retry()
                time.sleep(min(jittered_backoff(attempt, base_s=0.002,
                                                max_s=0.05),
                               max(0.0, deadline - now)))
            except Exception as e:  # noqa: BLE001 — batcher stopped, bad
                # frame: deliver on the future, keep the stream alive
                self._ready_with(frame, error=e, epoch=epoch)
                return
        resubmit_epoch = None
        with self._cond:
            frame.engine_submitted = True
            if (self.batcher is not engine and not frame.ready
                    and not frame.dropped):
                # a migrate() ran while this admission was in flight:
                # it skipped the frame (engine_submitted was still
                # False), so the attempt just placed on the OLD engine
                # must be superseded HERE — bump the epoch (the old
                # attempt's errors become stale) and re-submit on the
                # engine the stream migrated to
                frame.epoch += 1
                resubmit_epoch = frame.epoch
        bf.add_done_callback(
            lambda f, frame=frame, epoch=epoch:
            self._on_engine_done(frame, f, epoch))
        if resubmit_epoch is not None:
            self._submit_to_engine(frame, image_bgr, resubmit_epoch)

    # --------------------------------------------------------- migration
    def migrate(self, engine, _trace_kind: str = "migrated") -> int:
        """Rebind this stream to a new engine (a healthy replica or the
        pool itself) and RE-SUBMIT every in-flight frame that is still
        waiting on the old one.  In-order delivery is preserved by
        construction: the pending deque is the delivery order, and a
        re-submitted frame simply resolves from its new engine future —
        ``_advance`` never delivers a frame before its predecessors
        regardless of which engine (or which attempt) resolved it.

        The two halves of the machinery are the ones the repo already
        trusts: the fenced engine's bounded drain completes every OLD
        future (its late errors are discarded as stale epochs), and the
        session's unresolved-futures accounting keeps ``close()`` exact
        across the swap.  Returns the number of frames re-submitted.
        """
        trace = get_tracer()
        with self._cond:
            self.batcher = engine
            victims = []
            for f in self._pending:
                if (f.dropped or f.ready or not f.engine_submitted
                        or f.image is None):
                    continue
                f.epoch += 1
                victims.append((f, f.image, f.epoch))
        if trace.enabled:
            trace.instant("session_migrated", track=self._track,
                          args={"stream": self.stream_id,
                                "resubmitted": len(victims),
                                "kind": _trace_kind})
        for f, img, epoch in victims:
            self._submit_to_engine(f, img, epoch)
        return len(victims)

    # ---------------------------------------------------------- delivery
    def _ready_with(self, frame: _Frame, *, result=None,
                    error: Optional[BaseException] = None,
                    epoch: int = 0) -> None:
        """Land one engine outcome on the frame, exactly once, with the
        epoch rule: stale ERRORS (an attempt a migration superseded)
        are discarded — the live attempt owns the frame — while a
        RESULT wins from any epoch."""
        with self._cond:
            if frame.ready:
                return
            if frame.dropped:
                # future already failed at drop time; mark ready so
                # _advance can discard the husk from the deque
                frame.ready = True
                frame.image = None
            else:
                if error is not None and epoch != frame.epoch:
                    return
                frame.result = result
                frame.error = error
                frame.ready = True
                frame.t_ready = time.perf_counter()
                # the accepted attempt owns the frame's outcome — the
                # won_by chain link (a stale attempt's error was
                # discarded above and never becomes the delivering one)
                frame.won_node = frame.attempt_nodes.get(epoch)
                frame.image = None  # no further re-submission possible
        self._advance()

    def _on_engine_done(self, frame: _Frame, bf: Future,
                        epoch: int = 0) -> None:
        try:
            result, error = bf.result(), None
        except BaseException as e:  # noqa: BLE001 — delivered per frame
            result, error = None, e
        self._ready_with(frame, result=result, error=error, epoch=epoch)

    def _advance(self) -> None:
        """Deliver every ready frame at the head of the queue, in order.
        Runs on whatever engine thread completed the head frame; the
        deliver lock serializes sessions' sequential state (tracker,
        smoother) without a per-session thread."""
        with self._deliver_lock:
            while True:
                with self._cond:
                    if not self._pending:
                        self._cond.notify_all()
                        break
                    head = self._pending[0]
                    if head.dropped:
                        # future already failed at drop time; when the
                        # engine result lands late it is discarded here
                        if head.ready:
                            self._pending.popleft()
                            continue
                        # not ready yet: nothing older can deliver, and
                        # delivery order must wait for the engine slot
                        break
                    if not head.ready:
                        break
                    self._pending.popleft()
                    self._cond.notify_all()
                self._deliver(head)

    def _frame_resolved(self) -> None:
        """One handed-out future settled (result or exception) — the
        close() drain condition advances."""
        with self._cond:
            self._unresolved -= 1
            self._cond.notify_all()

    def _frame_hops(self, frame: _Frame, t_fin: float):
        """The frame node's hop bookends: ``admit`` (first engine
        admission, incl. shed backoff) and ``deliver`` (engine outcome
        → in-order delivery: head-of-line wait + tracker/smoother
        update).  The engine attempt's own span covers the middle."""
        hops = []
        if frame.t_admit is not None:
            hops.append(("admit", frame.t_admit - frame.t_submit))
        if frame.t_ready is not None:
            hops.append(("deliver", t_fin - frame.t_ready))
        return hops

    def _deliver(self, frame: _Frame) -> None:
        trace = get_tracer()
        if frame.error is not None:
            self.metrics.on_fail()
            if self.fastpath is not None and frame.tier is not None:
                self.fastpath.metrics.on_fail(frame.tier)
                self.fastpath.on_failed(frame.tier)
            if trace.enabled:
                trace.instant("frame_failed", track=self._track,
                              args={"stream": self.stream_id,
                                    "seq": frame.seq})
            frame.ctx.finish(
                f"error:{type(frame.error).__name__}",
                hops=self._frame_hops(frame, time.perf_counter()),
                won_by=frame.won_node)
            self._fail_future(frame, frame.error)
            self._frame_resolved()
            return
        try:
            t_track = trace.now() if trace.enabled else 0.0
            if frame.tier == "tracker":
                # skipped frame: the tracker's constant-velocity state
                # answers — no engine result exists
                tracked = self.tracker.predict_frame()
                self.fastpath.on_delivered("tracker", None, self.tracker)
            else:
                skeletons, signals = split_result(frame.result)
                if frame.roi_off is not None:
                    skeletons = paste_back(skeletons, frame.roi_off)
                tracked = self.tracker.update(skeletons)
                if self.fastpath is not None:
                    if signals is None:
                        signals = signals_from_people(skeletons)
                    self.fastpath.on_delivered(frame.tier or "full",
                                               signals, self.tracker)
            if self.smoother is not None:
                tracked = [
                    p._replace(keypoints=self.smoother.apply(
                        p.track_id, p.keypoints, frame.seq))
                    for p in tracked]
                self.smoother.retain(self.tracker.live_ids())
            if trace.enabled:
                now = trace.now()
                trace.add_span_rel(
                    "frame", frame.tr0, now - frame.tr0,
                    track=self._track,
                    args={"stream": self.stream_id, "seq": frame.seq,
                          "people": len(tracked)})
                trace.add_span_rel(
                    "track_update", t_track, now - t_track,
                    track=self._track,
                    args={"stream": self.stream_id,
                          "active": self.tracker.active})
        except Exception as e:  # noqa: BLE001 — a tracker bug fails ITS
            # frame, never the delivery loop or later frames
            self.metrics.on_fail()
            if self.fastpath is not None and frame.tier is not None:
                self.fastpath.metrics.on_fail(frame.tier)
                self.fastpath.on_failed(frame.tier)
            frame.ctx.finish(
                f"error:{type(e).__name__}",
                hops=self._frame_hops(frame, time.perf_counter()),
                won_by=frame.won_node)
            self._fail_future(frame, e)
            self._frame_resolved()
            return
        t_fin = time.perf_counter()
        frame.ctx.finish("ok", hops=self._frame_hops(frame, t_fin),
                         won_by=frame.won_node)
        self.metrics.on_deliver(time.perf_counter() - frame.t_submit)
        if self.fastpath is not None and frame.tier is not None:
            self.fastpath.metrics.on_answer(frame.tier,
                                            t_fin - frame.t_submit)
        try:
            frame.future.set_result(tracked)
        except Exception:  # noqa: BLE001 — caller cancelled the future;
            # the work still completed and is accounted
            pass
        self._frame_resolved()

    @staticmethod
    def _fail_future(frame: _Frame, error: BaseException) -> None:
        try:
            frame.future.set_exception(error)
        except Exception:  # noqa: BLE001 — future cancelled by caller
            pass

    # ------------------------------------------------------------- close
    def close(self, timeout_s: Optional[float] = None) -> bool:
        """Stop accepting frames and wait for every in-flight frame to
        deliver; returns True when fully drained.

        Composes with the batcher's drain: the batcher completes every
        submitted future (result, drain-deadline error, or stop error),
        each completion advances this session, so the wait below always
        terminates when the batcher's does.  Idempotent.
        """
        with self._cond:
            self._closed = True
            self._cond.notify_all()      # unblock block-policy submitters
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        with self._cond:
            while self._unresolved > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                self._cond.wait(timeout=remaining)
            drained = self._unresolved == 0
        cb, self._on_close = self._on_close, None
        if cb is not None:
            cb(self)
        return drained

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- readout
    def snapshot(self) -> dict:
        out = self.metrics.snapshot()
        out["in_flight"] = self.in_flight
        out["closed"] = self._closed
        out["tracker"] = self.tracker.snapshot()
        if self.fastpath is not None:
            out["fastpath"] = self.fastpath.snapshot()
        return out


class SessionManager:
    """Factory + registry wiring for the streams of ONE batcher.

    ::

        with SessionManager(batcher, registry=reg) as mgr:
            cams = [mgr.open(f"cam{i}") for i in range(4)]
            ... cams[0].submit_frame(img) ...
        # exit closes every session (each drains its in-flight frames)

    Exports per-stream signals through a scrape-time collector on the
    shared ``obs.Registry`` (one ``/metrics`` endpoint for serve, train
    and streams): frame counters, drop/failure counters, track churn,
    live FPS and e2e latency quantiles, all labeled ``{stream=...}``.
    The collector holds only a weakref — a process-global registry must
    not pin closed managers (the ``ServeMetrics.register_into``
    discipline).  Register ONE manager per registry: the manager-level
    totals (``stream_all_*``, ``stream_sessions_*``) are unlabeled, so
    two managers on one registry would emit duplicate series.
    """

    def __init__(self, batcher, *, registry=None,
                 tracker_factory: Optional[Callable[[], Tracker]] = None,
                 smoothing: Optional[str] = None,
                 smoother_kw: Optional[dict] = None,
                 max_in_flight: int = 4, policy: str = "block",
                 overload_timeout_s: float = 30.0,
                 fastpath: Optional[FastPathConfig] = None):
        self.batcher = batcher
        self._tracker_factory = tracker_factory or Tracker
        self._smoothing = smoothing
        self._smoother_kw = dict(smoother_kw or {})
        if smoothing is not None:
            # validate the knobs once at manager construction, not at
            # first open() deep inside serving traffic
            KeypointSmoother(mode=smoothing, **self._smoother_kw)
        self.max_in_flight = max_in_flight
        self.policy = policy
        self.overload_timeout_s = overload_timeout_s
        #: the temporal-coherence fast path every opened session runs
        #: (None = every frame is a full forward, the pre-fast-path
        #: behavior); per-session FastPath STATE is built per open()
        self.fastpath = fastpath
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}
        self._auto_id = 0
        self._opened = 0
        self._closed = 0
        # closed sessions' final counts, folded in at close time so a
        # scrape after stream churn keeps monotone totals (per-stream
        # labeled series end with their stream, Prometheus-style)
        self._retired = {"frames_submitted": 0, "frames_delivered": 0,
                         "frames_dropped": 0, "frames_failed": 0,
                         "engine_shed_retries": 0,
                         "track_births": 0, "track_deaths": 0,
                         "fastpath_submitted": 0,
                         "fastpath_answered_tracker": 0,
                         "fastpath_answered_roi": 0,
                         "fastpath_escalated_full": 0,
                         "fastpath_failed": 0, "fastpath_dropped": 0}
        self._retired_esc = {r: 0 for r in FASTPATH_REASONS}
        if registry is not None:
            import weakref

            ref = weakref.ref(self)

            def _collect():
                m = ref()
                return m.collect() if m is not None else []

            registry.register_collector(_collect)

    # ------------------------------------------------------------ open
    def open(self, stream_id: Optional[str] = None, *,
             max_in_flight: Optional[int] = None,
             policy: Optional[str] = None,
             tracker: Optional[Tracker] = None,
             smoother: Optional[KeypointSmoother] = None,
             fastpath: Optional[FastPathConfig] = None
             ) -> StreamSession:
        """Open one stream session (auto-named ``stream-N`` when no id
        is given); per-stream overrides win over manager defaults."""
        with self._lock:
            if stream_id is None:
                stream_id = f"stream-{self._auto_id}"
                self._auto_id += 1
            stream_id = str(stream_id)
            if stream_id in self._sessions:
                raise ValueError(
                    f"stream id {stream_id!r} already open")
            if smoother is None and self._smoothing is not None:
                smoother = KeypointSmoother(mode=self._smoothing,
                                            **self._smoother_kw)
            session = StreamSession(
                stream_id, self.batcher,
                tracker=(tracker if tracker is not None
                         else self._tracker_factory()),
                smoother=smoother,
                max_in_flight=(max_in_flight if max_in_flight is not None
                               else self.max_in_flight),
                policy=policy if policy is not None else self.policy,
                overload_timeout_s=self.overload_timeout_s,
                fastpath=(fastpath if fastpath is not None
                          else self.fastpath),
                on_close=self._forget)
            self._sessions[stream_id] = session
            self._opened += 1
            return session

    def _forget(self, session: StreamSession) -> None:
        m = session.metrics
        counts, _, _ = m.sample()
        tr = session.tracker
        fp_counts, fp_esc = (), {}
        if session.fastpath is not None:
            fp_counts, fp_esc, _, _ = session.fastpath.metrics.sample()
        with self._lock:
            cur = self._sessions.get(session.stream_id)
            if cur is session:
                del self._sessions[session.stream_id]
                self._closed += 1
                for name, v in counts:
                    self._retired[name] += v
                self._retired["track_births"] += tr.births
                self._retired["track_deaths"] += tr.deaths
                for name, v in fp_counts:
                    self._retired[name] += v
                for reason, v in fp_esc.items():
                    self._retired_esc[reason] = (
                        self._retired_esc.get(reason, 0) + v)

    def get(self, stream_id: str) -> Optional[StreamSession]:
        with self._lock:
            return self._sessions.get(str(stream_id))

    # --------------------------------------------------------- migration
    def migrate(self, engine) -> int:
        """Move every live session (and the manager default) onto a new
        engine — the fleet-level half of replica failover: when a
        router fences the replica these streams were bound to, the
        manager rebinds them to a healthy one and each session
        re-submits its in-flight frames with delivery order preserved
        (see :meth:`StreamSession.migrate`).  Sessions opened from here
        on land on the new engine.  Returns total frames re-submitted.
        """
        with self._lock:
            self.batcher = engine
            sessions = list(self._sessions.values())
        return sum(s.migrate(engine) for s in sessions)

    @property
    def sessions(self) -> List[StreamSession]:
        with self._lock:
            return list(self._sessions.values())

    # ------------------------------------------------------------ close
    def close_all(self, timeout_s: Optional[float] = None) -> bool:
        """Close every open session; returns True when all drained.
        ``timeout_s`` bounds the WHOLE drain (one shared deadline — a
        per-session split recomputed against the shrinking live count
        would let the total overshoot the caller's bound)."""
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        drained = True
        for session in self.sessions:
            per = None
            if deadline is not None:
                per = max(0.0, deadline - time.perf_counter())
            drained = session.close(timeout_s=per) and drained
        return drained

    def __enter__(self) -> "SessionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close_all()

    # --------------------------------------------------------- telemetry
    def collect(self, prefix: str = "stream"):
        """(name, labels, kind, value) samples for ``obs.Registry`` —
        every open stream's signals labeled by stream id, plus monotone
        manager totals that fold in CLOSED sessions (stream churn must
        not un-count delivered work)."""
        with self._lock:
            # ONE lock acquisition for the retired totals AND the live
            # list: a session closing between two reads would fold its
            # counts into _retired after we snapshotted it, and the
            # monotone stream_all_* totals would step backwards
            retired = dict(self._retired)
            retired_esc = dict(self._retired_esc)
            opened, closed = self._opened, self._closed
            live = list(self._sessions.values())
        samples = [
            (f"{prefix}_sessions_opened_total", {}, "counter",
             float(opened)),
            (f"{prefix}_sessions_closed_total", {}, "counter",
             float(closed)),
        ]
        totals = dict(retired)
        esc_totals = dict(retired_esc)
        for session in live:
            counts, _, _ = session.metrics.sample()
            for name, v in counts:
                totals[name] += v
            totals["track_births"] += session.tracker.births
            totals["track_deaths"] += session.tracker.deaths
            if session.fastpath is not None:
                fp_counts, fp_esc, _, _ = session.fastpath.metrics.sample()
                for name, v in fp_counts:
                    totals[name] += v
                for reason, v in fp_esc.items():
                    esc_totals[reason] = esc_totals.get(reason, 0) + v
        for name, v in totals.items():
            samples.append((f"{prefix}_all_{name}_total", {}, "counter",
                            float(v)))
        for reason, v in sorted(esc_totals.items()):
            samples.append((f"{prefix}_all_fastpath_escalations_total",
                            {"reason": reason}, "counter", float(v)))
        for session in live:
            labels = {"stream": session.stream_id}
            m = session.metrics
            counts, lat, lat_sum = m.sample()
            for name, v in counts:
                samples.append((f"{prefix}_{name}_total", labels,
                                "counter", float(v)))
            if session.fastpath is not None:
                fp_counts, fp_esc, fp_lat, fp_depth = (
                    session.fastpath.metrics.sample())
                for name, v in fp_counts:
                    samples.append((f"{prefix}_{name}_total", labels,
                                    "counter", float(v)))
                for reason, v in sorted(fp_esc.items()):
                    samples.append(
                        (f"{prefix}_fastpath_escalations_total",
                         {**labels, "reason": reason}, "counter",
                         float(v)))
                samples.append((f"{prefix}_fastpath_depth", labels,
                                "gauge", float(fp_depth)))
                # the per-hop latency block, one entry per TIER
                for tier in TIERS:
                    tl, tl_sum = fp_lat[tier]
                    tlabels = {**labels, "tier": tier}
                    for q, key in (("0.5", "p50"), ("0.95", "p95"),
                                   ("0.99", "p99")):
                        samples.append(
                            (f"{prefix}_fastpath_tier_latency_seconds",
                             {**tlabels, "quantile": q}, "gauge",
                             tl[key]))
                    samples += [
                        (f"{prefix}_fastpath_tier_latency_seconds_sum",
                         tlabels, "counter", tl_sum),
                        (f"{prefix}_fastpath_tier_latency_seconds_count",
                         tlabels, "counter", float(tl["count"])),
                    ]
            tr = session.tracker
            samples += [
                (f"{prefix}_track_births_total", labels, "counter",
                 float(tr.births)),
                (f"{prefix}_track_deaths_total", labels, "counter",
                 float(tr.deaths)),
                (f"{prefix}_active_tracks", labels, "gauge",
                 float(tr.active)),
                (f"{prefix}_in_flight", labels, "gauge",
                 float(session.in_flight)),
                (f"{prefix}_fps", labels, "gauge", m.fps()),
            ]
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                samples.append((f"{prefix}_e2e_latency_seconds",
                                {**labels, "quantile": q}, "gauge",
                                lat[key]))
            samples += [
                (f"{prefix}_e2e_latency_seconds_sum", labels, "counter",
                 lat_sum),
                (f"{prefix}_e2e_latency_seconds_count", labels, "counter",
                 float(lat["count"])),
            ]
        return samples

    def snapshot(self) -> dict:
        """JSON-ready per-stream snapshot (the bench artifact shape)."""
        return {s.stream_id: s.snapshot() for s in self.sessions}
