"""Two-tier cascade serving: a cheap student lane answers traffic first
and escalates hard frames to the teacher bucket (the port's own copy of
``improved_body_parts_tpu/serve/cascade.py``; ``serve.artifacts
.cascade_predictors`` builds its predictor pair).

The "millions of users" economics lever (ROADMAP open item 2;
"FasterPose", arXiv:2107.03215): most frames are easy, yet a
single-model deployment pays the full stacked-IMHN forward for every
one.  Here a narrow distilled student (``train.distill``,
``canonical_student``) serves ALL traffic, and the fused decode
program's payload — person count, capacity-overflow flags, assembly
scores, all in the same single fetch — decides, for free,
which frames were too hard for the fast tier:

- **student lane**: a :class:`~.batcher.DynamicBatcher` over the student
  predictor with ``device_decode=True, emit_signals=True`` — every
  future resolves to ``(skeletons, EscalationSignals)``;
- **escalation**: when the signals trip the :class:`EscalationPolicy`
  (person count above the threshold, any overflow flag, or the weakest
  person's mean assembly score under the floor), the frame is a SECOND
  submit on the teacher engine — the existing machinery end to end, no
  new dispatch path;
- **degradation**: a teacher that sheds (``ServerOverloaded``) or fails
  delivers the student's answer instead of failing the request — the
  fast tier's result exists and a deliberate quality degrade beats an
  error (counted in ``degraded_student_answer``); only
  ``DeadlineExceeded`` propagates, because the caller already gave up;
- **warmup**: both tiers precompile through the ONE
  ``serve.warmup.precompile`` predictor-set path, so post-warmup
  traffic compiles nothing on either tier.

Per-tier traffic stays separable on a shared registry via the
``ServeMetrics(model="student"/"teacher")`` label dimension;
:class:`CascadeMetrics` adds the routing split
(``answered_student`` / ``escalated_teacher`` / per-reason escalation
counters).
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

from ..obs.reqtrace import NULL_NODE, get_reqtrace
from .batcher import DeadlineExceeded, DynamicBatcher, ServerOverloaded
from .metrics import ServeMetrics

#: escalation reasons, in CHECK ORDER: an overflow invalidates the
#: device assembly entirely (its person count / scores are partial), so
#: it outranks the crowding and score signals
ESCALATION_REASONS = ("overflow", "people", "score")


@dataclass(frozen=True)
class EscalationPolicy:
    """When does a frame leave the fast tier?

    Boundary semantics (pinned by tests): ``n_people == max_people``
    stays on the student — only MORE people escalate;
    ``min_mean_score == score_floor`` stays — only strictly weaker
    people escalate.  ``score_floor = 0`` disables the score signal,
    ``escalate_on_overflow = False`` the overflow one (an overflow then
    still host-fallback-decodes on the student, it just never
    escalates).
    """
    #: escalate when the device assembly found MORE than this many
    #: people (crowds are where the narrow student loses the most AP)
    max_people: int = 4
    #: escalate when the weakest kept person's mean per-part assembly
    #: score is UNDER this floor (0 disables) — low scores mean the
    #: student's heatmaps were ambiguous
    score_floor: float = 0.0
    #: any capacity-overflow flag escalates: the student's assembly was
    #: not authoritative for this frame at all
    escalate_on_overflow: bool = True

    def reason(self, sig) -> Optional[str]:
        """The escalation reason for one frame's signals, or ``None``
        to answer from the student."""
        if self.escalate_on_overflow and (sig.peak_overflow
                                          or sig.cand_overflow
                                          or sig.person_overflow):
            return "overflow"
        if sig.n_people > self.max_people:
            return "people"
        if self.score_floor > 0 and sig.min_mean_score < self.score_floor:
            return "score"
        return None


class CascadeMetrics:
    """Routing accounting for one :class:`CascadeEngine`.

    Conservation (the hammer test's invariant):
    ``submitted == answered_student + escalated_teacher
    + degraded_student_answer + failed + depth``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.answered_student = 0
        self.escalated_teacher = 0
        #: escalation attempted, but the teacher shed/failed and the
        #: student's answer was delivered instead
        self.degraded_student_answer = 0
        self.failed = 0
        self.depth = 0
        self.escalations: Dict[str, int] = {r: 0
                                            for r in ESCALATION_REASONS}

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            self.depth += 1

    def on_escalate(self, reason: str) -> None:
        with self._lock:
            self.escalations[reason] = self.escalations.get(reason, 0) + 1

    def on_answer(self, lane: str) -> None:
        with self._lock:
            if lane == "student":
                self.answered_student += 1
            elif lane == "teacher":
                self.escalated_teacher += 1
            else:
                self.degraded_student_answer += 1
            self.depth -= 1

    def on_fail(self) -> None:
        with self._lock:
            self.failed += 1
            self.depth -= 1

    def escalation_rate(self) -> float:
        """Escalations attempted per completed request (0.0 before any
        completion)."""
        with self._lock:
            done = (self.answered_student + self.escalated_teacher
                    + self.degraded_student_answer)
            esc = self.escalated_teacher + self.degraded_student_answer
        return esc / done if done else 0.0

    def register_into(self, registry, prefix: str = "cascade"
                      ) -> "CascadeMetrics":
        """Scrape-time collector on a shared ``obs.Registry`` — same
        weakref discipline as ``ServeMetrics.register_into``."""
        ref = weakref.ref(self)

        def _collect():
            m = ref()
            return m.collect(prefix) if m is not None else []

        registry.register_collector(_collect)
        return self

    def collect(self, prefix: str = "cascade"):
        with self._lock:
            counts = (("submitted", self.submitted),
                      ("answered_student", self.answered_student),
                      ("escalated_teacher", self.escalated_teacher),
                      ("degraded_student_answer",
                       self.degraded_student_answer),
                      ("failed", self.failed))
            escalations = dict(self.escalations)
            depth = self.depth
        samples = [(f"{prefix}_{name}_total", {}, "counter", float(v))
                   for name, v in counts]
        for reason, n in sorted(escalations.items()):
            samples.append((f"{prefix}_escalations_total",
                            {"reason": reason}, "counter", float(n)))
        samples.append((f"{prefix}_depth", {}, "gauge", float(depth)))
        samples.append((f"{prefix}_escalation_rate", {}, "gauge",
                        self.escalation_rate()))
        return samples

    def conservation(self) -> dict:
        """The per-tier conservation block a benchmark records: every
        counter of the invariant plus ``exact`` — True iff it holds at
        this instant."""
        with self._lock:
            out = {
                "submitted": self.submitted,
                "answered_student": self.answered_student,
                "escalated_teacher": self.escalated_teacher,
                "degraded_student_answer": self.degraded_student_answer,
                "failed": self.failed,
                "depth": self.depth,
            }
        out["exact"] = (out["submitted"]
                        == out["answered_student"]
                        + out["escalated_teacher"]
                        + out["degraded_student_answer"]
                        + out["failed"] + out["depth"])
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "submitted": self.submitted,
                "answered_student": self.answered_student,
                "escalated_teacher": self.escalated_teacher,
                "degraded_student_answer": self.degraded_student_answer,
                "failed": self.failed,
                "depth": self.depth,
                "escalations": dict(self.escalations),
            }
        out["escalation_rate"] = round(self.escalation_rate(), 4)
        return out


class _CascadeRequest:
    """Per-request routing state: the caller-facing future plus the
    absolute deadline the teacher leg inherits."""
    __slots__ = ("image", "future", "deadline", "ctx", "t0",
                 "student_node", "teacher_node", "t_s_submit",
                 "t_s_done", "t_t_submit", "t_t_done")

    def __init__(self, image, deadline_s: Optional[float]):
        self.image = image
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        self.deadline = (None if deadline_s is None
                         else self.t0 + deadline_s)
        self.ctx = NULL_NODE          # reqtrace node (obs.reqtrace)
        self.student_node = None
        self.teacher_node = None
        # hop boundary stamps: route / student_lane / escalate /
        # deliver bookends around the tiers' own spans
        self.t_s_submit: Optional[float] = None
        self.t_s_done: Optional[float] = None
        self.t_t_submit: Optional[float] = None
        self.t_t_done: Optional[float] = None


class CascadeEngine:
    """Student-first serving with on-device escalation signals.

    ::

        with CascadeEngine.build(student_pred, teacher_pred,
                                 policy=EscalationPolicy(max_people=4)
                                 ) as cascade:
            cascade.warmup([(512, 512)])      # BOTH tiers precompile
            skeletons = cascade.submit(image).result()

    The student engine must run the fused device-decode lane with
    ``emit_signals=True`` (that payload IS the escalation input); the
    teacher may be any engine with the ``submit``/``start``/``stop``
    contract — a plain :class:`~.batcher.DynamicBatcher` or an
    ``EnginePool`` replica set.  Admission backpressure is the
    student's: a shed at the fast tier is the caller's retry signal
    (``ServerOverloaded``), exactly as for a single-engine deployment.
    """

    def __init__(self, student: DynamicBatcher, teacher,
                 policy: Optional[EscalationPolicy] = None,
                 metrics: Optional[CascadeMetrics] = None,
                 registry=None):
        if not getattr(student, "emit_signals", False):
            raise ValueError(
                "the cascade's student engine must be built with "
                "emit_signals=True (the escalation decision consumes "
                "the fused decode payload's signals)")
        if getattr(teacher, "emit_signals", False):
            raise ValueError(
                "the teacher engine must not emit_signals: its results "
                "are delivered to callers as-is")
        self.student = student
        self.teacher = teacher
        self.policy = policy or EscalationPolicy()
        self.metrics = metrics or CascadeMetrics()
        if registry is not None:
            self.metrics.register_into(registry)
        self._draining = False

    # ---------------------------------------------------------- builders
    @classmethod
    def build(cls, student_predictor, teacher_predictor, *,
              policy: Optional[EscalationPolicy] = None, registry=None,
              max_batch: int = 8, max_wait_ms: float = 25.0,
              max_queue: int = 64, decode_workers: int = 2,
              use_native: bool = True, eager_idle_flush: bool = True,
              student_devices: Optional[Sequence] = None,
              teacher_devices: Optional[Sequence] = None
              ) -> "CascadeEngine":
        """Construct both tiers with the standard wiring: fused
        device-decode lanes, per-tier ``ServeMetrics`` labeled
        ``{model="student"/"teacher"}`` on the shared registry, signal
        emission on the student only."""
        student = DynamicBatcher(
            student_predictor, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            decode_workers=decode_workers, use_native=use_native,
            eager_idle_flush=eager_idle_flush, devices=student_devices,
            metrics=ServeMetrics(model="student"), registry=registry,
            device_decode=True, emit_signals=True)
        teacher = DynamicBatcher(
            teacher_predictor, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            decode_workers=decode_workers, use_native=use_native,
            eager_idle_flush=eager_idle_flush, devices=teacher_devices,
            metrics=ServeMetrics(model="teacher"), registry=registry,
            device_decode=True)
        return cls(student, teacher, policy=policy, registry=registry)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "CascadeEngine":
        self._draining = False
        self.student.start()
        self.teacher.start()
        return self

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Drain both tiers: cascade admission closes, then the student
        drains FIRST (its completions may still escalate) and the
        teacher after it, both against one shared deadline."""
        self._draining = True
        deadline = (None if drain_timeout_s is None
                    else time.perf_counter() + drain_timeout_s)

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(0.0, deadline - time.perf_counter())

        self.student.stop(remaining())
        self.teacher.stop(remaining())

    def __enter__(self) -> "CascadeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def draining(self) -> bool:
        return self._draining

    # ------------------------------------------------------------- warmup
    def warmup(self, image_sizes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> dict:
        """Precompile BOTH tiers' bucket programs (each through the
        shared ``serve.warmup.precompile`` predictor-set path) so no
        post-warmup request — answered or escalated — ever hits a
        compile stall.  ``newly_compiled == 0`` in both summaries means
        the cascade was already fully warm."""
        return {"student": self.student.warmup(image_sizes, batch_sizes),
                "teacher": self.teacher.warmup(image_sizes, batch_sizes)}

    def health(self) -> dict:
        return {"draining": self._draining,
                "student": self.student.health(),
                "teacher": self.teacher.health()}

    # ------------------------------------------------------------- submit
    def submit(self, image_bgr, *,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one BGR image on the student lane; returns a future
        resolving to decoded skeletons from whichever tier answered.

        :raises ServerOverloaded: the student lane shed the request (or
            the cascade is draining) — retry with backoff, as for a
            single engine.
        :raises DeadlineExceeded: ``deadline_s`` already expired at
            submit.
        """
        if self._draining:
            raise ServerOverloaded(
                "cascade is draining (shutdown in progress); retry "
                "against a live instance")
        req = _CascadeRequest(image_bgr, deadline_s)
        rt = get_reqtrace()
        if rt.enabled:
            req.ctx = rt.begin("cascade")
        # student admission FIRST: a shed must not count as submitted
        try:
            with req.ctx.child_scope("submit") as scope:
                sfut = self.student.submit(image_bgr,
                                           deadline_s=deadline_s)
        except BaseException as e:  # noqa: BLE001 — re-raised: a shed
            # opened no request; close the cascade node it did open
            req.ctx.finish(f"error:{type(e).__name__}")
            raise
        req.student_node = scope.node
        req.t_s_submit = time.perf_counter()
        self.metrics.on_submit()
        sfut.add_done_callback(lambda f: self._student_done(f, req))
        return req.future

    # ------------------------------------------------------------ routing
    def _student_done(self, sfut: Future, req: _CascadeRequest) -> None:
        """Runs on the student engine's completion threads: route the
        answer or escalate."""
        req.t_s_done = time.perf_counter()
        try:
            skeletons, signals = sfut.result()
        except BaseException as e:  # noqa: BLE001 — delivered on the future
            self._finish(req, error=e, node=req.student_node)
            return
        reason = self.policy.reason(signals)
        if reason is None:
            self._finish(req, result=skeletons, lane="student",
                         node=req.student_node)
            return
        self.metrics.on_escalate(reason)
        remaining = (None if req.deadline is None
                     else req.deadline - time.perf_counter())
        try:
            # the ESCALATE edge, annotated with WHY the fast tier's
            # answer was not authoritative (people/overflow/score)
            with req.ctx.child_scope("escalate", reason) as scope:
                tfut = self.teacher.submit(req.image,
                                           deadline_s=remaining)
        except DeadlineExceeded as e:
            # the caller's global deadline passed — delivering anything
            # now is pointless, and a retry elsewhere equally so
            self._finish(req, error=e, node=req.student_node)
            return
        except Exception:  # noqa: BLE001 — teacher shed/stopped: degrade
            self._finish(req, result=skeletons, lane="degraded",
                         node=req.student_node)
            return
        req.teacher_node = scope.node
        req.t_t_submit = time.perf_counter()
        tfut.add_done_callback(
            lambda f: self._teacher_done(f, req, skeletons))

    def _teacher_done(self, tfut: Future, req: _CascadeRequest,
                      student_skeletons) -> None:
        req.t_t_done = time.perf_counter()
        try:
            result = tfut.result()
        except DeadlineExceeded as e:
            self._finish(req, error=e, node=req.teacher_node)
            return
        except BaseException:  # noqa: BLE001 — teacher died mid-flight:
            # the student's answer exists; a deliberate quality degrade
            # beats failing a request the fast tier already served
            self._finish(req, result=student_skeletons, lane="degraded",
                         node=req.student_node)
            return
        self._finish(req, result=result, lane="teacher",
                     node=req.teacher_node)

    def _finish(self, req: _CascadeRequest, result=None, error=None,
                lane: Optional[str] = None, node=None) -> None:
        if req.ctx.sampled:
            # cascade-node hops around the delivering tier's span.
            # Escalated requests carry the student_lane GAP hop — the
            # fast tier's full window is real request latency even
            # though the teacher subtree delivered — so the chain's sum
            # stays conservative (≥95% of e2e) on escalations too.
            t_fin = time.perf_counter()
            hops = []
            if req.t_s_submit is not None:
                hops.append(("route", req.t_s_submit - req.t0))
            if node is req.teacher_node and node is not None:
                if req.t_s_done is not None and \
                        req.t_s_submit is not None:
                    hops.append(("student_lane",
                                 req.t_s_done - req.t_s_submit))
                if req.t_t_submit is not None and \
                        req.t_s_done is not None:
                    hops.append(("escalate",
                                 req.t_t_submit - req.t_s_done))
                if req.t_t_done is not None:
                    hops.append(("deliver", t_fin - req.t_t_done))
            elif req.t_s_done is not None:
                hops.append(("deliver", t_fin - req.t_s_done))
            req.ctx.finish(
                "ok" if error is None
                else f"error:{type(error).__name__}",
                hops=hops, won_by=node,
                **({"lane": lane} if lane else {}))
        if error is not None:
            self.metrics.on_fail()
        else:
            self.metrics.on_answer(lane)
        try:
            if error is not None:
                req.future.set_exception(error)
            else:
                req.future.set_result(result)
        except Exception:  # noqa: BLE001 — future cancelled by caller;
            # the routing work still completed and is accounted
            pass
