"""Elastic run supervision (counterpart of
``improved_body_parts_tpu/train/supervisor.py``): survive preemption and
crashes without a human restarting the job.

- **Clean stop** (:meth:`RunSupervisor.install_signal_handlers`):
  SIGTERM/SIGINT request a stop at the next step-window boundary
  (``train.loop`` checks ``should_stop()`` where it already syncs),
  raising :class:`StopRequested` out of the loop, which flushes the
  in-flight checkpoint write and stops the input ring through the usual
  teardown.  A second signal escalates to the default handler.
- **Failure classification on restart**: each training *segment* (one
  process lifetime) is recorded in the run ledger inside ``RUN.json``.  A
  segment that died without closing its record was killed or preempted;
  a recorded error is matched against :data:`TRANSIENT_PATTERNS` (device
  unavailable, connection reset, worker died, out of memory) or else
  counts as a deterministic crash.  Consecutive failures without a new
  committed epoch back off exponentially, and a deterministic crash loop
  exhausts a bounded budget: :class:`SupervisorGaveUp` with the
  evidence, never a tight restart loop.
- **Resume** (:meth:`RunSupervisor.resume`): ``restore_latest`` of the
  checkpoint directory.  The port trains on one process and one card, so
  :func:`reshard_on_topology_change` accepts only that unchanged topology
  and raises ``NotImplementedError`` for any other (ROADMAP.md, multi-card
  training).
- **Observability**: segments carry a logical ``run_id`` and a
  ``segment`` index in ``RUN.json`` and in the event sink's records; a
  short milestone eval (:func:`milestone_eval`) runs on every resume.

:func:`chaos_kill_point` is the deterministic fault-injection seam the
loop and the checkpoint writer call.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ..obs.events import strict_dump

RUN_FILE = "RUN.json"

# substrings marking an infrastructure/transient failure — safe to retry.
# Deliberately conservative: anything unmatched is treated as a
# deterministic crash and bounded by the crash budget.  The JAX package's
# XLA / gRPC words stay; torch and CUDA name the same failures otherwise:
#   XLA RESOURCE_EXHAUSTED (device memory)  ->  torch.OutOfMemoryError
#     "CUDA out of memory. Tried to allocate ...", a CUDA runtime
#     "CUDA error: out of memory", cuBLAS / cuDNN "..._STATUS_ALLOC_FAILED"
#   XLA UNAVAILABLE (device gone)  ->  "CUDA error: CUDA-capable device(s)
#     is/are busy or unavailable" (matched by "UNAVAILABLE")
TRANSIENT_PATTERNS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "ALLOC_FAILED",
    "ABORTED",
    "preempt",
    "socket closed",
    "connection reset",
    "transport is closing",
    "input worker died",          # data.shm_ring worker death (unsupervised)
    "worker failed to start",
    "Broken pipe",
    "barrier",                    # coordination-service timeout
)

# markers from subsystems that already DIAGNOSED determinism; checked
# before TRANSIENT_PATTERNS because such messages routinely embed a
# transient-looking cause (the shm ring's rebuild-budget error quotes
# the WorkerDied text, whose "input worker died" would otherwise match)
DETERMINISTIC_MARKERS = (
    "looks deterministic",        # shm_ring max_rebuilds exhaustion
)


class StopRequested(Exception):
    """A clean stop (SIGTERM/SIGINT) was requested and honoured at a
    step-window boundary.  The in-flight checkpoint is flushed by the
    normal unwind; resume restarts from the last committed epoch."""


class SupervisorGaveUp(RuntimeError):
    """The crash-loop budget or restart bound is exhausted — restarting
    again would burn capacity against a deterministic failure."""


# --------------------------------------------------------------- chaos
_chaos_lock = threading.Lock()
_chaos_state: Optional[list] = None


def chaos_kill_point(point: str) -> None:
    """Deterministic fault-injection seam: ``IBP_CHAOS_KILL=<point>:<n>``
    SIGKILLs this process at the *n*-th hit of the named point.

    Instrumented points: ``window`` (train loop, after a step-window
    readback), ``post_save`` (fit, while the async checkpoint write is
    in flight), ``mid_eval`` (each eval batch), ``mid_ckpt_write``
    (checkpoint writer thread, between the payload write and the commit
    marker).  SIGKILL — not an exception — because the scenario under
    test is a preemption/OOM-kill that runs NO cleanup code.  Costs one
    env lookup when unset.
    """
    spec = os.environ.get("IBP_CHAOS_KILL")
    if not spec:
        return
    global _chaos_state
    with _chaos_lock:
        if _chaos_state is None:
            name, _, count = spec.partition(":")
            _chaos_state = [name, int(count or 1)]
        if point != _chaos_state[0]:
            return
        _chaos_state[1] -= 1
        if _chaos_state[1] > 0:
            return
    os.write(2, f"chaos: SIGKILL at {point}\n".encode())
    os.kill(os.getpid(), signal.SIGKILL)


def classify_error(error: str) -> str:
    """``"transient"`` when the message matches an infrastructure
    pattern, else ``"deterministic"``.  An explicit
    :data:`DETERMINISTIC_MARKERS` diagnosis wins over any transient
    pattern the message happens to quote."""
    low = str(error).lower()
    for marker in DETERMINISTIC_MARKERS:
        if marker.lower() in low:
            return "deterministic"
    for pat in TRANSIENT_PATTERNS:
        if pat.lower() in low:
            return "transient"
    return "deterministic"


def reshard_on_topology_change(meta, path) -> None:
    """The topology check of a just-restored checkpoint (shared by
    :meth:`RunSupervisor.resume` and ``cli.train --resume``).  The port
    trains on one process and one card, so it accepts a checkpoint
    stamped with no other topology and raises ``NotImplementedError`` for
    any other stamp (resharding across cards is not ported: ROADMAP.md,
    queue 1 item 9)."""
    stamped = meta.get("topology")
    if stamped not in (None, {}, {"devices": 1, "processes": 1}):
        raise NotImplementedError(
            f"checkpoint {path}: restoring onto another device topology "
            f"(stamped {stamped}) is not ported yet (ROADMAP.md, queue 1 "
            "item 9: multi-card training)")


def milestone_eval(state, eval_step, batches, mesh=None,
                   max_batches: int = 8) -> float:
    """Bounded eval pass fired on every resume: a few batches through
    the real eval step, so "the restore works" is a loss in the log and
    the event stream, not an assumption."""
    from itertools import islice

    from .loop import eval_epoch

    return eval_epoch(state, eval_step, islice(iter(batches),
                                               max(1, int(max_batches))),
                      mesh=mesh)


class RunSupervisor:
    """Owns the fit lifecycle across segments of one logical run.

    ::

        sup = RunSupervisor(ckpt_dir)
        sup.open_segment()                  # classify last exit, back off
        sup.install_signal_handlers()
        sup.bind(None)                      # segment_start -> event sink
        resumed = sup.resume(state)         # restore_latest
        try:
            fit(..., should_stop=sup.should_stop)
            sup.mark_completed()
        except StopRequested:
            sup.close_segment("preempted")
        except Exception as e:
            if sup.on_failure(e) != "retry":
                raise                       # deterministic — recorded

    The ledger lives inside ``RUN.json`` next to the checkpoints (merged
    with the manifest ``cli.train`` writes): ``run_id``, the
    ``segments`` list, and the consecutive-failure counter — everything
    classification needs survives the process.
    """

    def __init__(self, checkpoint_dir: str, *, max_restarts: int = 24,
                 crash_budget: int = 3, backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 sleep: Callable[[float], None] = time.sleep,
                 log_fn: Callable[[str], None] = print):
        self.directory = os.path.abspath(checkpoint_dir)
        self.max_restarts = int(max_restarts)
        self.crash_budget = int(crash_budget)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._sleep = sleep
        self._log = log_fn
        self._stop_event = threading.Event()
        self._state = "starting"
        self._lock = threading.Lock()
        self._ledger = self._load()
        self.run_id = self._ledger.setdefault(
            "run_id", f"run-{uuid.uuid4().hex[:12]}")
        self.segment = len(self._ledger.setdefault("segments", []))
        self._classification = "fresh"
        self._backoff_s = 0.0
        self._prev_handlers: Dict[int, Any] = {}
        # in-process retry accounting (on_failure): attempts since the
        # last committed-epoch advance
        self._attempts_without_progress = 0
        self._epoch_at_attempt_start = self._committed_epoch()

    # ------------------------------------------------------------ ledger
    def _run_path(self) -> str:
        return os.path.join(self.directory, RUN_FILE)

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self._run_path()) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, json.JSONDecodeError):
            return {}

    def _persist(self) -> None:
        """Atomic merge-write of the ledger into RUN.json."""
        os.makedirs(self.directory, exist_ok=True)
        path = self._run_path()
        # re-merge on-disk manifest fields a co-writer (cli.train)
        # may have added since we loaded
        on_disk = self._load()
        on_disk.update(self._ledger)
        self._ledger = on_disk
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # the ledger records crash evidence (classified errors, loss
            # fields from resume evals) — strict emission keeps it
            # parseable exactly when a run diverged (graftlint JGL004)
            strict_dump(self._ledger, f, indent=2, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def update_manifest(self, fields: Dict[str, Any]) -> None:
        """Merge manifest fields (tool, argv, telemetry paths...) into
        RUN.json without clobbering the ledger."""
        self._ledger.update(fields)
        self._persist()

    def _committed_epoch(self) -> int:
        """Epoch of the newest committed checkpoint, or -1."""
        from .checkpoint import latest_checkpoint, read_commit_meta

        path = latest_checkpoint(self.directory)
        if path is None:
            return -1
        meta = read_commit_meta(path)
        if meta and isinstance(meta.get("epoch"), int):
            return meta["epoch"]
        try:  # legacy (marker-less) checkpoint: epoch from the dir name
            return int(os.path.basename(path).split("_")[1])
        except (IndexError, ValueError):
            return -1

    # ----------------------------------------------------------- segment
    def open_segment(self, meta: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Classify how the previous segment ended, enforce the restart
        bounds, back off if warranted, and register this segment.

        Returns the new segment record.  Raises :class:`SupervisorGaveUp`
        when the crash budget / restart bound is exhausted.
        """
        segments = self._ledger["segments"]
        prev = segments[-1] if segments else None
        committed = self._committed_epoch()
        failures = int(self._ledger.get("consecutive_failures", 0))
        if prev is None:
            self._classification = "fresh"
            failures = 0
        elif prev.get("status") == "completed":
            self._classification = "complete"
            failures = 0
        elif prev.get("status") == "preempted":
            # clean SIGTERM stop — the expected spot-capacity exit
            self._classification = "preemption"
            failures = 0
        elif prev.get("status") == "running":
            # died without closing its record: hard kill / preemption
            # without grace / OOM-killer — infrastructure, retryable
            self._classification = "killed"
            progressed = committed > prev.get("epoch_committed", -1)
            failures = 0 if progressed else failures + 1
        else:  # "crashed" with a recorded error
            self._classification = classify_error(prev.get("error", ""))
            progressed = committed > prev.get("epoch_committed", -1)
            failures = 0 if progressed else failures + 1

        if len(segments) >= self.max_restarts:
            raise SupervisorGaveUp(
                f"{len(segments)} segments already ran for run "
                f"{self.run_id} (max_restarts={self.max_restarts}); "
                f"last committed epoch {committed}. Inspect "
                f"{self._run_path()} and restart with a fresh ledger "
                "if this is intended.")
        if self._classification == "deterministic" \
                and failures >= self.crash_budget:
            raise SupervisorGaveUp(
                f"run {self.run_id} crashed {failures} consecutive "
                f"times without committing a new epoch (budget "
                f"{self.crash_budget}); last error: "
                f"{prev.get('error', '?')!r}. This looks deterministic — "
                "fix the crash before restarting (ledger: "
                f"{self._run_path()}).")

        # exponential backoff on consecutive no-progress failures; a
        # clean preemption restarts immediately (the capacity came back)
        self._backoff_s = 0.0
        if failures > 0:
            self._backoff_s = min(
                self.backoff_base_s * (2.0 ** (failures - 1)),
                self.backoff_max_s)
        self._ledger["consecutive_failures"] = failures
        record = {
            "segment": self.segment,
            "status": "running",
            "pid": os.getpid(),
            "time_unix": round(time.time(), 3),
            "previous_end": self._classification,
            "epoch_committed": committed,
            "backoff_s": round(self._backoff_s, 3),
        }
        record.update(meta or {})
        segments.append(record)
        self._persist()
        if self._backoff_s > 0:
            self._state = "backing-off"
            self._log(f"supervisor: {self._classification} exit, "
                      f"{failures} consecutive no-progress failure(s) — "
                      f"backing off {self._backoff_s:.1f}s")
            self._sleep(self._backoff_s)
        self._state = "running"
        self._epoch_at_attempt_start = committed
        return record

    def _segment_record(self) -> Optional[Dict[str, Any]]:
        segments = self._ledger.get("segments") or []
        for rec in reversed(segments):
            if rec.get("segment") == self.segment:
                return rec
        return None

    def close_segment(self, status: str, reason: Optional[str] = None
                      ) -> None:
        """Persist how this segment ended (``completed`` / ``preempted``
        / ``crashed``) plus the leak evidence the chaos harness asserts
        on: the names of still-live non-main threads."""
        rec = self._segment_record()
        if rec is None:
            return
        rec["status"] = status
        rec["end_unix"] = round(time.time(), 3)
        rec["epoch_committed"] = self._committed_epoch()
        if reason:
            rec["error" if status == "crashed" else "reason"] = \
                str(reason)[:2000]
        live = sorted(t.name for t in threading.enumerate()
                      if t is not threading.main_thread())
        if status in ("completed", "preempted"):
            self._ledger["consecutive_failures"] = 0
        self._persist()
        self._state = "stopped"
        self._emit("segment_end", status=status,
                   epoch_committed=rec["epoch_committed"],
                   live_threads=live,
                   **({"reason": str(reason)[:500]} if reason else {}))

    def mark_completed(self) -> None:
        self.close_segment("completed")

    # ----------------------------------------------------------- signals
    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → request a clean stop at the next step-window
        boundary; a second signal escalates to the default disposition
        (a wedged run must still be killable)."""
        def handler(signum, frame):
            if self._stop_event.is_set():
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
                return
            self._stop_event.set()
            self._state = "draining"
            # async-signal context: no locks, no allocation-heavy work
            os.write(2, b"supervisor: stop requested (draining to the "
                        b"next step-window boundary; signal again to "
                        b"force)\n")

        for signum in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[signum] = signal.signal(signum, handler)

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers.clear()

    def request_stop(self) -> None:
        """Programmatic stop request (tests; embedding runners)."""
        self._stop_event.set()
        self._state = "draining"

    def should_stop(self) -> bool:
        """The train loop's stop-point predicate (checked at window
        boundaries and between epochs)."""
        return self._stop_event.is_set()

    # ------------------------------------------------------------ health
    def state(self) -> str:
        return self._state

    def state_dict(self) -> Dict[str, Any]:
        """The ``/healthz`` view: supervisor state + run identity."""
        return {"state": self._state, "run_id": self.run_id,
                "segment": self.segment,
                "previous_end": self._classification,
                "consecutive_failures":
                    int(self._ledger.get("consecutive_failures", 0))}

    def bind(self, telemetry) -> None:
        """Record the segment start in the event stream; a telemetry
        bundle with a health sentinel (``telemetry.health``) also gets the
        supervisor state in its ``/healthz`` body."""
        if telemetry is not None:
            telemetry.health.set_extra("supervisor", self.state_dict)
        self._emit("segment_start", previous_end=self._classification,
                   backoff_s=round(self._backoff_s, 3),
                   epoch_committed=self._epoch_at_attempt_start)

    def _emit(self, event: str, **fields) -> None:
        from ..obs.events import get_sink

        get_sink().emit(event, run_id=self.run_id, segment=self.segment,
                        **fields)

    # ------------------------------------------------------------ resume
    def resume(self, state_template):
        """``restore_latest`` of the checkpoint directory into
        ``state_template`` + the topology check
        (:func:`reshard_on_topology_change`).  Returns ``(state, meta)``,
        or None when nothing is restorable."""
        from .checkpoint import latest_checkpoint, restore_checkpoint

        path = latest_checkpoint(self.directory)
        if path is None:
            self._emit("resume", found=False)
            return None
        state, meta = restore_checkpoint(path, state_template)
        reshard_on_topology_change(meta, path)
        self._emit("resume", found=True, path=path, epoch=meta["epoch"],
                   topology_changed=False)
        rec = self._segment_record()
        if rec is not None:
            rec["resumed_epoch"] = meta["epoch"]
            self._persist()
        return state, meta

    # ----------------------------------------------------------- failure
    def on_failure(self, exc: BaseException) -> str:
        """In-process failure decision: ``"retry"`` (transient — after
        backing off) or ``"raise"`` (deterministic / budget exhausted;
        the segment is recorded as crashed either way so the NEXT
        process classifies correctly)."""
        error = f"{type(exc).__name__}: {exc}"
        kind = classify_error(error)
        committed = self._committed_epoch()
        progressed = committed > self._epoch_at_attempt_start
        self._epoch_at_attempt_start = committed
        if progressed:
            self._attempts_without_progress = 0
        else:
            self._attempts_without_progress += 1
        self._emit("segment_failure", kind=kind, error=error[:500],
                   epoch_committed=committed,
                   attempts_without_progress=
                       self._attempts_without_progress)
        if kind != "transient" \
                or self._attempts_without_progress >= self.crash_budget:
            self.close_segment("crashed", error)
            return "raise"
        backoff = min(self.backoff_base_s
                      * (2.0 ** (self._attempts_without_progress - 1)),
                      self.backoff_max_s)
        self._state = "backing-off"
        self._log(f"supervisor: transient failure ({error[:200]}) — "
                  f"retrying in {backoff:.1f}s "
                  f"(attempt {self._attempts_without_progress}/"
                  f"{self.crash_budget} without progress)")
        self._sleep(backoff)
        self._state = "running"
        return "retry"
