"""Run-health sentinel: catch numeric divergence while it is one window
old, not one checkpoint old (the port's own copy of
``improved_body_parts_tpu/obs/health.py``).

The reference's only defense against a blown-up run is dropping batches
whose loss exceeds a threshold (train_distributed.py:259-261) — a NaN
loss sails straight through it (``NaN > thre`` is False) and every
dashboard keeps printing "training" while the parameters are garbage.
The sentinel closes that hole end to end:

- **On device** (``train.step.make_train_step(health=True)``): the step
  computes the global gradient norm — ONE extra scalar per step, read
  back only at the existing window readback, so the sentinel adds no
  syncs.  Loss finiteness needs no extra scalar (the loss itself is
  already read back).
- **On host** (this class): :meth:`check` runs at each window readback —
  non-finite loss, non-finite grad norm, or a grad norm past the
  configured limit marks the window divergent, updates the
  ``health_ok`` gauge + ``health_divergences_total`` counter, and emits
  a ``health`` event into the run's JSONL stream.
- **Policy** (``TrainConfig.on_divergence``):

  - ``warn`` — record and keep training (the reference's spirit);
  - ``halt`` — raise :class:`DivergenceError` out of the train loop: a
    multi-day run stops at the first poisoned window instead of
    checkpointing garbage for another epoch;
  - ``skip_step`` — enforced INSIDE the step (the branchless
    select that already drops abnormal-loss batches additionally
    requires a finite, in-limit grad norm), so divergent updates never
    reach the parameters and there is still no host round-trip in the
    hot loop.  The sentinel's role under this policy is visibility:
    the skipped windows still show up as ``health`` events.

- **Exposure**: the overall state (:meth:`state`) backs the
  ``/healthz`` route on the live endpoint — 200 while the latest
  window was healthy, 503 once it diverged — the shape a stock
  load-balancer/watchdog probe expects.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

from .events import NullSink
from .registry import Registry, get_registry

POLICIES = ("warn", "halt", "skip_step")


def _jsonsafe(v: Optional[float], digits: int = 6):
    """Strict-JSON scalar: non-finite floats become their string names
    ('nan'/'inf'/'-inf') — ``json.dumps`` would otherwise emit the bare
    ``NaN``/``Infinity`` tokens, which strict parsers (jq, Go, JS) reject
    in exactly the divergence records this module exists to produce."""
    if v is None:
        return None
    return round(v, digits) if math.isfinite(v) else repr(v)


class DivergenceError(RuntimeError):
    """Raised by the ``halt`` policy at the first divergent window."""


class HealthSentinel:
    def __init__(self, registry: Optional[Registry] = None, sink=None,
                 policy: str = "warn", grad_norm_limit: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(
                f"on_divergence policy {policy!r} unknown; use one of "
                f"{POLICIES}")
        self.policy = policy
        self.grad_norm_limit = float(grad_norm_limit)
        registry = registry if registry is not None else get_registry()
        self._sink = sink if sink is not None else NullSink()
        self._ok_gauge = registry.gauge(
            "health_ok", "1 while the latest checked window was healthy")
        self._ok_gauge.set(1.0)
        self._gnorm_gauge = registry.gauge(
            "health_grad_norm", "latest global gradient norm read back")
        self._checks = registry.counter(
            "health_checks_total", "windows checked by the sentinel")
        self._divergences = registry.counter(
            "health_divergences_total",
            "windows with non-finite loss/grad-norm (or past the limit)")
        self._lock = threading.Lock()
        self._status = "ok"
        self._ever_diverged = False
        self._last: dict = {}
        # named extra state sources merged into the /healthz body (the
        # run supervisor reports running/draining/backing-off here)
        self._extra: dict = {}

    def set_extra(self, name: str, fn) -> None:
        """Merge ``{name: fn()}`` into every :meth:`state` — how other
        subsystems (``train.supervisor``) surface their state on the
        same ``/healthz`` body without a second endpoint."""
        self._extra[str(name)] = fn

    # ------------------------------------------------------------ checks
    def check(self, loss: float, grad_norm: Optional[float] = None,
              step: Optional[int] = None,
              epoch: Optional[int] = None) -> bool:
        """Judge one readback window; returns True when healthy.

        Emits a ``health`` event either way (the stream's heartbeat —
        a report can tell "healthy" from "sentinel never ran"), trips
        the policy on divergence.
        """
        loss = float(loss)
        reasons = []
        if not math.isfinite(loss):
            reasons.append("loss_not_finite")
        gn = None
        if grad_norm is not None:
            gn = float(grad_norm)
            if not math.isfinite(gn):
                reasons.append("grad_norm_not_finite")
            elif 0.0 < self.grad_norm_limit < gn:
                reasons.append("grad_norm_over_limit")
            if math.isfinite(gn):
                # a NaN gauge would render as a malformed exposition
                # line; the divergence itself is carried by health_ok
                self._gnorm_gauge.set(gn)
        healthy = not reasons
        self._checks.inc()
        if not healthy:
            self._divergences.inc()
        self._ok_gauge.set(1.0 if healthy else 0.0)
        with self._lock:
            # current-window state (a later healthy window recovers it —
            # the probe contract); ever_diverged stays up for forensics.
            # _jsonsafe here AND in the emit: the /healthz body serves
            # this dict verbatim and must stay strict JSON
            self._status = "ok" if healthy else "diverged"
            self._ever_diverged |= not healthy
            self._last = {"loss": _jsonsafe(loss),
                          "grad_norm": _jsonsafe(gn), "step": step,
                          "epoch": epoch, "reasons": reasons}
        self._sink.emit(
            "health", status=self._status, loss=_jsonsafe(loss),
            grad_norm=_jsonsafe(gn),
            step=step, epoch=epoch, policy=self.policy,
            **({"reasons": reasons} if reasons else {}))
        if not healthy and self.policy == "halt":
            raise DivergenceError(
                f"run diverged at epoch={epoch} step={step}: "
                f"{', '.join(reasons)} (loss={loss!r}, grad_norm={gn!r}); "
                "on_divergence=halt — restart from the last healthy "
                "checkpoint")
        return healthy

    # ------------------------------------------------------------- state
    def state(self) -> dict:
        """JSON-ready overall state — the ``/healthz`` body."""
        with self._lock:
            out = {
                "status": self._status,
                "policy": self.policy,
                "grad_norm_limit": self.grad_norm_limit or None,
                "checks": int(self._checks.value),
                "divergences": int(self._divergences.value),
                "ever_diverged": self._ever_diverged,
                "last": dict(self._last),
            }
        for name, fn in self._extra.items():
            try:
                v = fn()
            except Exception as e:  # noqa: BLE001 — a probe body must
                v = f"error: {type(e).__name__}"          # never 500
            out[name] = v
            # an extra source can escalate the probe: a dict carrying
            # its own non-ok "status" (the fleet block once a worker
            # exhausts its crash budget) flips the top-level status —
            # and with it /healthz to 503 — without owning the route
            if (isinstance(v, dict) and out["status"] == "ok"
                    and v.get("status", "ok") != "ok"):
                out["status"] = str(v["status"])
        return out
