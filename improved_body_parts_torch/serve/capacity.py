"""Measured capacity model: per-replica saturation fitted from
telemetry history, answering ``replicas_needed(target_qps, objective)``
(the port's own copy of ``improved_body_parts_tpu/serve/capacity.py``).

The autoscaler question is never "what is the load" — the history store
answers that — it is "how many replicas does THIS load need to stay
inside THIS objective".  Guessing that from specs is how fleets end up
sized by folklore; this model fits it from what the router actually
measured:

- :meth:`CapacityModel.fit` slices an ``obs.history.HistoryStore`` into
  fixed windows and derives, per window, the *exact-counter* load line:
  QPS from the ``<prefix>_completed_total`` delta, mean latency from
  the ``<prefix>_latency_seconds_sum/_count`` deltas (both exact —
  counter differences, no reservoir involved), the last-sampled p99
  gauge, and mean batch occupancy (``prefix`` picks the serving layer:
  ``serve`` for one batcher, ``pool`` for the replicated rollup);
- the **knee** is the highest measured QPS whose latency still met the
  objective (explicit ``objective_ms``, or ``knee_factor ×`` the
  unloaded base latency — the classic hockey-stick definition).  No
  curve family is assumed: the model interpolates measurements, it does
  not extrapolate a queueing formula;
- :meth:`replicas_needed` divides the target through the knee-derived
  per-replica capacity with a headroom derate, and FLAGS what it cannot
  know: ``extrapolated`` when the target exceeds anything measured,
  ``objective_unmet`` when no measured window met the objective at all
  (the honest answer is "add replicas and re-measure", not a number
  dressed up as one).

Windowed p99 is *not* derivable from the registry's cumulative
reservoir gauge (it summarizes the whole run, not the window) — the
model records the last-sampled p99 per window as a reference signal and
fits the knee on whichever latency signal the caller names
(``objective_on="mean"`` by default, the exact one).
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Optional, Sequence

from ..obs.history import series_key

#: latency multiple over the unloaded base above which a window counts
#: as saturated when no explicit objective is given
DEFAULT_KNEE_FACTOR = 2.0

#: default derate on the knee when sizing: run fleets at ≤85% of the
#: measured saturation point so transient bursts land in margin, not in
#: the queue
DEFAULT_HEADROOM = 0.85


class CapacityModel:
    """Measured (qps → latency) points for one deployment and the
    capacity answers derived from them.  Build via :meth:`fit` (from a
    history store) or :meth:`fit_from_points` (tests, offline
    analysis)."""

    def __init__(self, points: List[dict], *, replicas: int = 1,
                 objective_ms: Optional[float] = None,
                 objective_on: str = "mean",
                 knee_factor: float = DEFAULT_KNEE_FACTOR,
                 max_batch: Optional[int] = None,
                 meta: Optional[dict] = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if objective_on not in ("mean", "p99"):
            raise ValueError(
                f"objective_on must be 'mean' or 'p99', got "
                f"{objective_on!r}")
        #: per-window measurements, qps-ascending:
        #: {qps, mean_ms, p99_ms?, occupancy?, t0?, t1?, completed?}
        self.points = sorted((dict(p) for p in points),
                             key=lambda p: p["qps"])
        self.replicas = int(replicas)
        self.objective_on = objective_on
        self.knee_factor = float(knee_factor)
        self.max_batch = max_batch
        self.meta = dict(meta or {})
        # unloaded base latency: median of the lowest-qps quartile —
        # robust to one weird window, defined whenever any point exists
        self.base_ms: Optional[float] = None
        if self.points:
            q = self.points[:max(1, len(self.points) // 4)]
            lat = sorted(self._lat(p) for p in q)
            self.base_ms = lat[len(lat) // 2]
        self.objective_ms = (float(objective_ms)
                             if objective_ms is not None else
                             (self.base_ms * self.knee_factor
                              if self.base_ms is not None else None))
        self.knee_qps: Optional[float] = None
        self.knee_occupancy: Optional[float] = None
        if self.objective_ms is not None:
            met = [p for p in self.points
                   if self._lat(p) <= self.objective_ms]
            if met:
                knee = max(met, key=lambda p: p["qps"])
                self.knee_qps = knee["qps"]
                self.knee_occupancy = knee.get("occupancy")
        self.measured_max_qps = (self.points[-1]["qps"]
                                 if self.points else None)

    def _lat(self, p: dict) -> float:
        if self.objective_on == "p99" and p.get("p99_ms") is not None:
            return p["p99_ms"]
        return p["mean_ms"]

    # ------------------------------------------------------------ fitting
    @classmethod
    def fit(cls, store, *, window_s: float = 5.0, replicas: int = 1,
            model: Optional[str] = None, prefix: str = "serve",
            objective_ms: Optional[float] = None,
            objective_on: str = "mean",
            knee_factor: float = DEFAULT_KNEE_FACTOR,
            max_batch: Optional[int] = None) -> "CapacityModel":
        """Fit from a history store's raw rings.  ``model`` selects the
        per-tier label dimension of a multi-model deployment (None = the
        unlabeled single-model series); ``prefix`` selects the serving
        layer whose families to read — ``"serve"`` for a single
        batcher, ``"pool"`` for the replicated rollup (``EnginePool`` /
        ``ProcessRouter`` export the same family set under that
        prefix).  Windows with no completions are dropped — an idle
        window measures nothing about capacity."""
        base = {"model": model} if model else {}
        completed = cls._raw(store, f"{prefix}_completed_total", base)
        lat_sum = cls._raw(store, f"{prefix}_latency_seconds_sum", base)
        lat_count = cls._raw(store, f"{prefix}_latency_seconds_count",
                             base)
        p99 = cls._raw(store, f"{prefix}_latency_seconds",
                       {**base, "quantile": "0.99"})
        occ = cls._raw(store, f"{prefix}_batch_occupancy_mean", base)
        points: List[dict] = []
        if completed and window_s > 0:
            t0 = completed[0][0]
            t_end = completed[-1][0]
            n_windows = max(1, int(math.ceil((t_end - t0) / window_s)))
            for i in range(n_windows):
                lo, hi = t0 + i * window_s, t0 + (i + 1) * window_s
                w = [(t, v) for t, v in completed if lo <= t <= hi]
                if len(w) < 2:
                    continue
                (ta, ca), (tb, cb) = w[0], w[-1]
                dt, dc = tb - ta, cb - ca
                if dt <= 0 or dc <= 0:
                    continue
                ls = cls._delta(lat_sum, ta, tb)
                lc = cls._delta(lat_count, ta, tb)
                if ls is None or lc is None or lc <= 0:
                    continue
                pt = {"t0": ta, "t1": tb, "completed": dc,
                      "qps": dc / dt, "mean_ms": ls / lc * 1e3}
                p99_w = [v for t, v in p99 if lo <= t <= hi]
                if p99_w:
                    pt["p99_ms"] = p99_w[-1] * 1e3
                occ_w = [v for t, v in occ if lo <= t <= hi]
                if occ_w:
                    pt["occupancy"] = math.fsum(occ_w) / len(occ_w)
                points.append(pt)
        return cls(points, replicas=replicas, objective_ms=objective_ms,
                   objective_on=objective_on, knee_factor=knee_factor,
                   max_batch=max_batch,
                   meta={"window_s": window_s, "model": model,
                         "prefix": prefix,
                         "run_id": getattr(store, "run_id", None)})

    @classmethod
    def fit_from_points(cls, pts: Sequence, **kw) -> "CapacityModel":
        """From bare ``(qps, mean_ms)`` pairs (or ready dicts) — the
        test/offline entry that skips the history slicing."""
        points = [p if isinstance(p, dict)
                  else {"qps": float(p[0]), "mean_ms": float(p[1])}
                  for p in pts]
        return cls(points, **kw)

    @staticmethod
    def _raw(store, name: str, labels: Dict[str, str]) -> List:
        try:
            return store.query(series_key(name, labels))["points"]
        except KeyError:
            return []

    @staticmethod
    def _delta(pts: List, ta: float, tb: float) -> Optional[float]:
        """Counter delta between the newest samples at or before each
        endpoint — exact, because the underlying signals are counters."""
        va = vb = None
        for t, v in pts:
            if t <= ta:
                va = v
            if t <= tb:
                vb = v
            else:
                break
        if va is None or vb is None:
            return None
        return vb - va

    # ------------------------------------------------------------ answers
    def per_replica_qps(self) -> Optional[float]:
        """Measured per-replica saturation throughput (the knee split
        across the replicas that produced it)."""
        if self.knee_qps is None:
            return None
        return self.knee_qps / self.replicas

    def occupancy_headroom(self) -> Optional[float]:
        """``1 − occupancy_at_knee / max_batch`` — how much batch room
        was left at the knee (None without occupancy or ``max_batch``).
        Near-zero headroom says the knee is batch-bound: bigger batches,
        not more replicas, may be the cheaper lever."""
        if (self.knee_occupancy is None or not self.max_batch
                or self.max_batch <= 0):
            return None
        return max(0.0, 1.0 - self.knee_occupancy / self.max_batch)

    def replicas_needed(self, target_qps: float,
                        objective_ms: Optional[float] = None,
                        headroom: float = DEFAULT_HEADROOM) -> dict:
        """Replicas required to serve ``target_qps`` inside the
        objective, derated by ``headroom``.  ``replicas`` is None when
        the model cannot honestly answer (no measurements, or no
        measured window met the objective) — the flags say why."""
        if objective_ms is not None and objective_ms != self.objective_ms:
            # re-evaluate the knee under the caller's objective
            m = CapacityModel(self.points, replicas=self.replicas,
                              objective_ms=objective_ms,
                              objective_on=self.objective_on,
                              knee_factor=self.knee_factor,
                              max_batch=self.max_batch, meta=self.meta)
            return m.replicas_needed(target_qps, headroom=headroom)
        per = self.per_replica_qps()
        out = {
            "target_qps": float(target_qps),
            "objective_ms": self.objective_ms,
            "objective_on": self.objective_on,
            "knee_qps": self.knee_qps,
            "per_replica_qps": per,
            "headroom": float(headroom),
            "measured_max_qps": self.measured_max_qps,
            "objective_unmet": (bool(self.points)
                                and self.knee_qps is None),
            "extrapolated": (
                self.measured_max_qps is not None
                and float(target_qps) > self.measured_max_qps),
            "replicas": None,
        }
        if per is not None and per > 0 and headroom > 0:
            out["replicas"] = max(
                1, int(math.ceil(float(target_qps) / (per * headroom))))
        return out

    def to_dict(self) -> dict:
        """JSON-ready model document (the audit artifact embeds it)."""
        return {
            "replicas": self.replicas,
            "objective_ms": self.objective_ms,
            "objective_on": self.objective_on,
            "knee_factor": self.knee_factor,
            "max_batch": self.max_batch,
            "base_ms": self.base_ms,
            "knee_qps": self.knee_qps,
            "per_replica_qps": self.per_replica_qps(),
            "knee_occupancy": self.knee_occupancy,
            "occupancy_headroom": self.occupancy_headroom(),
            "measured_max_qps": self.measured_max_qps,
            "windows": len(self.points),
            "points": [dict(p) for p in self.points],
            "meta": dict(self.meta),
        }

    # --------------------------------------------------------- telemetry
    def register_into(self, registry) -> "CapacityModel":
        """Export the fitted answers as ``capacity_*`` gauges (weakref
        collector, per the subsystem precedent) so /metrics — and the
        history store sampling it — carries the capacity picture the
        fleet was last sized from."""
        ref = weakref.ref(self)

        def _collect():
            m = ref()
            if m is None:
                return []
            out = [
                ("capacity_windows", {}, "gauge", float(len(m.points)),
                 "measured (qps, latency) windows in the fit"),
                ("capacity_replicas", {}, "gauge", float(m.replicas),
                 "replica count the measurements were taken at"),
            ]
            if m.base_ms is not None:
                out.append(("capacity_base_latency_ms", {}, "gauge",
                            m.base_ms, "unloaded base latency"))
            if m.objective_ms is not None:
                out.append(("capacity_objective_ms", {}, "gauge",
                            m.objective_ms, "latency objective in force"))
            if m.knee_qps is not None:
                out.append(("capacity_knee_qps", {}, "gauge",
                            m.knee_qps,
                            "highest measured QPS inside the objective"))
            per = m.per_replica_qps()
            if per is not None:
                out.append(("capacity_per_replica_qps", {}, "gauge",
                            per, "knee split per replica"))
            if m.measured_max_qps is not None:
                out.append(("capacity_measured_max_qps", {}, "gauge",
                            m.measured_max_qps,
                            "highest QPS measured at all"))
            hr = m.occupancy_headroom()
            if hr is not None:
                out.append(("capacity_occupancy_headroom", {}, "gauge",
                            hr, "batch room left at the knee"))
            return out

        registry.register_collector(_collect)
        return self
