"""Dynamic-batching inference serving: the path from concurrent user
requests to the card (the port's own copies of the JAX package's
``serve/`` modules).

- ``batcher`` — :class:`DynamicBatcher`: shape-bucketed coalescing,
  ``max_batch``/``max_wait_ms`` flush, bounded admission with explicit
  load-shedding (:class:`ServerOverloaded`), per-request futures and
  per-request deadlines (:class:`DeadlineExceeded`), the fused
  device-decode lane with its host fallbacks, and the host-pool lane.
- ``metrics`` — :class:`ServeMetrics`: queue depth, batch occupancy
  histogram, p50/p95/p99 latency, imgs/sec, the per-request hop
  waterfall (:data:`HOPS`), deadline and stall accounting.
- ``warmup``  — start-up warmup of every (bucket shape × pow2 batch
  size) program.
- ``artifacts`` — :func:`checkpoint_predictor`: a checkpoint (or a seeded
  init) → a ``Predictor`` at a serve weight storage (fp32, bf16, int8);
  :func:`cascade_predictors`: the cascade's (student, teacher) pair.
- ``cascade`` — :class:`CascadeEngine`: two-tier serving — a student
  lane answers first, the fused decode payload's free escalation
  signals (:class:`EscalationPolicy`) route hard frames to the teacher
  as a second submit on the same machinery.
- ``pool``    — :class:`EnginePool`: N shared-nothing batcher replicas
  behind a health-checked router — least-loaded routing, circuit
  breaking, fencing and transparent failover of in-flight work.
- ``breaker`` — :class:`CircuitBreaker`: sliding-window failure-rate
  breaker with half-open probing.
- ``router`` / ``worker`` — :class:`ProcessRouter` +
  :class:`ProcessWorkerEngine`: the pool's replicas as spawned worker
  PROCESSES over the shared-memory wire (images in, fixed-shape person
  tables out, no pickling), SIGKILL-survivable, same engine contract.
- ``policy``  — :class:`PolicyClient` + :func:`submit_with_retry`:
  client-side deadlines, jittered retry on ``ServerOverloaded``, hedged
  dispatch for tail latency.
- ``capacity`` — :class:`CapacityModel`: per-replica saturation fitted
  from the telemetry history store, ``replicas_needed(target_qps,
  objective)``.
"""
from .artifacts import cascade_predictors, checkpoint_predictor
from .batcher import DeadlineExceeded, DynamicBatcher, ServerOverloaded
from .breaker import CircuitBreaker
from .capacity import CapacityModel
from .cascade import CascadeEngine, CascadeMetrics, EscalationPolicy
from .metrics import HOPS, ServeMetrics
from .policy import PolicyClient, PolicyStats, jittered_backoff, submit_with_retry
from .pool import EnginePool
from .router import ProcessRouter, ProcessWorkerEngine
from .warmup import pow2_batch_sizes, precompile

__all__ = ["HOPS", "CapacityModel", "CascadeEngine", "CascadeMetrics", "CircuitBreaker",
           "DeadlineExceeded", "DynamicBatcher", "EnginePool",
           "EscalationPolicy", "PolicyClient", "PolicyStats",
           "ProcessRouter", "ProcessWorkerEngine",
           "ServeMetrics", "ServerOverloaded", "cascade_predictors",
           "checkpoint_predictor", "jittered_backoff",
           "pow2_batch_sizes", "precompile", "submit_with_retry"]
