"""Dynamic-batching inference serving: the path from concurrent user
requests to the card (the port's own copies of the JAX package's
``serve/batcher.py``, ``serve/metrics.py`` and ``serve/warmup.py``).

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
  init) → a ``Predictor`` at a serve weight storage (fp32, bf16, int8).

The JAX package's engine pool, process router and workers, cascade,
client policy and capacity model are not ported yet (ROADMAP.md,
Queue 1: serving beyond the batcher).
"""
from .artifacts import cascade_predictors, checkpoint_predictor
from .batcher import DeadlineExceeded, DynamicBatcher, ServerOverloaded
from .metrics import HOPS, ServeMetrics
from .warmup import pow2_batch_sizes, precompile

__all__ = ["HOPS", "DeadlineExceeded", "DynamicBatcher", "ServeMetrics",
           "ServerOverloaded", "cascade_predictors", "checkpoint_predictor",
           "pow2_batch_sizes", "precompile"]
