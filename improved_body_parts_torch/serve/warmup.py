"""Startup warmup: run every batch program the configured traffic can
touch once, before the first request arrives (the port's own copy of
``improved_body_parts_tpu/serve/warmup.py``).

PyTorch compiles nothing ahead of time, but the first run of each
(bucket shape x batch size) still pays one-off costs on the card: the
kernels' ``nvcc`` build at first use (``ops/_build.py``), cuDNN's
algorithm choice for the shape, and the caching allocator's first
blocks.  Paid lazily they land as a latency spike on the first unlucky
request in each bucket; paid here they land at start-up.

The unit of work is (bucket shape x batch size):
``Predictor.enumerate_bucket_shapes`` maps the deployment's expected
image sizes onto padded lane shapes, and :func:`pow2_batch_sizes` lists
every chunk size the batcher's binary-decomposition dispatch can emit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def pow2_batch_sizes(max_batch: int) -> Tuple[int, ...]:
    """Every power of two ≤ ``max_batch`` — the complete set of chunk
    sizes the batch dispatch's binary decomposition can emit for any
    occupancy ≤ ``max_batch``; warming exactly these covers every
    possible flush."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    return tuple(1 << i for i in range((max_batch).bit_length())
                 if (1 << i) <= max_batch)


def precompile(predictors, image_sizes: Sequence[Tuple[int, int]],
               max_batch: int = 8, params=None,
               batch_sizes: Optional[Sequence[int]] = None,
               decode: bool = False) -> dict:
    """Warm a predictor — or a whole predictor SET (the batcher's device
    replicas) — for serving: run the compact-batch lane for every bucket
    the given (H, W) image sizes land in, at every batch size
    ``max_batch``-occupancy dispatch can emit, and the single-image
    flush.  Blocks until each run finished.  ``decode=True`` warms the
    FUSED device-decode lane instead — what the batcher's default lane
    dispatches.

    Bucket shapes are enumerated PER predictor and the summary reports
    their union.  Returns ``{"bucket_shapes", "batch_sizes",
    "newly_compiled"}``: ``newly_compiled`` counts the (shape x batch)
    combinations some predictor had not run before, so 0 means every
    predictor was already fully warm (the signal the no-stall test
    asserts on).
    """
    preds = (list(predictors) if isinstance(predictors, (list, tuple))
             else [predictors])
    sizes = (tuple(batch_sizes) if batch_sizes is not None
             else pow2_batch_sizes(max_batch))
    all_shapes = set()
    compiled = 0
    for predictor in preds:
        shapes = predictor.enumerate_bucket_shapes(image_sizes, params)
        all_shapes.update(shapes)
        compiled += predictor.precompile_compact(shapes, sizes,
                                                 params=params,
                                                 decode=decode)
    return {"bucket_shapes": sorted(all_shapes), "batch_sizes": sizes,
            "newly_compiled": compiled}
