"""Pipelined end-to-end inference: forward(N+1) on the device overlaps
decode(N) on the host, and the decode-side plumbing the serving engine
shares (the port's own copy of
``improved_body_parts_tpu/infer/pipeline.py``).

The reference runs strictly serially — forward, transfer, then the CPU
decode that dominates end-to-end time (5.2 FPS keypoint assignment,
reference: README.md:68, evaluate.py:501-543).  Here the ensemble for the
next image is dispatched *before* the previous image's results are read
back and decoded, and decoding itself can fan out over a thread pool (the
native C++ decoder releases the GIL during the ctypes call), so the card
never waits for the host.

Results are yielded strictly in input order.  A scale / rotation grid
runs through the compact lanes' grid dispatch, one image at a time.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from ..config import InferenceParams, SkeletonConfig
from .decode import CompactOverflow, decode, decode_compact, decode_device


def compact_decode_fn(predictor, params: Optional[InferenceParams] = None,
                      skeleton: Optional[SkeletonConfig] = None,
                      use_native: bool = True
                      ) -> Callable[[object, np.ndarray], list]:
    """Build the one-``CompactResult`` decoder with the documented
    overflow fallback — the decode-side plumbing shared by
    ``pipelined_inference`` and ``serve.DynamicBatcher`` (both run the
    returned callable on thread pools; with the native decoder the GIL is
    released during the ctypes call, so workers truly parallelize).

    The returned ``decode_one(compact_res, image)`` decodes one image's
    compact payload; on ``CompactOverflow`` (peak/candidate counts past
    the device top-K capacity) it transparently re-runs that image
    through the full-map path -- ``predict_fast`` for the trivial grid,
    the host ``Predictor.predict`` for a scale / rotation grid (which
    the fast path rejects).
    """
    from .predict import trivial_grid

    params = params or predictor.params
    skeleton = skeleton or predictor.skeleton
    single_dispatch_grid = trivial_grid(params)

    def decode_one(compact_res, image: np.ndarray) -> list:
        try:
            return decode_compact(compact_res, params, skeleton,
                                  use_native=use_native)
        except CompactOverflow:
            if not single_dispatch_grid:
                heat, paf = predictor.predict(image, params=params)
                return decode(heat, paf, params, skeleton,
                              use_native=use_native)
            heat, paf, mask, scale = predictor.predict_fast_async(
                image, params=params)()
            return decode(heat, paf, params, skeleton, peak_mask=mask,
                          coord_scale=scale, use_native=use_native)

    return decode_one


def device_decode_fn(predictor, params: Optional[InferenceParams] = None,
                     skeleton: Optional[SkeletonConfig] = None,
                     use_native: bool = True
                     ) -> Callable[[object, np.ndarray], list]:
    """Build the one-``DeviceDecoded`` finisher with the documented
    overflow fallback — the default-lane plumbing shared by
    ``pipelined_inference(device_decode=True)`` and
    ``serve.DynamicBatcher``.

    The returned ``decode_one(device_res, image)`` finishes one image's
    fused device decode: when no capacity overflowed (``.ok``) the host
    work is the O(people) id→coordinate lookup of
    ``decode.decode_device``; otherwise the image re-decodes from the
    compact records shipped in the same buffer through
    :func:`compact_decode_fn`'s host path — which itself falls back to
    the full-map path when the compact records overflowed too.  So every
    overflow class degrades one level, never fails.
    """
    skeleton = skeleton or predictor.skeleton
    fallback = compact_decode_fn(predictor, params, skeleton, use_native)

    def decode_one(device_res, image: np.ndarray) -> list:
        if device_res.ok:
            return decode_device(device_res, skeleton)
        return fallback(device_res.compact, image)

    return decode_one


def pipelined_inference(predictor, images: Iterable[np.ndarray],
                        params: Optional[InferenceParams] = None,
                        skeleton: Optional[SkeletonConfig] = None,
                        use_native: bool = True,
                        decode_workers: int = 2,
                        compact: bool = False,
                        compact_batch: int = 0,
                        device_decode: bool = False) -> Iterator[list]:
    """Run the fast path over a stream of BGR images, overlapping stages.

    Yields ``decode`` results (list of (coco_keypoints, score) per image) in
    input order.  ``decode_workers`` decodes run concurrently; with the
    native decoder the GIL is released so they truly parallelize.

    ``compact`` uses ``Predictor.predict_compact`` — peak extraction and
    pair scoring stay on the device and only ~1 MB crosses the boundary per
    image.  Images whose peak count overflows the top-K capacity fall back
    to the full-map fast path transparently.

    ``compact_batch`` > 1 (throughput mode, implies ``compact``) chunks
    the stream and runs ``predict_compact_batch`` — N images + mirrors in
    one 2N-lane dispatch sharing one transfer round trip.  A scale /
    rotation grid still works (each image through the grid dispatch, one
    fetch a chunk, chunked in arrival order); the 2N-lane sharing only
    applies to the trivial grid.  ``compact_batch == 1`` degrades to the
    plain compact path rather than being silently ignored.

    ``device_decode`` (implies ``compact``) runs the greedy person
    assembly on the device too (``Predictor.predict_decoded*``); the
    thread pool then only finishes the O(people) coordinate lookup, or
    handles the documented overflow fallbacks.
    """
    from .predict import trivial_grid

    params = params or predictor.params
    skeleton = skeleton or predictor.skeleton
    if device_decode:
        compact = True
    if compact_batch == 1:
        compact, compact_batch = True, 0
    single_dispatch_grid = trivial_grid(params)

    def run_decode(resolve: Callable):
        heat, paf, mask, scale = resolve()
        return decode(heat, paf, params, skeleton, peak_mask=mask,
                      coord_scale=scale, use_native=use_native)

    # the shared compact decode plumbing (overflow fallback included) —
    # same callable the serving engine's decode pool runs; the device
    # lane swaps in the DeviceDecoded finisher and the fused dispatchers
    if device_decode:
        decode_one_compact = device_decode_fn(predictor, params, skeleton,
                                              use_native)
        dispatch_one = predictor.predict_decoded_async
        dispatch_batch = predictor.predict_decoded_batch_async
    else:
        decode_one_compact = compact_decode_fn(predictor, params, skeleton,
                                               use_native)
        dispatch_one = predictor.predict_compact_async
        dispatch_batch = predictor.predict_compact_batch_async

    def run_decode_compact(resolve: Callable, image: np.ndarray):
        return decode_one_compact(resolve(), image)

    def run_decode_compact_batch(resolve: Callable, chunk: list):
        return [decode_one_compact(res, im)
                for res, im in zip(resolve(), chunk)]

    with ThreadPoolExecutor(max_workers=max(1, decode_workers)) as pool:
        futures = []        # (future, is_batch)
        window = max(1, decode_workers)

        def drain(limit):
            while len(futures) > limit:
                fut, is_batch = futures.pop(0)
                if is_batch:
                    yield from fut.result()
                else:
                    yield fut.result()

        if compact_batch > 1:
            # bucket the stream by predicted lane shape so each dispatch
            # is single-shape (predict_compact_batch_async then runs its
            # exact pow2 decomposition — no padded lanes); results still
            # yield in input order via an index-keyed reorder buffer
            buckets: dict = {}          # lane shape -> (indices, images)
            done: dict = {}             # input index -> decoded result
            next_out = 0
            n_in = 0

            def dispatch(idxs, chunk):
                resolve = dispatch_batch(
                    chunk, thre1=params.thre1, params=params)
                futures.append((idxs, pool.submit(
                    run_decode_compact_batch, resolve, chunk)))

            def collect(limit):
                nonlocal next_out
                while len(futures) > limit:
                    idxs, fut = futures.pop(0)
                    for i, r in zip(idxs, fut.result()):
                        done[i] = r
                while next_out in done:
                    yield done.pop(next_out)
                    next_out += 1

            for image in images:
                # a grid dispatches per image inside the batch call
                # anyway: shape buckets would only split its chunks
                key = (predictor.compact_lane_shape(image, params)
                       if single_dispatch_grid else "arrival")
                idxs, chunk = buckets.setdefault(key, ([], []))
                idxs.append(n_in)
                chunk.append(image)
                n_in += 1
                if len(chunk) == compact_batch:
                    dispatch(*buckets.pop(key))
                # bound buffered images: flush the fullest bucket when the
                # backlog reaches one extra batch worth of images
                backlog = sum(len(v[0]) for v in buckets.values())
                if backlog >= 2 * compact_batch:
                    fullest = max(buckets, key=lambda s: len(buckets[s][0]))
                    dispatch(*buckets.pop(fullest))
                yield from collect(window)
            for key in list(buckets):
                dispatch(*buckets.pop(key))
            yield from collect(0)
            assert next_out == n_in, "compact_batch lost results"
            return

        for image in images:
            # dispatch forward; thre1 from the caller's params must reach
            # the on-device NMS, same as the sequential fast path
            if compact:
                resolve = dispatch_one(
                    image, thre1=params.thre1, params=params)
                futures.append(
                    (pool.submit(run_decode_compact, resolve, image), False))
            else:
                resolve = predictor.predict_fast_async(
                    image, params=params)
                futures.append((pool.submit(run_decode, resolve), False))
            # bound the number of in-flight images; yield the oldest
            yield from drain(window)
        yield from drain(0)
