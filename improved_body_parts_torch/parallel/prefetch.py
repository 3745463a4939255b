"""Host→device prefetch (counterpart of
``improved_body_parts_tpu/parallel/prefetch.py``): a background thread
copies each batch to the device up to ``depth`` batches ahead of the
training loop, so the copy of batch N+1 runs under the device step of
batch N.

On a CUDA device the producer thread stages each host array in pinned
memory and copies it with ``non_blocking=True`` on a side stream, then
records an event.  It waits for that event before it advances the source,
so a source that reuses its buffers (the shared-memory ring's slots) gets
a slot back only once the batch's copy has completed.  The consumer makes
its current stream wait on the event and marks each device tensor as used
by that stream (``record_stream``), so the caching allocator does not
hand the memory to the side stream again while a step still reads it.
On the CPU the producer copies each array into a tensor of its own.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..obs.trace import get_tracer


def device_prefetch(batches: Iterable, device, depth: int = 2,
                    spatial_shard: bool = False,
                    phase_stats=None) -> Iterator:
    """Yield each batch of ``batches`` (tuples of host arrays) as a tuple
    of tensors on ``device``, copied ``depth`` batches ahead.

    Exceptions of the source (or of the copy) are raised in the consumer.
    Abandoning the generator (an error in the step, KeyboardInterrupt)
    stops the producer and drains the queue, so the batches in flight are
    released.  ``spatial_shard`` and ``phase_stats`` (partitioning and
    telemetry) are not ported and accept only their defaults."""
    if spatial_shard or phase_stats is not None:
        raise NotImplementedError(
            "device_prefetch: spatial_shard / phase_stats are not ported "
            "yet (ROADMAP.md, queue 1: partitioning and telemetry)")
    device = torch.device(device)
    if device.type == "cuda":
        place = _CudaPlacer(device)
    elif device.type == "cpu":
        place = _cpu_place
    else:
        raise ValueError(f"unsupported device {device}")
    return _device_prefetch(batches, place, depth)


def _cpu_place(batch):
    return tuple(torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray)
                 else x for x in batch), None


class _CudaPlacer:
    """Pinned staging + a non-blocking copy on a side stream; returns the
    device tensors and the copy's event, once the copy has completed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch):
        staged = []
        for x in batch:
            if isinstance(x, np.ndarray):
                pinned = torch.empty(x.shape, dtype=torch.from_numpy(
                    np.empty(0, x.dtype)).dtype, pin_memory=True)
                pinned.numpy()[...] = x
                staged.append(pinned)
            else:
                staged.append(x)
        with torch.cuda.stream(self.stream):
            placed = tuple(t.to(self.device, non_blocking=True)
                           for t in staged)
            done = torch.cuda.Event()
            done.record(self.stream)
        # the source may reuse its buffers once we advance it: let the
        # copy complete first (this blocks the producer thread only)
        done.synchronize()
        return placed, done


def _device_prefetch(batches: Iterable, place, depth: int) -> Iterator:
    def consume(item):
        placed, done = item
        if done is not None:
            stream = torch.cuda.current_stream(placed[0].device)
            stream.wait_event(done)
            for t in placed:
                t.record_stream(stream)
        return placed

    if depth < 1:
        for batch in batches:
            yield consume(place(batch))
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error = []
    stop = threading.Event()

    def producer():
        trace = get_tracer()
        try:
            for batch in batches:
                with trace.span("device_copy"):
                    item = place(batch)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            error.append(e)
        finally:
            # the sentinel must wait for room: a full queue means the
            # consumer is still on earlier batches; stop is the only
            # abandon signal
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=producer, daemon=True,
                              name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield consume(item)
    finally:
        stop.set()
        _drain(q)
        # join after the drain: the producer's put loops see stop within
        # 0.1 s; without the join an abandoned generator leaks a thread
        # holding a batch (and, for a ring source, its slot)
        thread.join()
        _drain(q)


def _drain(q: queue.Queue) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
