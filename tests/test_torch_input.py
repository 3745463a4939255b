"""The port's input pipeline: the shared-memory ring (``data.shm_ring``)
and ``parallel.prefetch.device_prefetch``, as ``tests/test_input_pipeline.py``
and ``tests/test_prefetch.py`` hold the JAX package's.

- the slot layout of ``batch_wire_format`` (labels or joints + mask_all)
  equals the JAX package's;
- the ring's batches equal ``batches(pipeline="sync")`` bit for bit: on
  both wires over two epochs, with GT made on the device (``raw_gt``), over
  a ``MemoryDataset`` (its records pickled to the workers), through the
  copying ``batches(pipeline="shm")`` facade, across an epoch boundary
  on one ring, after an abandoned epoch and with a slow consumer on 2 slots;
- yielded views are read-only; a worker's exception raises with its
  traceback; a killed worker raises ``WorkerDied`` within 30 s, or, under
  ``supervise=True``, the ring rebuilds and the stream stays bit-identical,
  and ``max_rebuilds`` bounds a worker that keeps dying;
- no ``/dev/shm`` segment is left after ``close()``, also after a killed
  worker;
- ``device_prefetch`` (on the CPU here): order and content, the source's
  error raised in the consumer, a slow consumer still sees the end, an
  abandoned generator stops its producer thread, depth 0 is synchronous,
  and the refused options name the roadmap.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from improved_body_parts_torch.config import get_config
from improved_body_parts_torch.data import (
    CocoPoseDataset,
    MemoryDataset,
    ShmRingInput,
    WorkerDied,
    batch_wire_format,
    batches,
)
from improved_body_parts_torch.data.fixture import (
    build_fixture,
    fixture_records,
)
from improved_body_parts_torch.parallel import device_prefetch
from improved_body_parts_tpu.config import get_config as jget_config
from improved_body_parts_tpu.data import batch_wire_format as jwire_format

sys.path.insert(0, "tests")
from test_torch_models import one_torch_thread  # noqa: E402,F401

CFG = get_config("tiny")
FIX = dict(num_images=5, people_per_image=2, seed=2, image_size=128)


@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ring_corpus") / "fixture.h5")
    assert build_fixture(path, **FIX) > 0
    return path


def _collect(it):
    return [tuple(np.copy(x) for x in b) for b in it]


def _equal(want, got):
    assert len(want) == len(got) >= 2
    for a, b in zip(want, got):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _segment(ring):
    return os.path.join("/dev/shm", ring._shm.name.lstrip("/"))


@pytest.mark.parametrize("raw_gt,wire", [(0, "uint8"), (0, "f32"),
                                         (6, "uint8")])
def test_wire_format_equals_jax(raw_gt, wire):
    assert batch_wire_format(CFG, 3, raw_gt=raw_gt, wire=wire) == \
        jwire_format(jget_config("tiny"), 3, raw_gt=raw_gt, wire=wire)
    with pytest.raises(ValueError, match="wire"):
        batch_wire_format(CFG, 2, wire="f16")


@pytest.mark.parametrize("wire", ["uint8", "f32"])
def test_ring_bit_identical_to_sync_for_two_epochs(fixture_path, wire):
    ds = CocoPoseDataset(fixture_path, CFG, augment=True, seed=11)
    with ShmRingInput(ds, 2, num_workers=2, wire=wire) as ring:
        for epoch in (0, 1):
            _equal(list(batches(ds, 2, epoch, wire=wire)),
                   _collect(ring.batches(epoch)))
        segment = _segment(ring)
        assert os.path.exists(segment)
    assert not os.path.exists(segment)  # close() unlinked the block
    ds.close()


def test_raw_gt_memory_dataset_stream_and_abandon(fixture_path):
    """GT made on the device over a MemoryDataset (records pickled to the
    spawn workers): the epoch stream equals sync, also for two epochs
    back to back on one ring; an abandoned epoch leaves the next one
    intact."""
    ds = MemoryDataset(fixture_records(**FIX), CFG, augment=True, seed=7)
    sync = [list(batches(ds, 2, e, raw_gt=6, wire="uint8")) for e in (0, 1)]
    with ShmRingInput(ds, 2, num_workers=2, raw_gt=6, wire="uint8") as ring:
        got = _collect(ring.batches(1))
        _equal(sync[1], got)
        assert got[0][2].shape == (2, 6, CFG.skeleton.num_parts, 3)
        # epochs 0 then 1 back to back on the same ring and workers
        _equal(sync[0] + sync[1],
               _collect(ring.batches(0)) + _collect(ring.batches(1)))
        it = ring.batches(0)
        next(it)
        it.close()  # abandoned with tasks in flight
        _equal(sync[1], _collect(ring.batches(1)))


def test_facade_copies_and_slow_consumer_on_two_slots(fixture_path):
    ds = CocoPoseDataset(fixture_path, CFG, augment=True, seed=9)
    _equal(list(batches(ds, 2, 0, wire="uint8")),
           list(batches(ds, 2, 0, pipeline="shm", num_workers=2,
                        wire="uint8")))
    sync = list(batches(ds, 1, 0, wire="uint8"))
    with ShmRingInput(ds, 1, num_workers=1, wire="uint8", slots=2) as ring:
        assert ring.slots == 2 < len(sync)
        got = []
        for b in ring.batches(0):
            time.sleep(0.02)  # let the worker race ahead
            got.append(tuple(np.copy(x) for x in b))
            with pytest.raises(ValueError, match="read-only"):
                b[0][...] = 0
    _equal(sync, got)
    ds.close()


def test_worker_exception_raises_with_traceback(tmp_path):
    path = str(tmp_path / "doomed.h5")
    build_fixture(path, num_images=4, seed=0, image_size=128)
    ds = CocoPoseDataset(path, CFG, augment=False)
    with ShmRingInput(ds, 2, num_workers=1, wire="uint8") as ring:
        os.remove(path)  # the workers open their handle lazily
        with pytest.raises(RuntimeError, match="input worker failed"):
            _collect(ring.batches(0))
    ds.close()


def test_killed_worker_raises_and_leaves_no_segment(fixture_path):
    ds = CocoPoseDataset(fixture_path, CFG, augment=False)
    with ShmRingInput(ds, 2, num_workers=1, wire="uint8") as ring:
        segment = _segment(ring)
        it = ring.batches(0)
        next(it)
        ring._procs[0].kill()
        t0 = time.monotonic()
        with pytest.raises(WorkerDied, match="worker died"):
            list(it)
        assert time.monotonic() - t0 < 30.0
    assert not os.path.exists(segment)
    assert all(not p.is_alive() for p in ring._procs)
    ds.close()


def test_supervised_rebuild_stays_bit_identical_and_is_bounded(
        fixture_path):
    ds = CocoPoseDataset(fixture_path, CFG, augment=True, seed=11)
    sync = list(batches(ds, 2, 0, wire="uint8"))
    with ShmRingInput(ds, 2, num_workers=2, wire="uint8",
                      supervise=True) as ring:
        it = ring.batches(0)
        got = [tuple(np.copy(x) for x in next(it))]
        for p in ring._procs:
            p.kill()
        got += _collect(it)
        assert ring.rebuilds_total >= 1
        segment = _segment(ring)
        ring.max_rebuilds = 0
        it = ring.batches(1)
        next(it)
        ring._procs[0].kill()
        with pytest.raises(RuntimeError, match="looks deterministic"):
            list(it)
    _equal(sync, got)
    assert not os.path.exists(segment)
    ds.close()


def _host_batches(n, delay=0.0):
    for i in range(n):
        if delay:
            time.sleep(delay)
        yield (np.full((2, 4, 4, 3), i, np.uint8),
               np.ones((2, 1, 1, 1), np.float32))


def test_prefetch_order_content_and_depth_zero():
    for depth in (2, 0):
        out = list(device_prefetch(_host_batches(5), "cpu", depth=depth))
        assert len(out) == 5
        for i, (img, mask) in enumerate(out):
            assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
            assert int(img[0, 0, 0, 0]) == i and mask.shape == (2, 1, 1, 1)


def test_prefetch_error_propagates_and_slow_consumer_ends():
    def bad():
        yield next(_host_batches(1))
        raise RuntimeError("boom in producer")

    it = device_prefetch(bad(), "cpu", depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="boom in producer"):
        list(it)

    got = []

    def consume():
        for b in device_prefetch(_host_batches(6), "cpu", depth=1):
            time.sleep(0.02)
            got.append(b)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=20.0)
    assert not t.is_alive() and len(got) == 6


def test_prefetch_early_abandon_stops_producer_and_refuses_options():
    it = device_prefetch(_host_batches(50), "cpu", depth=2)
    next(it)
    it.close()
    alive = [t for t in threading.enumerate()
             if t.name == "device-prefetch" and t.is_alive()]
    assert not alive, "producer thread still running after close()"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        device_prefetch(_host_batches(1), "cpu", spatial_shard=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        device_prefetch(_host_batches(1), "cpu", phase_stats=object())
