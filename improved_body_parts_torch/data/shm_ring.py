"""Zero-copy shared-memory input pipeline: persistent workers + a slot
ring (counterpart of ``improved_body_parts_tpu/data/shm_ring.py``, NumPy
and ``multiprocessing`` only).

Only slot tokens and index lists ever cross a queue:

- one ``multiprocessing.shared_memory`` block holds ``slots``
  preallocated batch slots (images / mask_miss / labels-or-joints arrays
  at the batch shape) and a small int64 seqlock header per slot;
- persistent ``spawn`` workers, each with its own dataset (the same
  ``(seed, epoch, index)`` draws as the in-process path), take
  ``(generation, seq, epoch, batch_idx, slot, indices)`` tasks and render
  each sample in place into the slot's rows (the uint8 warp writes
  straight into shared memory);
- the consumer yields completions in strict task (``seq``) order, so the
  sample stream is bit-identical to ``pipeline="sync"`` for any worker
  count, as read-only views into the slot, and takes the slot back when
  the caller advances the generator.  ``parallel.prefetch.
  device_prefetch`` copies each batch to the device before it advances.

Each slot's header carries ``[seq, epoch, batch_idx]``: the worker makes
``seq`` odd before writing and even after, and the consumer checks that
``seq`` is even and ``(epoch, batch_idx)`` match before it yields, so a
breach of slot ownership is an error, never a corrupted sample.

Workers are spawned, never forked: a fork after the parent holds a CUDA
context is unsafe.  A worker imports this package (``torch`` included)
but never touches ``torch.cuda``.  The worker's dataset is rebuilt from
its HDF5 path (``CocoPoseDataset``) or, for a dataset held in memory
(``MemoryDataset``, used where h5py is missing), from its records,
pickled to the spawn target once at start-up.

``close()``, and a finalizer when the ring is dropped, stop the workers
and unlink the shared-memory block; a worker whose consumer was killed
exits on its own (it polls its parent's pid).  Under ``supervise=True`` a
dead worker makes the ring rebuild itself (every worker respawned, the
lost tasks rendered again under their seq numbers), so the stream goes
on bit-identical; otherwise it raises :class:`WorkerDied`.
"""
from __future__ import annotations

import os
import queue
import time
import traceback
import weakref
from typing import Iterator, List, Optional, Tuple

import numpy as np

_HEADER_INTS = 3  # per-slot seqlock header: [seq, epoch, batch_idx]
_ALIGN = 64


class WorkerDied(RuntimeError):
    """An input worker process died while the consumer waited.

    Fatal by default (the historical contract: fail loudly, never hang);
    under ``ShmRingInput(supervise=True)`` the consumer catches it and
    rebuilds the ring instead — see :meth:`ShmRingInput._rebuild`."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def batch_wire_format(config, batch_size: int, raw_gt: int = 0,
                      wire: str = "uint8"
                      ) -> Tuple[Tuple[str, ...], Tuple[Tuple[int, ...], ...],
                                 Tuple[str, ...]]:
    """(names, shapes, dtypes) of one batch slot.

    ``wire="uint8"`` ships images as uint8 HWC (the default wire; 4x fewer
    bytes both across IPC and host->device), ``"f32"`` as float32 in [0, 1]
    (the legacy format).  Masks and labels/joints are float32 either way —
    in device-GT mode (``raw_gt > 0``) the slot carries only padded joints
    + masks, as the synchronous path does.
    """
    if wire not in ("uint8", "f32"):
        raise ValueError(f"unknown wire format {wire!r}; use 'uint8' or 'f32'")
    sk = config.skeleton
    gh, gw = sk.grid_shape
    names = ["images", "mask_miss"]
    shapes = [(batch_size, sk.height, sk.width, 3), (batch_size, gh, gw, 1)]
    dtypes = ["uint8" if wire == "uint8" else "float32", "float32"]
    if raw_gt > 0:
        names += ["joints", "mask_all"]
        shapes += [(batch_size, raw_gt, sk.num_parts, 3),
                   (batch_size, gh, gw, 1)]
        dtypes += ["float32", "float32"]
    else:
        names += ["labels"]
        shapes += [(batch_size, gh, gw, sk.num_layers)]
        dtypes += ["float32"]
    return tuple(names), tuple(shapes), tuple(dtypes)


def _slot_layout(shapes, dtypes) -> Tuple[List[int], int]:
    """Field byte offsets within one slot + the aligned slot size."""
    offsets, off = [], 0
    for shape, dtype in zip(shapes, dtypes):
        offsets.append(off)
        off += _align(int(np.prod(shape)) * np.dtype(dtype).itemsize)
    return offsets, off


def _attach_shm(name: str):
    """Attach to an existing block without registering it with the (shared)
    resource_tracker daemon — the consumer owns the block's lifetime, and a
    worker-side registration would make the tracker double-unlink it at
    exit (py3.10 has no ``track=False`` yet)."""
    from multiprocessing import resource_tracker, shared_memory

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


def _quiet_close(shm) -> None:
    """Close a SharedMemory mapping, tolerating live buffer exports.

    A view yielded to a consumer (or still referenced by a worker frame)
    makes ``mmap.close()`` raise BufferError; the mapping is reclaimed by
    the OS at process exit regardless, so detach the handles to keep
    ``SharedMemory.__del__`` from retrying and spamming stderr."""
    try:
        shm.close()
    except BufferError:
        shm._mmap = None  # noqa: SLF001 — freed when the last view dies
        shm._buf = None   # noqa: SLF001


def _slot_views(buf, slots: int, shapes, dtypes, writeable: bool):
    """header array + per-slot field views into ``buf``."""
    offsets, slot_bytes = _slot_layout(shapes, dtypes)
    header_bytes = _align(slots * _HEADER_INTS * 8)
    header = np.frombuffer(buf, np.int64, slots * _HEADER_INTS
                           ).reshape(slots, _HEADER_INTS)
    header.flags.writeable = writeable
    views = []
    for s in range(slots):
        base = header_bytes + s * slot_bytes
        fields = []
        for shape, dtype, off in zip(shapes, dtypes, offsets):
            v = np.frombuffer(buf, np.dtype(dtype), int(np.prod(shape)),
                              offset=base + off).reshape(shape)
            v.flags.writeable = writeable
            fields.append(v)
        views.append(tuple(fields))
    return header, views


def dataset_spec(dataset):
    """What a spawn worker rebuilds ``dataset`` from: its HDF5 path, or
    its records when it is held in memory (``MemoryDataset``), with its
    config, augmentation flag and seed."""
    source = (("h5", dataset.h5_path) if dataset.h5_path is not None
              else ("records", dataset.records))
    return source + (dataset.config, dataset.augment, dataset.seed)


def _open_dataset(spec):
    kind, source, config, augment, seed = spec
    from .dataset import CocoPoseDataset, MemoryDataset

    cls = CocoPoseDataset if kind == "h5" else MemoryDataset
    return cls(source, config, augment=augment, seed=seed)


def _ring_worker(worker_id: int, shm_name: str, slots: int, shapes, dtypes,
                 spec, raw_gt: int, wire: str, task_q, done_q,
                 parent_pid: int = 0) -> None:
    """Persistent worker entry (the spawn target; never touches CUDA).

    Renders each task's samples directly into the slot's shared-memory
    rows under the slot seqlock; only ``("ok"|"err", generation, seq,
    (slot, worker_id, render_seconds, render_start_monotonic)-or-
    (slot, traceback))`` tokens travel back — the render time AND its
    absolute ``time.monotonic()`` start stamp ride along so the consumer
    can export per-worker render histograms and place each render as a
    span on the run's trace timeline (CLOCK_MONOTONIC is system-wide, so
    a worker-process stamp lands correctly among consumer-side spans)
    without a second IPC channel.
    """
    try:
        try:
            import cv2
            cv2.setNumThreads(0)  # one core per worker; no nested pools
        except Exception:  # noqa: BLE001 — determinism aid only
            pass
        try:
            # deprioritize slightly: when workers oversubscribe the host's
            # cores, the consumer's placement/handback is the critical
            # path — starving it stalls the whole ring
            os.nice(2)
        except OSError:
            pass
        shm = _attach_shm(shm_name)
    except BaseException:  # noqa: BLE001 — surfaced by start()
        done_q.put(("init_err", worker_id, -1, traceback.format_exc()))
        return
    try:
        # all numpy views over the mapping live in _worker_loop's frame,
        # so they are released before the close below
        _worker_loop(worker_id, shm, slots, shapes, dtypes, spec, raw_gt,
                     wire, task_q, done_q, parent_pid)
    finally:
        _quiet_close(shm)


def _worker_loop(worker_id: int, shm, slots: int, shapes, dtypes, spec,
                 raw_gt: int, wire: str, task_q, done_q,
                 parent_pid: int = 0) -> None:
    try:
        header, views = _slot_views(shm.buf, slots, shapes, dtypes,
                                    writeable=True)
        ds = _open_dataset(spec)
        done_q.put(("ready", worker_id, -1, -1))
    except BaseException:  # noqa: BLE001 — surfaced by start()
        done_q.put(("init_err", worker_id, -1, traceback.format_exc()))
        return
    try:
        while True:
            try:
                task = task_q.get(timeout=2.0)
            except queue.Empty:
                # orphan watchdog: a SIGKILLed consumer (preemption,
                # OOM-killer, the chaos harness) runs no cleanup and
                # never sends the poison pill — daemon=True only helps
                # on orderly interpreter exit.  A reparented worker
                # would otherwise block on this queue forever, which is
                # exactly the "leaked ring workers" the chaos harness
                # asserts against.
                if parent_pid and os.getppid() != parent_pid:
                    return
                continue
            if task is None:
                return
            gen, seq, epoch, batch_idx, slot, idxs = task
            try:
                # monotonic, not perf_counter: the stamp crosses the
                # process boundary and must share the consumer's clock
                t_render = time.monotonic()
                header[slot, 0] += 1  # odd: write in progress
                fields = views[slot]
                for row, index in enumerate(idxs):
                    # bind the row view ONCE: indexing creates a fresh view
                    # object per evaluation, so an inline
                    # `img is not fields[0][row]` would always be true and
                    # re-copy the already-in-place image onto itself
                    img_row = fields[0][row]
                    if raw_gt > 0:
                        img, mm, joints, mask_all = ds.sample_raw(
                            index, epoch, max_people=raw_gt, wire=wire,
                            image_out=img_row)
                        if img is not img_row:
                            img_row[...] = img
                        fields[1][row] = mm
                        fields[2][row] = joints
                        fields[3][row] = mask_all
                    else:
                        img, mm, labels = ds.sample(
                            index, epoch, wire=wire, image_out=img_row)
                        if img is not img_row:
                            img_row[...] = img
                        fields[1][row] = mm
                        fields[2][row] = labels
                header[slot, 1] = epoch
                header[slot, 2] = batch_idx
                header[slot, 0] += 1  # even: slot consistent
                done_q.put(("ok", gen, seq,
                            (slot, worker_id,
                             time.monotonic() - t_render, t_render)))
            except Exception:  # noqa: BLE001 — consumer re-raises
                if header[slot, 0] % 2:
                    # restore seqlock parity: the slot is reclaimed after
                    # an error, and a stuck-odd seq would make its next
                    # (correct) use trip _check_header spuriously
                    header[slot, 0] += 1
                done_q.put(("err", gen, seq,
                            (slot, traceback.format_exc())))
    finally:
        ds.close()


class ShmRingInput:
    """Persistent shared-memory ring pipeline over one dataset.

    Construct once (workers spawn, corpus opens, ~seconds) and reuse across
    epochs — ``batches(epoch)`` is a per-epoch generator with the exact
    ``data.batches`` yield contract.  Yielded arrays are READ-ONLY views
    into the ring: they are valid until the generator is advanced (or
    closed); place them on device or copy before the next ``next()``.
    ``parallel.prefetch.device_prefetch`` honours this contract (its copy
    to the device has completed before it advances the source).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int,
                 raw_gt: int = 0, wire: str = "uint8", slots: int = 0,
                 start_timeout: float = 120.0, supervise: bool = False,
                 max_rebuilds: int = 3):
        if num_workers < 1:
            raise ValueError("ShmRingInput needs num_workers >= 1; use the "
                             "synchronous path for in-process loading")
        import multiprocessing as mp
        from multiprocessing import shared_memory

        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.raw_gt = raw_gt
        self.wire = wire
        # supervise=True: a dead worker triggers a ring REBUILD (all
        # workers respawned, lost tasks re-rendered, the stream resumes
        # bit-identically) instead of the fatal WorkerDied — the elastic
        # training mode (cli.train --supervised).  max_rebuilds
        # bounds CONSECUTIVE rebuilds with no yielded batch in between,
        # so a deterministically-crashing worker cannot respawn forever.
        self.supervise = bool(supervise)
        self.max_rebuilds = int(max_rebuilds)
        self._consecutive_rebuilds = 0
        self.rebuilds_total = 0
        self._tele = None          # obs.Registry, via attach_telemetry
        self._tele_prefix = "input_ring"
        self._render_hists = {}    # worker_id -> Histogram
        self._rebuilds_counter = None
        self.slots = slots if slots > 0 else num_workers + 2
        self._spec = dataset_spec(dataset)
        self.names, self.shapes, self.dtypes = batch_wire_format(
            dataset.config, batch_size, raw_gt=raw_gt, wire=wire)
        _, slot_bytes = _slot_layout(self.shapes, self.dtypes)
        total = _align(self.slots * _HEADER_INTS * 8) + self.slots * slot_bytes

        # spawn, not fork: a fork after the parent holds a CUDA context
        # (or runs threads) is unsafe; workers start ONCE, not per epoch
        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self._start_timeout = float(start_timeout)
        self._shm = shared_memory.SharedMemory(create=True, size=total)
        # pre-fault the whole block now: otherwise every slot's first use
        # pays its page faults inside the training (or benchmark) window
        np.frombuffer(self._shm.buf, np.uint8).fill(0)
        self._header, self._views = _slot_views(
            self._shm.buf, self.slots, self.shapes, self.dtypes,
            writeable=False)
        self._task_q = ctx.Queue()
        self._done_q = ctx.Queue()
        self._procs = [self._make_worker(i) for i in range(num_workers)]
        self._free: List[int] = list(range(self.slots))
        self._gen = 0
        self._closed = False
        # mutable holder so the finalizer tracks the CURRENT task queue
        # across supervised rebuilds (which replace both queues)
        self._qholder = [self._task_q]
        self._finalizer = weakref.finalize(self, ShmRingInput._cleanup,
                                           self._procs, self._qholder,
                                           self._shm)
        try:
            for p in self._procs:
                p.start()
            self._wait_ready(start_timeout)
        except BaseException:
            self.close()
            raise

    # -- lifecycle ---------------------------------------------------------

    def _make_worker(self, worker_id: int):
        """One (unstarted) worker process — shared by the initial spawn
        and the supervised rebuild's respawn."""
        ds = self.dataset
        return self._ctx.Process(
            target=_ring_worker, daemon=True,
            name=f"shm-ring-worker-{worker_id}",
            args=(worker_id, self._shm.name, self.slots, self.shapes,
                  self.dtypes, self._spec, self.raw_gt, self.wire,
                  self._task_q, self._done_q, os.getpid()))

    def _wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        ready = 0
        while ready < self.num_workers:
            msg = self._next_done(deadline=deadline,
                                  what="worker start-up")
            if msg[0] == "ready":
                ready += 1
            elif msg[0] == "init_err":
                raise RuntimeError(
                    f"input worker {msg[1]} failed to start:\n{msg[3]}")
            # no epoch tasks can be outstanding yet

    @staticmethod
    def _cleanup(procs, qholder, shm) -> None:
        task_q = qholder[0]
        for _ in procs:
            try:
                task_q.put_nowait(None)
            except Exception:  # noqa: BLE001
                pass
        for p in procs:
            if p.pid is None:  # never started (a failed start-up)
                continue
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        try:  # unlink FIRST: close() raises while yielded views are alive,
            shm.unlink()  # and the name must not outlive the pipeline
        except Exception:  # noqa: BLE001 — already unlinked
            pass
        _quiet_close(shm)

    def attach_telemetry(self, registry,
                         prefix: str = "input_ring") -> "ShmRingInput":
        """Export the ring's internals through an ``obs.Registry``:

        - ``<prefix>_slots_total`` / ``<prefix>_free_slots`` — ring
          capacity and live free-slot count (a persistently-zero free
          count means the consumer is the bottleneck, a persistently-full
          one means the workers are);
        - ``<prefix>_consumer_stall_seconds_total`` / ``_stalls_total``
          — time the consumer blocked waiting for a completion with no
          batch ready to yield (the ring-side twin of the train loop's
          data-wait counter);
        - ``<prefix>_render_seconds{worker=N}`` — per-worker render-time
          histograms (a straggler worker shows up as one shifted
          distribution, not a mystery in the aggregate);
        - ``<prefix>_batches_total`` — batches yielded;
        - ``<prefix>_rebuilds_total`` — supervised rebuilds.
        """
        self._tele = registry
        self._tele_prefix = prefix
        registry.gauge(prefix + "_slots_total", "ring capacity "
                       "(batch slots)").set(self.slots)
        # weakref: the registry (often process-global) outlives the
        # ring, and a closure over self would pin the closed ring for
        # process lifetime; a dead ring scrapes as 0
        ref = weakref.ref(self)

        def _free_slots():
            ring = ref()
            return len(ring._free) if ring is not None else 0

        registry.gauge(prefix + "_free_slots",
                       "slots not owned by a worker or in-flight batch",
                       fn=_free_slots)
        self._stall_s = registry.counter(
            prefix + "_consumer_stall_seconds_total",
            "consumer time blocked on the done queue")
        self._stalls = registry.counter(prefix + "_consumer_stalls_total")
        self._batches_total = registry.counter(prefix + "_batches_total")
        self._rebuilds_counter = registry.counter(
            prefix + "_rebuilds_total",
            "supervised ring rebuilds after a worker death")
        return self

    def _observe_render(self, worker_id: int, render_s: float) -> None:
        h = self._render_hists.get(worker_id)
        if h is None:
            h = self._tele.histogram(
                self._tele_prefix + "_render_seconds",
                "per-worker batch render time",
                labels={"worker": str(worker_id)})
            self._render_hists[worker_id] = h
        h.observe(float(render_s))

    def close(self) -> None:
        """Stop workers and release the shared-memory block (idempotent)."""
        if self._closed:
            return
        self._closed = True
        # drop our own buffer exports so the finalizer's close() can
        # actually unmap (yielded views held by callers are tolerated)
        self._header = self._views = None
        self._finalizer()

    def __enter__(self) -> "ShmRingInput":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the per-epoch generator ------------------------------------------

    def _next_done(self, deadline: Optional[float] = None,
                   what: str = "the next batch"):
        """One message off the done queue, surfacing dead workers as a
        raised error instead of an indefinite hang."""
        while True:
            try:
                return self._done_q.get(timeout=0.5)
            except queue.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    codes = ", ".join(
                        f"{p.name} exitcode={p.exitcode}" for p in dead)
                    raise WorkerDied(
                        f"input worker died while the consumer waited for "
                        f"{what} ({codes}); the sample it was rendering is "
                        "lost — restart the pipeline") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"timed out waiting for {what}")

    def _check_header(self, slot: int, epoch: int, batch_idx: int) -> None:
        seq, h_epoch, h_idx = (int(self._header[slot, 0]),
                               int(self._header[slot, 1]),
                               int(self._header[slot, 2]))
        if seq % 2 or (h_epoch, h_idx) != (epoch, batch_idx):
            raise RuntimeError(
                f"ring-slot protocol violation: slot {slot} header "
                f"(seq={seq}, epoch={h_epoch}, batch={h_idx}) does not match "
                f"the completed task (epoch={epoch}, batch={batch_idx})")

    def _rebuild(self, meta, completed, gen: int, why: str) -> None:
        """Supervised recovery from a dead worker: rebuild the whole ring
        in place and re-render the lost tasks.

        Stop-the-world by design — partial recovery (respawn only the
        dead worker) would leave live workers mid-render on slots whose
        ownership the consumer can no longer prove, and the seqlock can
        only detect that corruption, not prevent it.  Sequence:

        1. terminate + join EVERY worker (after this, nothing writes the
           shared block);
        2. drain the done queue — completions that landed before the
           stop are valid rendered batches and are kept;
        3. drain the task queue — tasks nobody picked up would otherwise
           be rendered twice after resubmission;
        4. rebuild the free-slot list from first principles: every slot
           not held by a kept completion is free (the dead worker's slot
           comes back here);
        5. respawn all workers and resubmit the lost tasks under the
           SAME seq numbers — the in-order yield logic never notices the
           failure, so the stream stays bit-identical to the synchronous
           path.

        Consecutive rebuilds with no yielded batch in between are
        bounded by ``max_rebuilds`` — a worker that dies
        deterministically on the same sample must surface as an error,
        not an infinite respawn loop.
        """
        self._consecutive_rebuilds += 1
        self.rebuilds_total += 1
        if self._consecutive_rebuilds > self.max_rebuilds:
            raise RuntimeError(
                f"input ring rebuilt {self._consecutive_rebuilds - 1} "
                "consecutive times without yielding a batch "
                f"(max_rebuilds={self.max_rebuilds}); the worker failure "
                f"looks deterministic — last: {why}")
        t0 = time.perf_counter()
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        # drain completions that raced the stop: current-generation "ok"
        # tokens are finished batches (the data is in the slot and no
        # worker can touch it now); anything else is reclaimed by the
        # free-list rebuild below.  A killed writer can leave a torn
        # pickle in the pipe — tolerated, the batch is simply re-counted
        # as lost.
        while True:
            try:
                kind, g, seq, payload = self._done_q.get(timeout=0.2)
            except queue.Empty:
                break
            except Exception:  # noqa: BLE001 — torn write from the kill
                continue
            if kind == "ok" and g == gen and seq in meta:
                completed[seq] = payload
        # REPLACE both queues instead of reusing them: a worker killed
        # mid-``get``/mid-``put`` dies holding the queue's shared lock,
        # and every later operation on that queue (the respawned
        # workers' get, their ready handshake) deadlocks forever — the
        # documented terminate-vs-Queue hazard.  Replacing also discards
        # any unpicked tasks still buffered in the old feeder thread, so
        # a resubmitted task can never be rendered twice.
        old_task_q, old_done_q = self._task_q, self._done_q
        self._task_q = self._ctx.Queue()
        self._done_q = self._ctx.Queue()
        self._qholder[0] = self._task_q
        for q in (old_task_q, old_done_q):
            try:
                q.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        held = {payload[0] for payload in completed.values()}
        self._free = [s for s in range(self.slots) if s not in held]
        # restore seqlock parity on every reclaimed slot: a worker
        # SIGKILLed MID-WRITE leaves its slot's seq odd, and the
        # respawned worker's parity-based bumps would then publish the
        # re-rendered batch under an odd (apparently in-progress) seq —
        # tripping _check_header on a perfectly good batch.  Every
        # worker is dead here, so the consumer owns the block
        # exclusively and the direct fix is race-free.
        fix = np.frombuffer(self._shm.buf, np.int64,
                            self.slots * _HEADER_INTS
                            ).reshape(self.slots, _HEADER_INTS)
        for s in self._free:
            if fix[s, 0] % 2:
                fix[s, 0] += 1
        del fix  # release the buffer export before any later close()
        lost = sorted(seq for seq in meta if seq not in completed)
        for i in range(self.num_workers):
            self._procs[i] = self._make_worker(i)
            self._procs[i].start()
        self._wait_ready(self._start_timeout)
        for seq in lost:
            epoch, batch_idx, idxs, _ = meta[seq]
            slot = self._free.pop()
            meta[seq] = (epoch, batch_idx, idxs, slot)
            self._task_q.put((gen, seq, epoch, batch_idx, slot, idxs))
        dt = time.perf_counter() - t0
        if self._tele is not None and self._rebuilds_counter is not None:
            self._rebuilds_counter.inc()
        from ..obs.events import get_sink

        get_sink().emit("ring_rebuild", reason=why[:500],
                        lost_tasks=len(lost), kept_completions=len(held),
                        rebuild_s=round(dt, 3),
                        consecutive=self._consecutive_rebuilds)

    def _epoch_tasks(self, epoch: int, process_index: int,
                     process_count: int, shard: str = "strided"):
        """(epoch, batch_idx, indices) task triples for one epoch — the
        same permutation, host shard (``data.dataset.resolve_host_shard``,
        the synchronous path's dispatch) and batching as the synchronous
        path."""
        from .dataset import epoch_permutation, resolve_host_shard

        perm = epoch_permutation(len(self.dataset), epoch, self.dataset.seed)
        rows = resolve_host_shard(perm, process_index, process_count,
                                  self.batch_size, shard=shard)
        for batch_idx, s in enumerate(range(0, len(rows), self.batch_size)):
            yield epoch, batch_idx, [int(i) for i in
                                     rows[s: s + self.batch_size]]

    def batches(self, epoch: int, process_index: int = 0,
                process_count: int = 1, shard: str = "strided"
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield this host's batches for ``epoch`` in deterministic order:
        the stream of ``data.batches(..., pipeline="sync")`` on the same
        wire (same epoch permutation, host shard and per-sample
        ``(seed, epoch, index)`` draws).  ``shard="batch"`` takes the
        contiguous slab of every global batch
        (``data.dataset.host_batch_shard``), whose slabs across hosts
        reassemble the single-host batch bit for bit.  A worker's failure
        raises with its traceback; a dead worker raises
        :class:`WorkerDied`, or under ``supervise=True`` rebuilds the ring
        (:meth:`_rebuild`) and the stream goes on, still bit-identical.
        An abandoned generator's in-flight slots are reclaimed by the next
        generator."""
        return self._run(self._epoch_tasks(epoch, process_index,
                                           process_count, shard))

    def _run(self, task_iter) -> Iterator[Tuple[np.ndarray, ...]]:
        """Drive the ring over ``task_iter`` of (epoch, batch_idx,
        indices), yielding in task order (slot-count batches in flight)."""
        if self._closed:
            raise RuntimeError("ShmRingInput is closed")
        # consumer-side import (workers import this module too and must
        # stay lean); the process tracer is installed by RunTelemetry
        from ..obs.trace import get_tracer

        trace = get_tracer()
        self._gen += 1
        gen = self._gen
        pending = iter(task_iter)
        # seq -> (epoch, batch_idx, indices, slot): everything needed to
        # RE-render a task whose worker died (the supervised rebuild)
        meta = {}
        completed = {}  # seq -> (slot, worker_id, render_s, t_start_mono)
        next_submit = 0
        next_yield = 0
        exhausted = False

        def submit() -> bool:
            nonlocal next_submit, exhausted
            if exhausted or not self._free:
                return False
            task = next(pending, None)
            if task is None:
                exhausted = True
                return False
            epoch, batch_idx, idxs = task
            slot = self._free.pop()
            meta[next_submit] = (epoch, batch_idx, idxs, slot)
            self._task_q.put((gen, next_submit, epoch, batch_idx, slot, idxs))
            next_submit += 1
            return True

        try:
            while True:
                while submit():
                    pass
                while next_yield in completed:
                    slot, wid, render_s, t_start = completed.pop(next_yield)
                    epoch, batch_idx, _, _ = meta.pop(next_yield)
                    self._check_header(slot, epoch, batch_idx)
                    if trace.enabled:
                        # the worker's absolute monotonic start stamp
                        # places its render among consumer-side spans
                        trace.add_span_abs(
                            "render", t_start, render_s,
                            track=f"ring-worker-{wid}",
                            args={"slot": slot, "epoch": epoch,
                                  "batch": batch_idx})
                    if self._tele is not None:
                        self._observe_render(wid, render_s)
                        self._batches_total.inc()
                    try:
                        yield self._views[slot]
                    finally:
                        # the caller advanced (batch on device / copied) —
                        # or closed the generator, which raises
                        # GeneratorExit AT the yield: hand the slot token
                        # back on BOTH paths, or every abandoned generator
                        # leaks the slot it was yielding and the ring
                        # eventually starves
                        self._free.append(slot)
                    next_yield += 1
                    self._consecutive_rebuilds = 0  # real progress
                    submit()
                if exhausted and next_yield >= next_submit:
                    return
                t_stall = time.perf_counter() if self._tele is not None \
                    else 0.0
                try:
                    kind, g, seq, payload = self._next_done(
                        what=f"batch "
                             f"{meta.get(next_yield, ('?', '?'))[1]} of "
                             f"epoch {meta.get(next_yield, ('?', '?'))[0]}")
                except WorkerDied as e:
                    if not self.supervise:
                        raise
                    self._rebuild(meta, completed, gen, str(e))
                    continue
                if self._tele is not None:
                    # blocked with nothing ready to yield: the workers
                    # (or the slot budget) are behind the consumer
                    self._stall_s.inc(time.perf_counter() - t_stall)
                    self._stalls.inc()
                if g != gen:  # stale completion (or stale failure) from an
                    # abandoned generator: reclaim the slot, don't let an
                    # old epoch's error poison this one
                    self._free.append(payload[0])
                    continue
                if kind == "err":
                    slot, tb = payload
                    self._free.append(slot)
                    epoch, batch_idx = meta.pop(seq, ("?", "?", 0, 0))[:2]
                    raise RuntimeError(
                        f"input worker failed on batch {batch_idx} of epoch "
                        f"{epoch}:\n{tb}")
                completed[seq] = payload
        finally:
            # completions already drained off done_q but not yet yielded
            # have no token left anywhere — with multiple workers batch
            # n+1 routinely finishes before batch n, so abandoning at the
            # yield for n would otherwise leak n+1's slot permanently
            self._free.extend(slot for slot, *_ in completed.values())
            completed.clear()
