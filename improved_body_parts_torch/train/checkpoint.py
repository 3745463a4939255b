"""Checkpointing: sync helpers and the async manager (counterpart of
``improved_body_parts_tpu/train/checkpoint.py``, with ``torch.save`` in
place of Orbax).

The on-disk protocol is the JAX package's:

- one directory per saved epoch, ``<dir>/epoch_<N>/``, holding the
  payload (``state.pt``) and, strictly after it is written, an atomic
  strict-JSON ``COMMIT.json`` marker with the run metadata.  An entry
  without its marker is in flight or the debris of a killed run:
  ``latest_checkpoint`` / ``restore_latest`` skip it and retention never
  deletes it;
- a sidecar in-flight stamp ``<dir>/.inflight_epoch_<N>``, written before
  the payload and removed after the marker, keeps a killed save out of
  the legacy rule (a directory where no entry carries a marker predates
  the protocol, and its unmarked entries are accepted).

The payload holds the model ``state_dict`` (parameters and BN running
stats), the optimizer's state (the momentum trace by parameter name and
the schedule's update count), ``step``, ``epoch``, ``train_loss``,
``best_loss`` and the SWA fields (``swa_params`` by parameter name,
``swa_count``, ``swa_start_step``; None outside the SWA stage).  It is read back with ``torch.load(weights_only=True)``.

:class:`CheckpointManager` splits a save in two, as the JAX manager does:

- **snapshot** (the caller's thread, the only part that blocks): the
  port's train step updates parameters and momentum IN PLACE, so a
  checkpoint must own a copy before the next step runs.  Every
  device→host copy is enqueued into pinned host buffers with
  ``non_blocking=True`` (all in flight together), then one CUDA event is
  synchronised, and only then are the host tensors handed to the writer.
  The pinned buffers are kept and reused by the next save, which waits
  for the previous write first;
- **serialize + commit** (one background writer thread): ``torch.save``,
  the commit marker, then retention GC.  A writer failure is re-raised
  from the next ``save()`` or ``wait()``.

The manager's spans go to the port's ``obs.trace`` tracer, one
``checkpoint`` event a commit to its ``obs.events`` sink, and its
registry metrics (``checkpoint_seconds{phase=blocked|snapshot|serialize|
commit}``, ``checkpoint_bytes``, ``checkpoints_retained``) to
``registry`` (the process default unless a run passes its own).

Across ranks: every rank calls ``save`` (a partitioned state's split
leaves are all-gathered to full tensors first, so the file is the
single-process one), and only the lead host writes the payload, the
marker and the in-flight stamp and runs retention.  Each marker carries
the device-topology stamp (``parallel.mesh.mesh_topology``, with the
ruleset fingerprint of a partitioned run) that
``train.supervisor.reshard_on_topology_change`` checks on resume;
:func:`restore_checkpoint` fills a full state, and the step (or the
reshard) lays it out on whatever mesh is current.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..obs.events import _definan, get_sink
from ..obs.trace import get_tracer
from .state import TrainState

COMMIT_MARKER = "COMMIT.json"
COMMIT_FORMAT = 1
PAYLOAD_FILE = "state.pt"


def _named_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of the payload by a flat name: ``model/<key>`` for the
    state_dict, ``momentum/<param name>`` for the trace,
    ``optimizer/count``, and ``swa/<param name>`` for the SWA average.
    Split leaves of a partitioned state come back full (a collective)."""
    model = state.model
    out = {f"model/{k}": v for k, v in model.state_dict().items()}
    opt = state.optimizer
    if opt is not None:
        names = {p: n for n, p in model.named_parameters()}
        for p, buf in zip(opt.params, opt.momentum):
            out[f"momentum/{names[p]}"] = buf
        out["optimizer/count"] = opt.count
    for name, t in (state.swa_params or {}).items():
        out[f"swa/{name}"] = t
    if state.sharding is not None:
        out = state.sharding.full_named(out)
    return out


def _swa_fields(state: TrainState) -> Dict[str, Any]:
    return {"swa_count": state.swa_count,
            "swa_start_step": state.swa_start_step}


def snapshot_to_host(tensors: Dict[str, torch.Tensor],
                     buffers: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Host copies of ``tensors`` that the snapshot owns.

    CUDA tensors: every copy goes into a pinned host buffer with
    ``non_blocking=True``, all enqueued before any is waited on; one
    event recorded after the last copy is then synchronised, so the
    copies have landed when this returns (the caller's next in-place
    step cannot reach them).  ``buffers`` (name → pinned tensor) are
    reused where shape and dtype match; new ones are added to it.  CPU
    tensors are cloned."""
    buffers = {} if buffers is None else buffers
    out: Dict[str, torch.Tensor] = {}
    pending = False
    for name, t in tensors.items():
        t = t.detach()
        if t.device.type != "cuda":
            out[name] = t.clone()
            continue
        host = buffers.get(name)
        if host is None or host.shape != t.shape or host.dtype != t.dtype:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buffers[name] = host
        host.copy_(t, non_blocking=True)
        out[name] = host
        pending = True
    if pending:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return out


def _payload(host: Dict[str, torch.Tensor], step: int, epoch: int,
             train_loss: float, best_loss: float,
             swa: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint dict from a host snapshot of :func:`_named_state`
    and the state's :func:`_swa_fields`."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in host.items()
                if k.startswith(prefix)}

    model, momentum, swa_params = part("model/"), part("momentum/"), \
        part("swa/")
    count = host.get("optimizer/count")
    has_swa = swa["swa_count"] is not None
    return {
        "swa_params": swa_params if has_swa else None,
        "swa_count": int(swa["swa_count"]) if has_swa else None,
        "swa_start_step": (None if swa["swa_start_step"] is None
                           else int(swa["swa_start_step"])),
        "model": model,
        "optimizer": (None if count is None else
                      {"momentum": momentum, "count": int(count)}),
        "step": int(step),
        "epoch": int(epoch),
        "train_loss": float(train_loss),
        "best_loss": float(best_loss),
    }


def _payload_bytes(host: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() * t.element_size() for t in host.values()))


def _marker_meta(epoch: int, train_loss: float, best_loss: float,
                 payload_bytes: int, **extra) -> Dict[str, Any]:
    """The commit marker's base schema — one construction site for the
    sync and the async save paths, so the schema cannot drift."""
    meta = {
        "format": COMMIT_FORMAT, "epoch": epoch,
        "train_loss": float(train_loss), "best_loss": float(best_loss),
        "metric": "train_loss", "metric_value": float(train_loss),
        "payload_bytes": int(payload_bytes),
    }
    meta.update(extra)
    return meta


def _write_marker(path: str, meta: Dict[str, Any]) -> None:
    """Atomic commit: the marker appears complete or not at all (tmp +
    ``os.replace``).  Strict JSON: a non-finite loss (the first save's
    best_loss=inf, a diverged run) becomes its string name, never a bare
    ``NaN``/``Infinity`` token."""
    marker = os.path.join(path, COMMIT_MARKER)
    tmp = marker + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_definan(meta), f, indent=2, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, marker)


def is_committed(path: str) -> bool:
    """True when ``path`` carries a commit marker (written strictly after
    the payload)."""
    return os.path.isfile(os.path.join(path, COMMIT_MARKER))


def _inflight_stamp(directory: str, epoch: int) -> str:
    """Sidecar path marking ``epoch_<N>`` as being written by the commit
    protocol: written before the payload, removed strictly after the
    marker.  A sidecar, not a file inside the entry, because a save
    recreates the entry directory.  It keeps a new-protocol save killed
    mid-write out of the legacy rule of :func:`latest_checkpoint`."""
    return os.path.join(directory, f".inflight_epoch_{epoch}")


def read_commit_meta(path: str) -> Optional[Dict[str, Any]]:
    """The commit marker's metadata, or None (uncommitted / legacy /
    torn marker)."""
    try:
        with open(os.path.join(path, COMMIT_MARKER)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class TorchSaveWriter:
    """Writes a payload dict as ``<path>/state.pt``, recreating ``path``
    (a stale marker of an earlier save there must not outlive it)."""

    def save(self, path: str, payload: Dict[str, Any]) -> None:
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        torch.save(payload, os.path.join(path, PAYLOAD_FILE))


def _default_topology(state: TrainState) -> Dict[str, Any]:
    from ..parallel.mesh import mesh_topology

    return mesh_topology(device=next(state.model.parameters()).device)


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    train_loss: float, best_loss: float,
                    topology: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous save of ``<directory>/epoch_<N>`` (snapshot, write and
    commit marker in the caller's thread); returns the path.  The async
    path is :class:`CheckpointManager`.  ``topology`` is the stamp
    (default: this process's, ``parallel.mesh.mesh_topology``)."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"epoch_{epoch}")
    host = snapshot_to_host(_named_state(state))
    os.makedirs(directory, exist_ok=True)
    stamp = _inflight_stamp(directory, epoch)
    open(stamp, "w").close()
    TorchSaveWriter().save(path, _payload(host, state.step, epoch,
                                          train_loss, best_loss,
                                          _swa_fields(state)))
    _write_marker(path, _marker_meta(
        epoch, train_loss, best_loss, _payload_bytes(host),
        topology=topology or _default_topology(state),
        time_unix=round(time.time(), 3)))
    try:
        os.remove(stamp)
    except OSError:
        pass
    return path


def restore_checkpoint(path: str, state: Optional[TrainState] = None):
    """Load a checkpoint.  Without ``state``, return the payload dict
    (tensors on the CPU).  With ``state``, copy the payload into it on the
    state's own device — parameters and BN running stats, every momentum
    buffer, the update count, the step and the SWA fields — and return
    ``(state, meta)`` (resume semantics of train_distributed.py:149-197).

    A checkpoint without optimizer state keeps the state's own.  ``meta``
    prefers the commit marker's ``best_loss``/``metric``/``metric_value``:
    the marker is written (and possibly amended) after validation ran,
    the payload's copy is the value known when the save began; it also
    carries the marker's ``topology`` stamp.  A partitioned ``state`` is
    made full first (a collective: every rank restores together); the
    step lays it out again."""
    payload = torch.load(os.path.join(os.path.abspath(path), PAYLOAD_FILE),
                         map_location="cpu", weights_only=True)
    if state is None:
        return payload
    if state.sharding is not None:
        state.sharding.unshard(state)
    model = state.model
    model.load_state_dict(payload["model"], strict=True)
    opt = payload.get("optimizer")
    if opt is not None and state.optimizer is not None:
        names = {p: n for n, p in model.named_parameters()}
        with torch.no_grad():
            for p, buf in zip(state.optimizer.params,
                              state.optimizer.momentum):
                buf.copy_(opt["momentum"][names[p]])
            state.optimizer.count.fill_(int(opt["count"]))
    state.step = int(payload["step"])
    dev = next(model.parameters()).device
    swa = payload.get("swa_params")
    state.swa_params = (None if swa is None else
                        {k: v.to(dev) for k, v in swa.items()})
    state.swa_count = payload.get("swa_count")
    state.swa_start_step = payload.get("swa_start_step")
    meta = {k: payload[k] for k in ("epoch", "train_loss", "best_loss")}
    marker = read_commit_meta(path)
    if marker:
        for k in ("best_loss", "metric", "metric_value", "topology"):
            if k in marker:
                meta[k] = marker[k]
    return state, meta


def _epoch_dirs(directory: str):
    """(epoch, abs path) for every ``epoch_<N>`` entry, unsorted."""
    out = []
    for name in os.listdir(directory):
        if name.startswith("epoch_"):
            try:
                out.append((int(name.split("_")[1]),
                            os.path.join(directory, name)))
            except ValueError:
                continue
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest *restorable* checkpoint under ``directory``.

    Restorable = committed (carries ``COMMIT.json``).  When no entry in
    the directory carries a marker, the whole directory predates the
    commit protocol and every ``epoch_<N>`` entry is accepted, except one
    with an in-flight stamp (a new-protocol save killed before its
    marker).  In a marked directory an unmarked entry is an in-flight or
    killed save and is skipped, so ``--resume auto`` lands on the last
    committed epoch."""
    if not os.path.isdir(directory):
        return None
    entries = _epoch_dirs(directory)
    if not entries:
        return None
    any_committed = any(is_committed(p) for _, p in entries)
    candidates = ([(e, p) for e, p in entries if is_committed(p)]
                  if any_committed else
                  [(e, p) for e, p in entries
                   if not os.path.exists(_inflight_stamp(directory, e))])
    if not candidates:
        return None
    return max(candidates)[1]


def restore_latest(directory: str, state: Optional[TrainState] = None):
    """``restore_checkpoint(latest_checkpoint(directory), state)`` — the
    resume entry point (``cli.train --resume auto``).  None when the
    directory holds no committed (or legacy) checkpoint."""
    path = latest_checkpoint(directory)
    if path is None:
        return None
    return restore_checkpoint(path, state)


class CheckpointManager:
    """Async, in-place-safe, crash-safe per-epoch checkpointing.

    ::

        manager = CheckpointManager(ckpt_dir, keep_last_n=3)
        for epoch ...:
            state, train_loss = train_epoch(...)
            manager.save(state, epoch, train_loss, best_loss)  # snapshot
            val_loss = eval_epoch(...)       # overlaps the write
            manager.record_metric(epoch, "val_loss", val_loss, best_loss)
        manager.close()                      # flush the pending write

    ``save()`` blocks only on the previous save's write (which bounds the
    dirty state to one epoch and frees the pinned buffers for reuse) and
    on the device→host snapshot (:func:`snapshot_to_host`).  ``torch.save``,
    the commit marker and retention GC run on one background writer
    thread; ``save(async ...)`` off writes in the caller's thread.

    Retention: ``keep_last_n`` (0 keeps everything), plus the best
    checkpoint by recorded metric when ``keep_best``, plus every epoch
    divisible by ``milestone_every`` when set.  GC deletes only
    committed checkpoints.

    ``blocked_seconds`` and ``write_seconds`` keep each save's time in the
    caller's thread and its writer's time (``torch.save`` + commit).

    On a rank other than 0 (:attr:`is_lead_host` False) ``save`` takes
    part in the gather of a partitioned state and writes nothing.
    ``topology``
    is each marker's stamp (default: this process's
    ``parallel.mesh.mesh_topology``)."""

    def __init__(self, directory: str, *, async_save: bool = True,
                 keep_last_n: int = 0, keep_best: bool = True,
                 milestone_every: int = 0, registry=None,
                 topology: Optional[Dict[str, Any]] = None,
                 _commit_delay_s: float = 0.0):
        self.directory = os.path.abspath(directory)
        self.topology = topology
        # metrics registry: the process-wide default unless a run plumbs
        # its own
        self._reg = registry
        self.async_save = bool(async_save)
        self.keep_last_n = int(keep_last_n)
        self.keep_best = bool(keep_best)
        self.milestone_every = int(milestone_every)
        # fault-injection seam for the kill-during-write tests: sleep
        # between the payload write and the commit marker, the window a
        # crash leaves a complete but uncommitted directory in
        self._commit_delay_s = float(_commit_delay_s)
        self._writer = TorchSaveWriter()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # pinned host buffers of the snapshot, reused save to save
        self._buffers: Dict[str, torch.Tensor] = {}
        # epoch -> (metric name, value), the keep-best input; rebuilt
        # from the commit markers so retention holds across a resume
        self._metric: Dict[int, Tuple[str, float]] = {}
        # epoch -> metadata recorded after its save began (val_loss lands
        # mid-write): merged into the marker at commit, or amended into
        # a marker already written
        self._pending_meta: Dict[int, Dict[str, Any]] = {}
        self._committed: set = set()
        self.blocked_seconds: list = []
        self.write_seconds: list = []
        os.makedirs(self.directory, exist_ok=True)
        for epoch, path in _epoch_dirs(self.directory):
            meta = read_commit_meta(path)
            if meta is not None:
                self._committed.add(epoch)
                self._metric[epoch] = (
                    str(meta.get("metric", "train_loss")),
                    float(meta.get("metric_value",
                                   meta.get("train_loss", 0.0))))

    @classmethod
    def from_config(cls, directory: str, train_cfg, registry=None,
                    topology: Optional[Dict[str, Any]] = None
                    ) -> "CheckpointManager":
        """Build from ``TrainConfig`` knobs (``async_checkpoint``,
        ``keep_last_n``, ``keep_best``, ``milestone_every``), reporting
        to ``registry`` (a run's own, or the process default)."""
        return cls(directory,
                   async_save=getattr(train_cfg, "async_checkpoint", True),
                   keep_last_n=getattr(train_cfg, "keep_last_n", 0),
                   keep_best=getattr(train_cfg, "keep_best", True),
                   milestone_every=getattr(train_cfg, "milestone_every", 0),
                   registry=registry, topology=topology)

    @property
    def is_lead_host(self) -> bool:
        """Rank 0 of the process group (or no group) writes."""
        from ..parallel.mesh import process_index

        return process_index() == 0

    # ------------------------------------------------------------- save
    def save(self, state: TrainState, epoch: int, train_loss: float,
             best_loss: float) -> str:
        """Begin the save of ``epoch``; returns its (future) path.  When
        this returns the snapshot is the manager's own: the caller may
        step the state in place."""
        t_start = time.perf_counter()
        self.wait()  # the previous write, and its pinned buffers
        wait_s = time.perf_counter() - t_start
        path = os.path.join(self.directory, f"epoch_{epoch}")
        if not self.is_lead_host:
            if state.sharding is not None:
                _named_state(state)  # the lead host's gather
            return path
        t0 = time.perf_counter()
        with get_tracer().span("snapshot", track="checkpoint",
                               args={"epoch": epoch}):
            host = snapshot_to_host(_named_state(state), self._buffers)
        snapshot_s = time.perf_counter() - t0
        payload = _payload(host, state.step, epoch, train_loss, best_loss,
                           _swa_fields(state))
        base_meta = _marker_meta(
            epoch, train_loss, best_loss, _payload_bytes(host),
            topology=self.topology or _default_topology(state),
            **{"async": self.async_save})
        timings = {"wait_s": wait_s, "snapshot_s": snapshot_s}
        with self._lock:
            # an earlier run's commit of this epoch is being replaced:
            # record_metric must wait for the new marker, not amend the
            # old one while the writer recreates the directory
            self._committed.discard(epoch)
        # before the write starts; removed after the marker lands
        open(_inflight_stamp(self.directory, epoch), "w").close()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_and_commit,
                args=(path, payload, epoch, base_meta, timings),
                name="ckpt-writer", daemon=True)
            self._thread.start()
        else:
            self._write_and_commit(path, payload, epoch, base_meta, timings)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        blocked = time.perf_counter() - t_start
        self.blocked_seconds.append(blocked)
        self._observe("blocked", blocked)
        self._observe("snapshot", snapshot_s)
        self._registry().gauge(
            "checkpoint_bytes",
            "host-snapshot size of the last checkpoint payload").set(
                float(base_meta["payload_bytes"]))
        return path

    def record_metric(self, epoch: int, name: str, value: float,
                      best_loss: Optional[float] = None) -> None:
        """Attach the post-eval metric to ``epoch``'s checkpoint: merged
        into its marker at commit if the writer has not committed yet,
        amended into the marker atomically if it has.  Also feeds
        keep-best retention."""
        meta = {"metric": str(name), "metric_value": float(value)}
        if best_loss is not None:
            meta["best_loss"] = float(best_loss)
        if not self.is_lead_host:
            return
        # the commit transition happens under the same lock in
        # _write_and_commit, so exactly one branch fires
        with self._lock:
            self._metric[epoch] = (str(name), float(value))
            if epoch not in self._committed:
                self._pending_meta.setdefault(epoch, {}).update(meta)
            else:
                path = os.path.join(self.directory, f"epoch_{epoch}")
                marker = read_commit_meta(path) or {}
                marker.update(meta)
                _write_marker(path, marker)

    def wait(self) -> None:
        """Join the in-flight write; re-raise its failure."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Flush the in-flight write and release the pinned buffers."""
        self.wait()
        self._buffers.clear()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        # an exception is unwinding: flush, but a writer failure must not
        # mask it
        if exc and exc[0] is not None:
            try:
                self.wait()
            except Exception:  # noqa: BLE001
                pass
        else:
            self.close()

    # ------------------------------------------------------- background
    def _write_and_commit(self, path: str, payload: Dict[str, Any],
                          epoch: int, base_meta: Dict[str, Any],
                          timings: Dict[str, float]) -> None:
        tracer = get_tracer()
        try:
            t0 = time.perf_counter()
            with tracer.span("serialize", track="checkpoint",
                             args={"epoch": epoch}):
                self._writer.save(path, payload)
            serialize_s = time.perf_counter() - t0
            if self._commit_delay_s:
                time.sleep(self._commit_delay_s)
            from .supervisor import chaos_kill_point

            chaos_kill_point("mid_ckpt_write")
            t0 = time.perf_counter()
            with tracer.span("commit", track="checkpoint",
                             args={"epoch": epoch}):
                with self._lock:
                    meta = dict(base_meta)
                    meta.update(self._pending_meta.pop(epoch, {}))
                    meta["time_unix"] = round(time.time(), 3)
                    _write_marker(path, meta)
                    try:
                        os.remove(_inflight_stamp(self.directory, epoch))
                    except OSError:
                        pass
                    self._committed.add(epoch)
                    self._metric.setdefault(
                        epoch, (str(meta["metric"]),
                                float(meta["metric_value"])))
                retained = self._gc()
            commit_s = time.perf_counter() - t0
            self.write_seconds.append(serialize_s + commit_s)
            self._observe("serialize", serialize_s)
            self._observe("commit", commit_s)
            get_sink().emit(
                "checkpoint", epoch=epoch, path=path,
                bytes=base_meta["payload_bytes"],
                wait_s=round(timings["wait_s"], 6),
                snapshot_s=round(timings["snapshot_s"], 6),
                serialize_s=round(serialize_s, 6),
                commit_s=round(commit_s, 6),
                retained=retained, async_save=self.async_save)
        except BaseException as e:  # noqa: BLE001 — surfaced on the
            self._error = e         # caller's thread by wait()/save()

    # -------------------------------------------------------- retention
    def _gc(self) -> int:
        """Delete committed checkpoints outside the retention set; never
        touch uncommitted (in-flight / killed) directories.  Returns the
        retained committed count."""
        entries = _epoch_dirs(self.directory)
        committed = {e: p for e, p in entries if is_committed(p)}
        if self.keep_last_n <= 0:
            self._retained_gauge().set(float(len(committed)))
            return len(committed)
        keep = set(sorted(committed)[-self.keep_last_n:])
        if self.keep_best:
            with self._lock:
                scored = {e: nv for e, nv in self._metric.items()
                          if e in committed}
            # best is best-by-val whenever any committed epoch carries a
            # val score (train loss is systematically lower), and a
            # non-finite score never competes (a NaN would win min())
            scored = {e: (n, v) for e, (n, v) in scored.items()
                      if math.isfinite(v)}
            val = {e: v for e, (n, v) in scored.items() if n == "val_loss"}
            pool = val or {e: v for e, (n, v) in scored.items()}
            if pool:
                keep.add(min(pool, key=pool.get))
        if self.milestone_every > 0:
            keep.update(e for e in committed
                        if e % self.milestone_every == 0)
        for e, p in committed.items():
            if e not in keep:
                shutil.rmtree(p, ignore_errors=True)
        self._retained_gauge().set(float(len(keep)))
        return len(keep)

    # -------------------------------------------------------------- obs
    def _registry(self):
        if self._reg is not None:
            return self._reg
        from ..obs.registry import get_registry

        return get_registry()

    def _retained_gauge(self):
        return self._registry().gauge(
            "checkpoints_retained",
            "committed checkpoints kept after retention GC")

    def _observe(self, phase: str, seconds: float) -> None:
        self._registry().histogram(
            "checkpoint_seconds",
            "checkpoint phase durations (blocked = train-loop stall)",
            labels={"phase": phase}).observe(seconds)
