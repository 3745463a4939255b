"""Epoch-level training loop (counterpart of
``improved_body_parts_tpu/train/loop.py`` ``train_epoch``, ``eval_epoch``
and ``fit``; reference: train.py:104-206, train_distributed.py:225-379).

Each host batch goes to the device through pinned memory with a
``non_blocking`` copy (``train.step.to_device``), so the copy and the
host's work on the next batch overlap the step the device is running; the
JAX package uses ``parallel.prefetch`` for that.  The losses stay on the device and
are read back once every ``print_freq`` steps (eval: ``readback_freq``
batches), the reference's throttled readback (train_distributed.py:
272-298).  ``fit`` runs the epochs with the async per-epoch checkpoint
(``train.checkpoint.CheckpointManager``) and the append-only epoch log.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import torch

from ..config import Config
from ..obs.trace import get_tracer
from ..utils import AverageMeter, StepTimer
from . import checkpoint as ckpt
from .state import TrainState
from .step import to_device


def _log_line(checkpoint_dir: str, text: str) -> None:
    """Append-only epoch log (reference: train_distributed.py:304-310)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "log"), "a") as f:
        f.write(text)


def _model_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _only_none(name: str, value, where: str = "train_epoch") -> None:
    if value is not None:
        raise NotImplementedError(
            f"{where}: {name} is not ported yet (ROADMAP.md, queue 1: "
            "telemetry and supervisor hooks, multi-card training)")


def train_epoch(state: TrainState, train_step: Callable,
                batches: Iterable, config: Config, epoch: int,
                mesh=None, print_freq: Optional[int] = None,
                is_lead_host: bool = True,
                log_fn: Callable[[str], None] = print,
                telemetry=None,
                should_stop: Optional[Callable[[], bool]] = None
                ) -> Tuple[TrainState, float]:
    """Run one epoch over ``batches`` (host (images, mask_miss, labels)
    arrays); returns (state, mean loss over samples).

    ``mesh``, ``telemetry`` and ``should_stop`` accept only None here."""
    for name, value in (("mesh", mesh), ("telemetry", telemetry),
                        ("should_stop", should_stop)):
        _only_none(name, value)
    print_freq = print_freq or config.train.print_freq
    dev = _model_device(state)
    losses = AverageMeter()
    timer = StepTimer()
    # (device loss, batch size) pairs not read back yet: the weight is
    # recorded now, so a trailing partial batch is averaged at its own
    pending = []
    for step_idx, batch in enumerate(batches):
        global_batch = batch[0].shape[0]
        out = train_step(state, *to_device(batch, dev))
        state, loss = out[0], out[1]
        pending.append((loss, global_batch))
        if (step_idx + 1) % print_freq == 0:
            # one device sync per print_freq steps
            for v, bs in pending:
                losses.update(float(v), bs)
            pending.clear()
            dt = timer.mark(print_freq)
            if is_lead_host:
                log_fn(f"==> Epoch [{epoch}][{step_idx + 1}] "
                       f"loss {losses.val:.6f} ({losses.avg:.6f}) "
                       f"imgs/s {global_batch / max(dt, 1e-9):.1f}")
    for v, bs in pending:
        losses.update(float(v), bs)
    return state, losses.avg


def eval_epoch(state: TrainState, eval_step: Callable, batches: Iterable,
               mesh=None, readback_freq: int = 32) -> float:
    """Eval pass; returns the sample-weighted mean loss.  The per-batch
    losses stay on the device and are read back every ``readback_freq``
    batches."""
    _only_none("mesh", mesh)
    dev = _model_device(state)
    losses = AverageMeter()
    pending = []
    for batch in batches:
        pending.append((eval_step(state, *to_device(batch, dev)),
                        batch[0].shape[0]))
        if len(pending) >= readback_freq:
            for loss, bs in pending:
                losses.update(float(loss), bs)
            pending.clear()
    for loss, bs in pending:
        losses.update(float(loss), bs)
    return losses.avg


def fit(state: TrainState, train_step: Callable, config: Config,
        make_batches: Callable[[int], Iterable], epochs: int,
        start_epoch: int = 0, mesh=None,
        eval_step: Optional[Callable] = None,
        make_eval_batches: Optional[Callable[[int], Iterable]] = None,
        checkpoint_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        best_loss: float = float("inf"),
        telemetry=None,
        checkpoint_manager: Optional[ckpt.CheckpointManager] = None,
        should_stop: Optional[Callable[[], bool]] = None) -> TrainState:
    """Multi-epoch driver with the async per-epoch checkpoint and log
    (reference: train_distributed.py:300-324, 441-444).

    ``make_batches(epoch)`` returns that epoch's (shuffled) batch iterable.
    Pass the restored checkpoint's ``best_loss`` on resume so the metadata
    keeps tracking the true best.

    At each epoch boundary the save begins (``CheckpointManager.save``
    blocks only on the device→host snapshot), then validation runs while
    the write commits in the background.  ``config.train.save_freq`` /
    ``eval_freq`` thin the cadence on ABSOLUTE epoch numbers (resume-stable
    and aligned with retention's ``milestone_every``); the final epoch
    always saves and evals.

    ``best_loss`` is keyed on the val loss whenever an eval pass ran (the
    train loss only when no eval is configured), and the metric used is
    recorded in the checkpoint's commit marker
    (``CheckpointManager.record_metric``).  On any exception the manager
    is flushed before the exception propagates.

    Pass ``checkpoint_manager`` to share one manager across stages;
    otherwise fit builds one from the config's ``async_checkpoint`` and
    retention knobs and closes it on exit.  ``mesh``, ``telemetry`` and
    ``should_stop`` accept only None here (ROADMAP.md)."""
    for name, value in (("mesh", mesh), ("telemetry", telemetry),
                        ("should_stop", should_stop)):
        _only_none(name, value, "fit")
    checkpoint_dir = checkpoint_dir or config.train.checkpoint_dir
    tr = config.train
    owns_manager = checkpoint_manager is None
    manager = checkpoint_manager
    if manager is None:
        manager = ckpt.CheckpointManager.from_config(checkpoint_dir, tr)
    save_freq = max(1, int(tr.save_freq or 1))
    eval_freq = max(1, int(tr.eval_freq or 1))
    has_eval = eval_step is not None and make_eval_batches is not None
    last_epoch = start_epoch + epochs - 1
    try:
        for epoch in range(start_epoch, start_epoch + epochs):
            state, train_loss = train_epoch(
                state, train_step, make_batches(epoch), config, epoch,
                log_fn=log_fn)
            _log_line(checkpoint_dir,
                      f"\nEpoch {epoch}\ttrain_loss: {train_loss}")
            do_save = epoch % save_freq == 0 or epoch == last_epoch
            do_eval = has_eval and (epoch % eval_freq == 0
                                    or epoch == last_epoch)
            if do_save:
                # only the snapshot blocks; the write overlaps the eval
                # below and the next epoch's steps
                manager.save(state, epoch, train_loss, best_loss)
            val_loss = None
            if do_eval:
                with get_tracer().span("eval_epoch", track="eval",
                                       args={"epoch": epoch}):
                    val_loss = eval_epoch(state, eval_step,
                                          make_eval_batches(epoch))
                _log_line(checkpoint_dir, f"\tval_loss: {val_loss}")
                log_fn(f"Epoch {epoch} val_loss {val_loss:.6f}")
            # the watermark folds in comparable values only: with eval
            # configured but thinned away this epoch, the (systematically
            # lower) train loss would contaminate the val-loss watermark
            metric_name, metric = (("val_loss", val_loss)
                                   if val_loss is not None
                                   else ("train_loss", train_loss))
            if val_loss is not None or not has_eval:
                best_loss = min(best_loss, metric)
            if do_save:
                manager.record_metric(epoch, metric_name, metric, best_loss)
    except BaseException:
        # a crash must still flush the in-flight write (the run that died
        # is the one whose last checkpoint matters), without letting a
        # writer failure mask the original exception
        try:
            manager.close() if owns_manager else manager.wait()
        except Exception:  # noqa: BLE001 — the original exception wins
            pass
        raise
    manager.close() if owns_manager else manager.wait()
    return state
