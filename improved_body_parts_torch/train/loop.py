"""Epoch-level training loop (counterpart of
``improved_body_parts_tpu/train/loop.py`` ``train_epoch`` and
``eval_epoch``; reference: train.py:104-206, train_distributed.py:225-379).

Each host batch goes to the device through pinned memory with a
``non_blocking`` copy (``train.step.to_device``), so the copy and the
host's work on the next batch overlap the step the device is running; the
JAX package uses ``parallel.prefetch`` for that.  The losses stay on the device and
are read back once every ``print_freq`` steps (eval: ``readback_freq``
batches), the reference's throttled readback (train_distributed.py:
272-298).  ``fit`` (checkpointing) is not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from ..config import Config
from ..utils import AverageMeter, StepTimer
from .state import TrainState
from .step import to_device


def _model_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _only_none(name: str, value) -> None:
    if value is not None:
        raise NotImplementedError(
            f"train_epoch: {name} is not ported yet (ROADMAP.md, queue 1: "
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
