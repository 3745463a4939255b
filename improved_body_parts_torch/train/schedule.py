"""Learning-rate schedules (counterpart of
``improved_body_parts_tpu/train/schedule.py``): the reference's per-step
staircase with warmup (train_distributed.py:382-400), the large-batch
recipe, and the SWA sawtooth (train_distributed_SWA.py:365-371).

Each is a plain ``step -> lr`` function of a host int (or an int array,
for a table of steps).  They compute in ``np.float32`` with the JAX
version's operation order, where that one computes in ``jnp`` float32,
so both give the same lr to within one float32 ulp.
"""
from __future__ import annotations

import numpy as np

from ..config import TrainConfig

_F = np.float32


def _decay_factor(cfg: TrainConfig, epoch):
    """The reference's staircase exponent: epoch // 15, switching to
    (epoch - 78) // 5 after epoch 78 (train_distributed.py:385-396)."""
    return np.where(epoch >= cfg.lr_late_epoch,
                    (epoch - cfg.lr_late_epoch) // cfg.lr_late_step_epochs,
                    epoch // cfg.lr_step_epochs)


def _decay(cfg: TrainConfig, epoch):
    return _F(cfg.lr_decay_factor) ** _decay_factor(cfg, epoch).astype(_F)


def step_decay_schedule(cfg: TrainConfig, steps_per_epoch: int,
                        world_size: int = 1, use_warmup: bool = True):
    """LR = base * world_size * 0.2^factor with a 3-epoch linear warmup
    (train_distributed.py:385-396).  ``step`` is the global step count."""
    base = _F(cfg.learning_rate_per_device * world_size)

    def schedule(step):
        step = np.asarray(step, np.int64)
        epoch = step // steps_per_epoch
        lr = base * _decay(cfg, epoch)
        if use_warmup:
            warm_steps = _F(cfg.warmup_epochs * steps_per_epoch)
            warm = lr * (1.0 + step).astype(_F) / warm_steps
            lr = np.where(epoch < cfg.warmup_epochs, warm, lr)
        return _F(lr) if lr.ndim == 0 else lr.astype(_F)

    return schedule


def large_batch_schedule(cfg: TrainConfig, steps_per_epoch: int,
                         global_batch: int, use_warmup: bool = True):
    """The large-batch recipe (Goyal et al.'s linear scaling + gradual
    warmup; see the JAX version's docstring): LR = base * global_batch /
    lr_batch_ref, ramped from the unscaled base over the warmup epochs,
    then the step-decay staircase."""
    ref = cfg.lr_batch_ref if cfg.lr_batch_ref > 0 \
        else cfg.batch_size_per_device
    scale = float(global_batch) / float(ref)
    scaled = cfg.learning_rate_per_device * scale
    warm_epochs = (cfg.large_batch_warmup_epochs
                   if cfg.large_batch_warmup_epochs > 0
                   else cfg.warmup_epochs)

    def schedule(step):
        step = np.asarray(step, np.int64)
        epoch = step // steps_per_epoch
        decay = _decay(cfg, epoch)
        lr = _F(scaled) * decay
        if use_warmup and scale > 1.0:
            warm_steps = _F(warm_epochs * steps_per_epoch)
            frac = np.minimum((1.0 + step).astype(_F) / warm_steps, _F(1.0))
            warm = (_F(scaled / scale) * (_F(1.0) + _F(scale - 1.0) * frac)
                    * decay)
            lr = np.where(epoch < warm_epochs, warm, lr)
        elif use_warmup:
            warm_steps = _F(cfg.warmup_epochs * steps_per_epoch)
            warm = lr * (1.0 + step).astype(_F) / warm_steps
            lr = np.where(epoch < cfg.warmup_epochs, warm, lr)
        return _F(lr) if lr.ndim == 0 else lr.astype(_F)

    return schedule


def cyclic_swa_schedule(steps_per_epoch: int, swa_freq: int = 5,
                        lr_max: float = 1e-5, lr_min: float = 1e-6,
                        start_step: int = 0):
    """Sawtooth LR for SWA fine-tuning: lr_max -> lr_min over each
    ``swa_freq``-epoch cycle, anchored at ``start_step``, the global step
    at which SWA began (train_distributed_SWA.py:365-369)."""
    if swa_freq <= 1:  # degenerate cycle: constant lr_max
        return lambda step: np.full(np.shape(step), lr_max, _F)[()]

    def schedule(step):
        epoch = (np.asarray(step, np.int64) - start_step) // steps_per_epoch
        phase = epoch - (epoch // swa_freq) * swa_freq
        lr = (_F(lr_max)
              - _F((lr_max - lr_min) / (swa_freq - 1)) * phase.astype(_F))
        return _F(lr) if lr.ndim == 0 else lr.astype(_F)

    return schedule
