"""Heatmap-distillation train step (counterpart of
``improved_body_parts_tpu/train/distill.py``): the student learns from the
ground truth and a frozen teacher in one step,

    loss = alpha * focal_L2(student, gt)
         + (1 - alpha) * focal_L2(student, teacher),

both terms the masked multi-task focal L2 (``ops.losses.multi_task_loss``,
the focal kernels on the card): the teacher's last-stack scale-0 maps,
cast to float32, take the GT's slot in the second term, so per-scale
downsampling, mask and task weights apply to both targets alike.

The teacher runs in eval mode (BN on its running averages) under
``torch.no_grad()``; it is in no optimizer and nothing writes to it.  The
abnormal-loss guard, the ``skip_step`` gate and the health output are
the supervised step's (``train.step.apply_guarded_update``).  Wired
through ``cli.train --distill-from <teacher checkpoint> --teacher-config
<name>``; ``bind_teacher`` gives the step the loop's ``(state, *batch)``
form.

Under a mesh (``make_distill_train_step(mesh=)``, the ``replicated``
rules only: the JAX package refuses partitioned distillation) every rank
runs the step on its rows of the global batch, and the step is the
single-process step on that batch within rounding, through the
supervised step's multi-rank machinery (``train.step._Ranks``): the
student's train-mode BN normalises with the global batch's statistics,
its gradients are averaged over the ranks under DDP, and the loss the
guard reads is the global batch's.  The teacher runs eval-mode on each
rank's own rows.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops.losses import multi_task_loss
from .state import ScheduledSGD, TrainState
from .step import (
    _bn_buffers,
    _Ranks,
    apply_guarded_update,
    normalize_images,
    to_device,
)


def distill_alpha(config: Config, step: int) -> float:
    """The GT blend weight at global ``step``: ``distill_alpha``, ramped
    linearly from 1.0 (pure GT) over ``distill_alpha_warmup_steps``, in
    float32 as the JAX package computes it."""
    tr = config.train
    alpha = np.float32(tr.distill_alpha)
    if tr.distill_alpha_warmup_steps > 0:
        frac = np.clip(np.float32(step)
                       / np.float32(tr.distill_alpha_warmup_steps),
                       np.float32(0.0), np.float32(1.0))
        alpha = np.float32(1.0) + (alpha - np.float32(1.0)) * frac
    return float(alpha)


def make_distill_train_step(student: nn.Module, teacher: nn.Module,
                            config: Config, optimizer: ScheduledSGD,
                            use_focal: bool = True,
                            health: bool = False, mesh=None) -> Callable:
    """Build ``step(state, teacher, images, mask_miss, gt) -> (state,
    loss)`` (``(state, loss, grad_norm)`` with ``health``), which updates
    the student's ``state`` in place.  ``config`` is the student's: it
    owns the loss weights, the alpha schedule and the divergence policy.
    The teacher may differ in width and stacks; its skeleton must match
    (the distill target is its last-stack scale-0 map, on the student's
    grid).  ``mesh`` (``parallel.make_mesh``) makes it the multi-rank
    step of the ``replicated`` rules: every rank calls it with its rows
    of the global batch and gets the global batch's loss."""
    dev = next(student.parameters()).device
    ranks = None
    if mesh is not None:
        from ..parallel.partition import get_ruleset

        ranks = _Ranks(student, optimizer, config, mesh,
                       get_ruleset("replicated"), None)

    def distill_step(state: TrainState, teacher_model: nn.Module, images,
                     mask_miss, gt):
        if state.model is not student or state.optimizer is not optimizer:
            raise ValueError("distill_step: the state holds another model "
                             "or optimizer than the step was built for")
        images, mask_miss, gt = to_device((images, mask_miss, gt), dev)
        images = normalize_images(images)
        teacher_model.eval()
        with torch.no_grad():
            target = teacher_model(images)[-1][0].float()
            bn_before = [b.clone() for b in _bn_buffers(student)]
        alpha = distill_alpha(config, state.step)
        student.train()
        optimizer.sgd.zero_grad(set_to_none=True)
        preds = (student if ranks is None else ranks.forward)(images)
        loss_gt = multi_task_loss(preds, gt, mask_miss, config,
                                  use_focal=use_focal)
        loss_kd = multi_task_loss(preds, target, mask_miss, config,
                                  use_focal=use_focal)
        loss = alpha * loss_gt + (1.0 - alpha) * loss_kd
        if ranks is None:
            loss.backward()
            return apply_guarded_update(state, loss.detach(), bn_before,
                                        config, health)
        (loss * ranks.backward_scale).backward()
        return apply_guarded_update(state, ranks.global_loss(loss.detach()),
                                    bn_before, config, health,
                                    grad_norm=ranks.grad_norm)

    return distill_step


def bind_teacher(distill_step: Callable, teacher: nn.Module) -> Callable:
    """The distillation step in the loop's ``step(state, *batch)`` form,
    the teacher bound as its second argument (put in eval mode and out of
    autograd: its parameters never take a gradient)."""
    teacher.eval().requires_grad_(False)

    def step(state, *batch):
        return distill_step(state, teacher, *batch)

    return step
