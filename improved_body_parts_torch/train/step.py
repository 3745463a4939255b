"""The train and eval steps (counterpart of
``improved_body_parts_tpu/train/step.py``).

One step: uint8 images normalised on the device, the train-mode forward
(bf16 autocast when the model was built so), the multi-scale focal loss
(``ops.losses.multi_task_loss``: the focal kernels on the card), the
backward, and the SGD update behind the abnormal-loss guard of the
reference (train_distributed.py:259-261 "try to rescue the gradient
explosion").  The guard stays on the device, as the JAX step's branchless
select does: the step never reads a value back, so the host can enqueue
the next step while the device runs this one (``train.loop`` reads the
losses back once per window).  When the loss is non-finite or above
``abnormal_loss_thre`` the fused SGD kernel skips the update of every
parameter and momentum buffer (its ``found_inf`` flag), the schedule's
update count stays, and the BN running stats are put back from a copy
taken before the forward with ``torch.where(ok, new, old)``.  ``step``
counts either way.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..data.transformer import IMAGE_NORM_SCALE
from ..ops.losses import multi_task_loss
from .state import ScheduledSGD, TrainState


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 wire -> float32 in [0, 1] on the device; f32 passes through.
    The host pipeline multiplies by the same float32 reciprocal
    (``data.transformer.IMAGE_NORM_SCALE``), so both wires give the same
    bits."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) * float(IMAGE_NORM_SCALE)
    return images


def to_device(batch, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Batch arrays (numpy or tensors) on ``device``: a host array is
    pinned and copied ``non_blocking`` to a CUDA device, so the copy does
    not wait for the step the device is running."""
    out = []
    for x in batch:
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def _bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def apply_guarded_update(state: TrainState, loss: torch.Tensor,
                         bn_before: Sequence[torch.Tensor], config: Config,
                         health: bool):
    """The tail of the train step, on the gradients in ``p.grad``: the
    SGD update and the branchless abnormal-loss/divergence guard.  Returns
    ``(state, loss)``, or ``(state, loss, grad_norm)`` when ``health``.

    Under ``config.train.on_divergence == "skip_step"`` the guard also
    requires a finite gradient norm (within ``health_grad_norm_limit``
    when that is set).  ``max_grad_norm > 0`` clips the gradients to that
    global norm first, to optax's formula (``g * max / |g|`` when
    ``|g| >= max``), before the weight decay."""
    tr = config.train
    opt: ScheduledSGD = state.optimizer
    for p in opt.params:
        if p.grad is None:
            # a parameter the loss does not reach (the independent
            # variant's unused merges): JAX's gradient is 0 there, and
            # the weight decay still moves it
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in opt.params]
    ok = torch.isfinite(loss) & (loss <= tr.abnormal_loss_thre)
    gnorm = None
    if health or tr.on_divergence == "skip_step":
        gnorm = global_norm(grads)
        if tr.on_divergence == "skip_step":
            gok = torch.isfinite(gnorm)
            if tr.health_grad_norm_limit > 0:
                gok &= gnorm <= tr.health_grad_norm_limit
            ok &= gok
    with torch.no_grad():
        if opt.max_grad_norm > 0:
            norm = gnorm if gnorm is not None else global_norm(grads)
            keep = norm < opt.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * opt.max_grad_norm))
        opt.update(ok, horizon=state.step)
        for buf, old in zip(_bn_buffers(state.model), bn_before):
            buf.copy_(torch.where(ok, buf, old))
    state.step += 1
    if health:
        return state, loss, gnorm
    return state, loss


def make_train_step(model: nn.Module, config: Config,
                    optimizer: ScheduledSGD, use_focal: bool = True,
                    freeze_bn: bool = False, health: bool = False,
                    device_gt: bool = False, mesh=None,
                    rules: Optional[Sequence] = None) -> Callable:
    """Build ``train_step(state, images, mask_miss, gt) -> (state, loss)``
    (``(state, loss, grad_norm)`` with ``health``), which updates ``state``
    in place.  ``state.model`` and ``state.optimizer`` must be ``model``
    and ``optimizer``.  Images may be uint8 HWC (normalised on the device)
    or float32 in [0, 1]; the batch may be numpy or tensors.

    ``freeze_bn=True`` runs BatchNorm on its running averages without
    updating them (the SWA fine-tuning mode, train_distributed_SWA.py:
    219-221).  ``device_gt=True`` changes the signature to
    ``(state, images, mask_miss, joints, mask_all)``: the labels are made
    on the device inside the step (``ops.gt_device``) from the padded
    joints, so only those and the masks cross the host→device copy.
    ``mesh`` and ``rules`` (the partitioned program) are not ported yet."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "mesh / rules are not ported yet (ROADMAP.md, queue 1: "
            "multi-card training)")
    dev = next(model.parameters()).device
    synthesize = None
    if device_gt:
        from ..ops.gt_device import make_gt_synthesizer

        synthesize = make_gt_synthesizer(config.skeleton)

    def train_step(state: TrainState, images, mask_miss, *gt_args):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or "
                             "optimizer than the step was built for")
        images, mask_miss, *gt_args = to_device(
            (images, mask_miss, *gt_args), dev)
        if synthesize is not None:
            joints, mask_all = gt_args
            gt = synthesize(joints, mask_all)
        else:
            (gt,) = gt_args
        images = normalize_images(images)
        with torch.no_grad():
            bn_before = [b.clone() for b in _bn_buffers(model)]
        model.train(not freeze_bn)
        optimizer.sgd.zero_grad(set_to_none=True)
        preds = model(images)
        loss = multi_task_loss(preds, gt, mask_miss, config,
                               use_focal=use_focal)
        loss.backward()
        return apply_guarded_update(state, loss.detach(), bn_before, config,
                                    health)

    return train_step


def make_eval_step(model: nn.Module, config: Config,
                   use_focal: bool = True) -> Callable:
    """Validation step: the loss only, with the running BN averages
    (reference: train_distributed.py:327-379 ``test``)."""
    dev = next(model.parameters()).device

    def eval_step(state: TrainState, images, mask_miss, gt) -> torch.Tensor:
        images, mask_miss, gt = to_device((images, mask_miss, gt), dev)
        model.eval()
        with torch.no_grad():
            return multi_task_loss(model(normalize_images(images)), gt,
                                   mask_miss, config, use_focal=use_focal)

    return eval_step
