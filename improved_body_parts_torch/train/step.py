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

Under a mesh (``make_train_step(mesh=, rules=)``) each rank runs the step
on its rows of the global batch and the step computes the single-process
step's update on that batch, within rounding, as the JAX package's one
SPMD program does: train-mode BatchNorm normalises with the global
batch's statistics (``models.layers.BatchNorm``'s cross-rank mode, on
when the ``'data'`` axis has more than one rank), the gradient is summed
over the ``'data'`` ranks and the loss is the global batch's, so the
guard decides the same on every rank.  ``rules`` that shard nothing run
the model under ``DistributedDataParallel``; rules that shard leaves run
it over ``parallel.sharded.ShardedState`` (gather at use, reduce and
scatter after).
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
        [torch.linalg.vector_norm(t, dtype=torch.promote_types(
            t.dtype, torch.float32)) for t in tensors]))


def _bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def apply_guarded_update(state: TrainState, loss: torch.Tensor,
                         bn_before: Sequence[torch.Tensor], config: Config,
                         health: bool,
                         grad_norm: Optional[Callable] = None):
    """The tail of the train step, on the gradients in ``p.grad``: the
    SGD update and the branchless abnormal-loss/divergence guard.  Returns
    ``(state, loss)``, or ``(state, loss, grad_norm)`` when ``health``.

    Under ``config.train.on_divergence == "skip_step"`` the guard also
    requires a finite gradient norm (within ``health_grad_norm_limit``
    when that is set).  ``max_grad_norm > 0`` clips the gradients to that
    global norm first, to optax's formula (``g * max / |g|`` when
    ``|g| >= max``), before the weight decay.  ``grad_norm`` computes the
    global norm from the gradient list (default :func:`global_norm`; a
    partitioned state sums its chunks' squares across ranks)."""
    tr = config.train
    opt: ScheduledSGD = state.optimizer
    for p in opt.params:
        if p.grad is None:
            # a parameter the loss does not reach (the independent
            # variant's unused merges): JAX's gradient is 0 there, and
            # the weight decay still moves it
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in opt.params]
    grad_norm = grad_norm or global_norm
    ok = torch.isfinite(loss) & (loss <= tr.abnormal_loss_thre)
    gnorm = None
    if health or tr.on_divergence == "skip_step":
        gnorm = grad_norm(grads)
        if tr.on_divergence == "skip_step":
            gok = torch.isfinite(gnorm)
            if tr.health_grad_norm_limit > 0:
                gok &= gnorm <= tr.health_grad_norm_limit
            ok &= gok
    with torch.no_grad():
        if opt.max_grad_norm > 0:
            norm = gnorm if gnorm is not None else grad_norm(grads)
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
                    rules: Optional[Sequence] = None,
                    min_shard_dim: Optional[int] = None) -> Callable:
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

    ``mesh`` (``parallel.make_mesh``) and ``rules`` (a partition ruleset,
    ``parallel.partition``) select the multi-rank step together: every
    rank of the mesh calls it with its rows of the global batch
    (``parallel.shard_batch``, or a host shard of the input) and gets the
    global batch's loss.  A ruleset that shards leaves lays the state out
    by its layout at the first call (rank 0's values to every rank), and
    the state stays laid out so; ``min_shard_dim`` is the refinement
    floor (``parallel.partition.DEFAULT_MIN_SHARD_DIM`` by default)."""
    if (mesh is None) != (rules is None):
        raise ValueError("make_train_step: mesh and rules select the "
                         "partitioned program together: pass both or "
                         "neither")
    dev = next(model.parameters()).device
    synthesize = None
    if device_gt:
        from ..ops.gt_device import make_gt_synthesizer

        synthesize = make_gt_synthesizer(config.skeleton)
    ranks = (_Ranks(model, optimizer, config, mesh, rules, min_shard_dim)
             if mesh is not None else None)

    def train_step(state: TrainState, images, mask_miss, *gt_args):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or "
                             "optimizer than the step was built for")
        if ranks is not None:
            ranks.place(state)
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
        if ranks is None:
            preds = model(images)
            loss = multi_task_loss(preds, gt, mask_miss, config,
                                   use_focal=use_focal)
            loss.backward()
            return apply_guarded_update(state, loss.detach(), bn_before,
                                        config, health)
        ranks.gather()
        preds = ranks.forward(images)
        local = multi_task_loss(preds, gt, mask_miss, config,
                                use_focal=use_focal)
        (local * ranks.backward_scale).backward()
        ranks.reduce_grads()
        return apply_guarded_update(state, ranks.global_loss(local.detach()),
                                    bn_before, config, health,
                                    grad_norm=ranks.grad_norm)

    return train_step


class _Ranks:
    """What a step under a mesh adds to the single-process one.

    Loss bookkeeping: each ``'data'`` rank ``d`` of ``D`` computes the loss
    of its rows as the single-process step would (``multi_task_loss``),
    ``l_d``; the global batch's loss is ``sum_d c_d`` with ``c_d = l_d /
    D`` when the loss is divided by the batch, else ``c_d = l_d``.  Every
    rank backpropagates ``D * c_d`` (``backward_scale``) and the gradients
    are averaged over the ranks (DDP's all-reduce, or
    :class:`ShardedState`'s sum times ``1 / D``), which gives
    ``d(sum_d c_d)``.  Cross-rank BatchNorm's all-reduce sends each
    rank's share of a statistic's gradient to every data rank in its
    backward; the average folds those in once, so the gradient is the
    single-process one, not ``D`` times it.  With more than one
    ``'model'`` rank, the ranks of a ``data`` coordinate compute the same
    ``c_d``, and DDP's average over every rank still gives
    ``d(sum_d c_d)``."""

    def __init__(self, model, optimizer, config, mesh, rules,
                 min_shard_dim):
        from ..models.layers import set_batch_norm_group
        from ..parallel.mesh import axis_sizes, check_mesh
        from ..parallel.partition import (
            DEFAULT_MIN_SHARD_DIM,
            shards_anything,
            train_state_shardings,
        )

        check_mesh(mesh, "make_train_step")
        self.optimizer = optimizer
        self.data_size = axis_sizes(mesh)["data"]
        self.data_group = mesh.get_group("data")
        normalized = config.train.normalize_by_global_batch
        self.backward_scale = 1.0 if normalized else float(self.data_size)
        self.loss_scale = 1.0 / self.data_size if normalized else 1.0
        set_batch_norm_group(model, self.data_group
                             if self.data_size > 1 else None)
        self.sharded = None
        if shards_anything(rules):
            from ..parallel.sharded import ShardedState

            layout = train_state_shardings(
                model, optimizer, mesh, rules,
                min_shard_dim=min_shard_dim or DEFAULT_MIN_SHARD_DIM)
            self.sharded = ShardedState(model, optimizer, mesh, layout)
            self.forward = model
        else:
            from torch.nn.parallel import DistributedDataParallel

            dev = next(model.parameters()).device
            self.forward = DistributedDataParallel(
                model, device_ids=[dev] if dev.type == "cuda" else None,
                broadcast_buffers=False, static_graph=True)

    def place(self, state) -> None:
        if self.sharded is not None and state.sharding is not self.sharded:
            self.sharded.place(state)

    def gather(self) -> None:
        if self.sharded is not None:
            self.sharded.gather()

    def reduce_grads(self) -> None:
        if self.sharded is not None:
            self.sharded.reduce_grads(self.optimizer.params,
                                      1.0 / self.data_size)

    def grad_norm(self, grads) -> torch.Tensor:
        if self.sharded is not None:
            return self.sharded.grad_norm(self.optimizer.params)
        return global_norm(grads)

    def global_loss(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch's loss, the same bits on every rank."""
        return reduced_loss(local, self.data_group, self.data_size,
                            self.loss_scale)


def reduced_loss(local: torch.Tensor, group, size: int,
                 scale: float) -> torch.Tensor:
    """The sum over ``group`` (``size`` ranks) of ``local * scale``;
    ``local`` itself for one rank."""
    if size <= 1:
        return local
    import torch.distributed as dist

    out = local * scale
    dist.all_reduce(out, group=group)
    return out


def make_eval_step(model: nn.Module, config: Config,
                   use_focal: bool = True, mesh=None) -> Callable:
    """Validation step: the loss only, with the running BN averages
    (reference: train_distributed.py:327-379 ``test``).  Under ``mesh``
    every rank calls it with its rows and gets the global batch's loss;
    a partitioned state's split parameters are gathered for the
    forward."""
    dev = next(model.parameters()).device
    group = size = scale = None
    if mesh is not None:
        from ..parallel.mesh import axis_sizes, check_mesh

        check_mesh(mesh, "make_eval_step")
        size = axis_sizes(mesh)["data"]
        group = mesh.get_group("data")
        scale = (1.0 / size if config.train.normalize_by_global_batch
                 else 1.0)

    def eval_step(state: TrainState, images, mask_miss, gt) -> torch.Tensor:
        images, mask_miss, gt = to_device((images, mask_miss, gt), dev)
        model.eval()
        sharding = state.sharding
        if sharding is not None:
            sharding.gather()
        try:
            with torch.no_grad():
                loss = multi_task_loss(model(normalize_images(images)), gt,
                                       mask_miss, config,
                                       use_focal=use_focal)
        finally:
            if sharding is not None:
                sharding.release()
        if mesh is None:
            return loss
        return reduced_loss(loss, group, size, scale)

    return eval_step
