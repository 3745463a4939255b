"""Training CLI of the port (counterpart of the single-process path of
``tools/train.py``)::

    python -m improved_body_parts_torch.cli.train --config canonical \\
        --epochs 100 --train-h5 data/coco_train_dataset512.h5

Builds the model, state and step with the port's ``train`` package, reads
the HDF5 corpus in-process (``pipeline="sync"``) and runs ``fit`` with the
async checkpoint.  ``--resume auto`` continues from the last committed
checkpoint of ``--checkpoint-dir``.  Runs on ``--device cuda`` unless asked
for ``cpu``.  At exit it prints the ``CLI_REPORT`` line (``cli``): the
device, the kernels' launches, the steps and images trained, the median
step time, train imgs/s, each save's blocked and writer ms, and a SHA-256
of the final model ``state_dict``.

Not ported yet (ROADMAP.md, Queue 1): the SWA stage, device GT,
telemetry, supervision, partitioning, distillation and the worker
pipelines.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import statistics
import time

import torch


def state_digest(tensors) -> str:
    """SHA-256 of every tensor of ``tensors`` (a ``state_dict``-like
    mapping of name to tensor), in key order."""
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class StepClock:
    """Wraps a train step and keeps each step's time: CUDA events around
    it on the card (no host sync while training), the host clock on the
    CPU."""

    def __init__(self, step, device: torch.device):
        self.step, self.cuda = step, device.type == "cuda"
        self.marks = []

    def __call__(self, state, *batch):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.step(state, *batch)
            end.record()
            self.marks.append((start, end))
            return out
        t0 = time.perf_counter()
        out = self.step(state, *batch)
        self.marks.append(1e3 * (time.perf_counter() - t0))
        return out

    def median_ms(self) -> float:
        if not self.marks:
            return float("nan")
        if self.cuda:
            torch.cuda.synchronize()
            return statistics.median(s.elapsed_time(e)
                                     for s, e in self.marks)
        return statistics.median(self.marks)


def main(argv=None):
    ap = argparse.ArgumentParser(description="IMHN pose training (PyTorch)")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--train-h5", default=None)
    ap.add_argument("--val-h5", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint path or 'auto' for the latest committed")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override the config's per-device learning rate")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--print-freq", type=int, default=None,
                    help="loss-readback window in steps (default: the "
                         "config's print_freq)")
    ap.add_argument("--save-freq", type=int, default=None,
                    help="checkpoint on epochs divisible by N (default: "
                         "the config's save_freq); the final epoch always "
                         "saves")
    ap.add_argument("--eval-freq", type=int, default=None,
                    help="run the val pass on epochs divisible by N "
                         "(default: the config's eval_freq); the final "
                         "epoch always evals")
    ap.add_argument("--sync-checkpoint", action="store_true",
                    help="write each checkpoint in the training thread "
                         "instead of the background writer")
    ap.add_argument("--keep-last-n", type=int, default=None,
                    help="retention: keep the last N committed checkpoints, "
                         "plus the best and milestones (0 keeps all)")
    ap.add_argument("--milestone-every", type=int, default=None,
                    help="retention: also keep every epoch divisible by K")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameter init and the data pipeline")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..config import get_config
    from ..data import CocoPoseDataset
    from . import exit_report

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    overrides = {}
    for flag, field in (("checkpoint_dir", "checkpoint_dir"),
                        ("lr", "learning_rate_per_device"),
                        ("print_freq", "print_freq"),
                        ("save_freq", "save_freq"),
                        ("eval_freq", "eval_freq")):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    if args.sync_checkpoint:
        overrides["async_checkpoint"] = False
    for flag in ("keep_last_n", "milestone_every"):
        if getattr(args, flag) is not None:
            overrides[flag] = getattr(args, flag)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    tr = cfg.train

    train_h5 = args.train_h5 or tr.hdf5_train_data
    val_h5 = args.val_h5 or tr.hdf5_val_data
    ds = CocoPoseDataset(train_h5, cfg, augment=True, seed=args.seed)
    val_ds = (CocoPoseDataset(val_h5, cfg, augment=False)
              if os.path.exists(val_h5) else None)
    try:
        state, report = train(cfg, ds, args.epochs or tr.epochs,
                              device=device, seed=args.seed,
                              val_dataset=val_ds, resume=args.resume,
                              use_warmup=not args.no_warmup)
    finally:
        ds.close()
        if val_ds is not None:
            val_ds.close()
    exit_report("train", device, config=args.config, **report,
                state_sha256=state_digest(state.model.state_dict()))


def train(cfg, dataset, epochs: int, *, device, seed: int = 0,
          val_dataset=None, resume=None, use_warmup: bool = True,
          log_fn=print):
    """The train CLI's run, on any dataset with ``len`` and the batch
    protocol of ``data.batches`` (``CocoPoseDataset`` over HDF5,
    ``MemoryDataset``): the model of ``cfg`` built from ``seed`` on
    ``device``, its schedule, optimizer and state, ``resume`` (a checkpoint
    path, or ``"auto"`` for the last committed one of
    ``cfg.train.checkpoint_dir``), and ``fit`` for ``epochs`` with the
    config's async checkpoint and retention.  Returns ``(state, report)``:
    the report holds the steps and images trained, the median step ms,
    train imgs/s over the epochs' batch loops, and each save's blocked and
    writer ms."""
    from ..data import batches
    from ..models import build_model
    from ..train import (
        CheckpointManager,
        create_train_state,
        fit,
        latest_checkpoint,
        make_eval_step,
        make_optimizer,
        make_train_step,
        restore_checkpoint,
        step_decay_schedule,
    )
    from ..train.schedule import large_batch_schedule

    tr = cfg.train
    global_batch = tr.batch_size_per_device
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    log_fn(f"device={device} global_batch={global_batch} "
           f"steps/epoch={steps_per_epoch}")

    model = build_model(cfg, device=device, seed=seed, train=True)
    if tr.lr_batch_ref > 0:
        schedule = large_batch_schedule(tr, steps_per_epoch, global_batch,
                                        use_warmup=use_warmup)
    else:
        schedule = step_decay_schedule(tr, steps_per_epoch,
                                       use_warmup=use_warmup)
    optimizer = make_optimizer(model, cfg, schedule)
    state = create_train_state(model, cfg, optimizer)

    start_epoch, best_loss = 0, float("inf")
    if resume:
        path = (latest_checkpoint(tr.checkpoint_dir)
                if resume == "auto" else resume)
        if path:
            state, meta = restore_checkpoint(path, state)
            start_epoch = meta["epoch"] + 1
            best_loss = float(meta.get("best_loss", float("inf")))
            log_fn(f"resumed from {path} (epoch {meta['epoch']})")

    clock = StepClock(make_train_step(model, cfg, optimizer), device)
    train_s = [0.0]

    def make_train_batches(epoch):
        it = batches(dataset, global_batch, epoch, pipeline="sync",
                     wire=tr.input_wire)
        t0 = time.perf_counter()
        for batch in it:
            yield batch
        train_s[0] += time.perf_counter() - t0

    make_eval_batches = None
    if val_dataset is not None:
        def make_eval_batches(epoch):
            return batches(val_dataset, global_batch, 0, pipeline="sync",
                           wire=tr.input_wire)

    manager = CheckpointManager.from_config(tr.checkpoint_dir, tr)
    try:
        fit(state, clock, cfg, make_train_batches, epochs,
            start_epoch=start_epoch, eval_step=make_eval_step(model, cfg),
            make_eval_batches=make_eval_batches, best_loss=best_loss,
            checkpoint_manager=manager, log_fn=log_fn)
    finally:
        manager.close()
    images = len(clock.marks) * global_batch
    return state, dict(
        steps=len(clock.marks), images=images,
        step_ms_median=clock.median_ms(),
        train_imgs_per_s=images / max(train_s[0], 1e-9),
        save_blocked_ms=[1e3 * s for s in manager.blocked_seconds],
        save_write_ms=[1e3 * s for s in manager.write_seconds])


if __name__ == "__main__":
    main()
