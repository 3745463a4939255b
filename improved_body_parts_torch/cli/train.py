"""Training CLI of the port (counterpart of the single-process path of
``tools/train.py``)::

    python -m improved_body_parts_torch.cli.train --config canonical \\
        --epochs 100 --train-h5 data/coco_train_dataset512.h5 --workers 4
    python -m improved_body_parts_torch.cli.train --swa --resume auto ...

Builds the model (any variant of ``--config``), state and step with the
port's ``train`` package and runs ``fit`` with the async checkpoint.
Flags, with the JAX CLI's meaning:

- input: ``--workers N --input-pipeline {shm,sync}`` (the shared-memory
  ring of N spawn workers, its batches copied ahead to the device by
  ``parallel.device_prefetch``; the config's ``input_pipeline`` by
  default), ``--wire {uint8,f32}``, ``--device-gt MAX_PEOPLE`` (labels
  made on the device from padded joints);
- ``--no-focal`` (plain L2), ``--on-divergence skip_step``;
- the SWA stage, ``--swa --swa-freq --swa-lr-max --swa-lr-min``
  (train_distributed_SWA.py): the cyclic schedule anchored where SWA
  began, BN frozen, the average updated every ``--swa-freq`` epochs and
  saved swapped in (the trained weights ride in ``swa_params``);
  ``--lr`` is refused;
- ``--supervised --max-restarts --crash-budget --backoff-base
  --backoff-max`` (``train.supervisor``): SIGTERM/SIGINT drain to the
  next window, transient failures retry with backoff, resume is
  automatic, and ``--epochs`` is the total the run converges to;
- ``--distill-from CKPT --teacher-config NAME --distill-alpha
  --distill-alpha-warmup`` (``train.distill``).

``--resume auto`` continues from the last committed checkpoint of
``--checkpoint-dir``.  Runs on ``--device cuda`` unless asked for
``cpu``.  At exit it prints the ``CLI_REPORT`` line (``cli``): the device,
the kernels' launches, the steps and images trained, the median step
time, train imgs/s, each save's blocked and writer ms, and a SHA-256 of
the final model ``state_dict``.

Not ported (ROADMAP.md, Queue 1), and refused with an error: the retired
``--input-pipeline pool``, ``--on-divergence warn|halt`` and
``--telemetry-*`` (the telemetry bundle), ``--reshard``,
``--partition``, ``--partition-rules``, ``--mesh-model`` and the
multi-host flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import statistics
import sys
import time

import torch

# flags of the JAX CLI that the port refuses: flag -> what it needs
UNPORTED = {
    "--telemetry-sink": "the telemetry bundle (ROADMAP.md, queue 1 item 12)",
    "--telemetry-port": "the telemetry bundle (ROADMAP.md, queue 1 item 12)",
    "--telemetry-trace": "the telemetry bundle (ROADMAP.md, queue 1 item "
                         "12)",
    "--reshard": "multi-card training (ROADMAP.md, queue 1 item 9)",
    "--partition": "multi-card training (ROADMAP.md, queue 1 item 9)",
    "--partition-rules": "multi-card training (ROADMAP.md, queue 1 item 9)",
    "--mesh-model": "multi-card training (ROADMAP.md, queue 1 item 9)",
    "--coordinator": "multi-host training (ROADMAP.md, queue 1 item 9)",
    "--num-processes": "multi-host training (ROADMAP.md, queue 1 item 9)",
    "--process-id": "multi-host training (ROADMAP.md, queue 1 item 9)",
}


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


def _parser():
    ap = argparse.ArgumentParser(description="IMHN pose training (PyTorch)")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--train-h5", default=None)
    ap.add_argument("--val-h5", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint path or 'auto' for the latest committed")
    ap.add_argument("--workers", type=int, default=2,
                    help="input workers of the shm ring (0 = in-process)")
    ap.add_argument("--input-pipeline", default=None,
                    choices=("shm", "sync", "pool"),
                    help="worker transport (default: the config's "
                         "input_pipeline): 'shm' = persistent "
                         "shared-memory ring workers, 'sync' = in-process; "
                         "'pool' is not ported")
    ap.add_argument("--wire", default=None, choices=("uint8", "f32"),
                    help="image wire format (default: the config's "
                         "input_wire); uint8 is normalised on the device")
    ap.add_argument("--device-gt", type=int, default=0, metavar="MAX_PEOPLE",
                    help="make the GT maps on the device from padded "
                         "joints (value = max people a sample)")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override the config's per-device learning rate")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--no-focal", action="store_true",
                    help="plain L2 loss (the reference's L2 stage)")
    ap.add_argument("--on-divergence", default=None,
                    choices=("warn", "halt", "skip_step"),
                    help="'skip_step' drops an update whose gradient norm "
                         "is not finite, inside the step; 'warn' and "
                         "'halt' need the telemetry sentinel (not ported)")
    ap.add_argument("--swa", action="store_true",
                    help="SWA fine-tuning: cyclic LR, frozen BN, averaged "
                         "weights saved (train_distributed_SWA.py)")
    ap.add_argument("--swa-freq", type=int, default=5)
    ap.add_argument("--swa-lr-max", type=float, default=1e-5)
    ap.add_argument("--swa-lr-min", type=float, default=1e-6)
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
    ap.add_argument("--supervised", action="store_true",
                    help="run under the run supervisor: SIGTERM/SIGINT "
                         "drain to the next window, transient failures "
                         "retry with backoff, resume is automatic and "
                         "--epochs is the run's total")
    ap.add_argument("--max-restarts", type=int, default=24)
    ap.add_argument("--crash-budget", type=int, default=3)
    ap.add_argument("--backoff-base", type=float, default=1.0)
    ap.add_argument("--backoff-max", type=float, default=60.0)
    ap.add_argument("--distill-from", default=None, metavar="CKPT",
                    help="train --config as a student of the teacher "
                         "checkpoint CKPT (an epoch dir, or a checkpoint "
                         "dir for its latest); needs --teacher-config")
    ap.add_argument("--teacher-config", default=None)
    ap.add_argument("--distill-alpha", type=float, default=None,
                    help="GT blend weight (default: the config's)")
    ap.add_argument("--distill-alpha-warmup", type=int, default=None,
                    metavar="STEPS",
                    help="ramp alpha from 1.0 over the first STEPS steps")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameter init and the data pipeline")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    for flag, needs in UNPORTED.items():
        ap.add_argument(flag, default=None, nargs="?", const=True,
                        help=f"not ported: needs {needs}")
    return ap


def _refuse(msg: str):
    raise SystemExit(msg)


def resolve_args(args):
    """The config of ``args`` with the CLI's overrides folded in, after
    the checks the JAX CLI makes (and the port's refusals); returns
    ``(cfg, teacher_cfg)``."""
    from ..config import get_config

    for flag in UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            _refuse(f"{flag} is not ported: it needs {UNPORTED[flag]}")
    if args.input_pipeline == "pool":
        _refuse("--input-pipeline pool (the retired spawn pool) is not "
                "ported; use shm or sync (ROADMAP.md, queue 1)")
    if args.on_divergence in ("warn", "halt"):
        _refuse(f"--on-divergence {args.on_divergence} needs the "
                "telemetry health sentinel, not ported (ROADMAP.md, queue "
                "1 item 12); skip_step is")
    if args.lr and args.swa:
        _refuse("--lr does not apply to the SWA stage; use "
                "--swa-lr-max/--swa-lr-min instead")
    if args.supervised and args.swa:
        _refuse("--supervised covers the main fit only; run the SWA stage "
                "unsupervised (it is short: just relaunch it)")
    cfg = get_config(args.config)
    teacher_cfg = None
    if args.distill_from:
        if not args.teacher_config:
            _refuse("--distill-from requires --teacher-config (the "
                    "teacher checkpoint's architecture; the student is "
                    "--config)")
        if args.swa:
            _refuse("--distill-from covers the main fit; run the SWA "
                    "stage on the distilled student without it")
        if args.device_gt:
            _refuse("--distill-from needs host GT label maps (the blend's "
                    "supervised term); drop --device-gt")
        teacher_cfg = get_config(args.teacher_config)
        if teacher_cfg.skeleton != cfg.skeleton:
            _refuse(f"teacher config '{args.teacher_config}' has a "
                    f"different skeleton than student '{args.config}': "
                    "distillation blends heatmaps channel for channel")
    elif (args.teacher_config or args.distill_alpha is not None
          or args.distill_alpha_warmup is not None):
        _refuse("--teacher-config/--distill-alpha/--distill-alpha-warmup "
                "require --distill-from")
    overrides = {}
    for flag, field in (("checkpoint_dir", "checkpoint_dir"),
                        ("lr", "learning_rate_per_device"),
                        ("print_freq", "print_freq"),
                        ("save_freq", "save_freq"),
                        ("eval_freq", "eval_freq"),
                        ("on_divergence", "on_divergence")):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    if args.sync_checkpoint:
        overrides["async_checkpoint"] = False
    for flag, field in (("keep_last_n", "keep_last_n"),
                        ("milestone_every", "milestone_every"),
                        ("distill_alpha", "distill_alpha"),
                        ("distill_alpha_warmup",
                         "distill_alpha_warmup_steps")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    return (cfg.replace(train=dataclasses.replace(cfg.train, **overrides)),
            teacher_cfg)


def load_teacher(teacher_cfg, path: str, device):
    """The teacher model of ``teacher_cfg`` with the weights of the
    checkpoint at ``path`` (an epoch directory, or a checkpoint directory
    for its last committed epoch), in eval mode on ``device``."""
    from ..models import build_model
    from ..train import latest_checkpoint, restore_checkpoint
    from ..train.checkpoint import PAYLOAD_FILE

    if not os.path.isfile(os.path.join(path, PAYLOAD_FILE)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise SystemExit(f"--distill-from {path}: no checkpoint there")
        path = latest
    teacher = build_model(teacher_cfg, device=device)
    teacher.load_state_dict(restore_checkpoint(path)["model"], strict=True)
    return teacher.eval()


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg, teacher_cfg = resolve_args(args)

    from .. import resolve_device
    from ..data import CocoPoseDataset
    from ..obs.events import strict_dump
    from ..train import RunSupervisor
    from . import exit_report

    device = resolve_device(args.device)
    tr = cfg.train
    supervisor = None
    argv_list = list(sys.argv[1:] if argv is None else argv)
    if args.supervised:
        supervisor = RunSupervisor(
            tr.checkpoint_dir, max_restarts=args.max_restarts,
            crash_budget=args.crash_budget,
            backoff_base_s=args.backoff_base,
            backoff_max_s=args.backoff_max)
        supervisor.open_segment({"argv": argv_list})
        supervisor.install_signal_handlers()
        supervisor.bind(None)
    manifest = {"tool": "train", "config": args.config, "argv": argv_list,
                "on_divergence": tr.on_divergence}
    if supervisor is not None:
        supervisor.update_manifest(manifest)
    else:
        os.makedirs(tr.checkpoint_dir, exist_ok=True)
        with open(os.path.join(tr.checkpoint_dir, "RUN.json"), "w") as f:
            strict_dump(manifest, f, indent=2)

    teacher = None
    if args.distill_from:
        teacher = load_teacher(teacher_cfg, args.distill_from, device)
        print(f"distilling from {args.distill_from} (teacher "
              f"{args.teacher_config}, alpha {tr.distill_alpha}, warmup "
              f"{tr.distill_alpha_warmup_steps} steps)")
    train_h5 = args.train_h5 or tr.hdf5_train_data
    val_h5 = args.val_h5 or tr.hdf5_val_data
    ds = CocoPoseDataset(train_h5, cfg, augment=True, seed=args.seed)
    val_ds = (CocoPoseDataset(val_h5, cfg, augment=False)
              if os.path.exists(val_h5) else None)
    pipeline = args.input_pipeline or tr.input_pipeline
    try:
        state, report = train(
            cfg, ds, args.epochs or tr.epochs, device=device,
            seed=args.seed, val_dataset=val_ds, resume=args.resume,
            use_warmup=not args.no_warmup, use_focal=not args.no_focal,
            workers=args.workers, pipeline=pipeline,
            wire=args.wire or tr.input_wire, device_gt=args.device_gt,
            swa=args.swa, swa_freq=args.swa_freq,
            swa_lr_max=args.swa_lr_max, swa_lr_min=args.swa_lr_min,
            supervisor=supervisor, teacher=teacher)
    finally:
        if supervisor is not None:
            supervisor.uninstall_signal_handlers()
        ds.close()
        if val_ds is not None:
            val_ds.close()
    exit_report("train", device, config=args.config, **report,
                state_sha256=state_digest(state.model.state_dict()))


def train(cfg, dataset, epochs: int, *, device, seed: int = 0,
          val_dataset=None, resume=None, use_warmup: bool = True,
          log_fn=print, use_focal: bool = True, workers: int = 0,
          pipeline: str = "sync", wire=None, device_gt: int = 0,
          swa: bool = False, swa_freq: int = 5, swa_lr_max: float = 1e-5,
          swa_lr_min: float = 1e-6, supervisor=None, teacher=None):
    """The train CLI's run, on any dataset with ``len`` and the batch
    protocol of ``data.batches`` (``CocoPoseDataset`` over HDF5,
    ``MemoryDataset``): the model of ``cfg`` built from ``seed`` on
    ``device``, its schedule, optimizer and state, ``resume`` (a checkpoint
    path, or ``"auto"`` for the last committed one of
    ``cfg.train.checkpoint_dir``), and ``fit`` for ``epochs`` with the
    config's async checkpoint and retention.

    ``pipeline="shm"`` with ``workers > 0`` feeds the steps from
    ``ShmRingInput`` rings (supervised under ``supervisor``) through
    ``device_prefetch``; ``device_gt > 0`` makes the labels on the device
    (``max_people`` = ``device_gt``); ``swa`` runs the SWA stage instead
    of ``fit``; ``supervisor`` (a ``RunSupervisor`` whose segment is
    open) makes ``epochs`` the run's total, resumes automatically and
    retries transient failures; ``teacher`` (a model) trains ``cfg``'s
    model as its distilled student.

    Returns ``(state, report)``: the report holds the steps and images
    trained, the median step ms, train imgs/s over the epochs' batch
    loops, the host's data wait ms a step, and each save's blocked and
    writer ms."""
    from ..data import ShmRingInput, batches
    from ..models import build_model
    from ..parallel import device_prefetch
    from ..train import (
        CheckpointManager,
        StopRequested,
        bind_teacher,
        create_train_state,
        cyclic_swa_schedule,
        fit,
        latest_checkpoint,
        make_distill_train_step,
        make_eval_step,
        make_optimizer,
        make_train_step,
        milestone_eval,
        restore_checkpoint,
        start_swa,
        step_decay_schedule,
        swap_swa_params,
        train_epoch,
        update_swa,
    )
    from ..train.loop import _log_line
    from ..train.schedule import large_batch_schedule
    from ..train.supervisor import reshard_on_topology_change

    tr = cfg.train
    wire = wire or tr.input_wire
    global_batch = tr.batch_size_per_device
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    log_fn(f"device={device} global_batch={global_batch} "
           f"steps/epoch={steps_per_epoch}")

    def swa_schedule(start_step=0):
        return cyclic_swa_schedule(steps_per_epoch, swa_freq,
                                   lr_max=swa_lr_max, lr_min=swa_lr_min,
                                   start_step=start_step)

    def build():
        model = build_model(cfg, device=device, seed=seed, train=True)
        if swa:
            schedule = swa_schedule()
        elif tr.lr_batch_ref > 0:
            schedule = large_batch_schedule(tr, steps_per_epoch,
                                            global_batch,
                                            use_warmup=use_warmup)
        else:
            schedule = step_decay_schedule(tr, steps_per_epoch,
                                           use_warmup=use_warmup)
        optimizer = make_optimizer(model, cfg, schedule)
        return create_train_state(model, cfg, optimizer)

    state = build()
    start_epoch, best_loss, resumed_from, meta = 0, float("inf"), None, None
    if supervisor is not None:
        resumed = supervisor.resume(state)
        if resumed is not None:
            state, meta = resumed
    elif resume:
        path = (latest_checkpoint(tr.checkpoint_dir)
                if resume == "auto" else resume)
        if path:
            state, meta = restore_checkpoint(path, state)
            reshard_on_topology_change(meta, path)
            log_fn(f"resumed from {path} (epoch {meta['epoch']})")
    if meta is not None:
        start_epoch = meta["epoch"] + 1
        best_loss = float(meta.get("best_loss", float("inf")))
        resumed_from = meta["epoch"]
    resumed_swa = state.swa_count is not None
    if swa:
        if not resumed_swa:
            start_swa(state)
        # the sawtooth is anchored at the step SWA began, kept in the
        # state, so an interrupted SWA run resumes in phase
        anchor = (state.swa_start_step if state.swa_start_step is not None
                  else state.step)
        if anchor:
            opt = state.optimizer
            opt.schedule = swa_schedule(anchor)
            opt._lrs = opt._lrs[:0]

    def make_step(state):
        model, opt = state.model, state.optimizer
        if teacher is not None:
            return bind_teacher(make_distill_train_step(
                model, teacher, cfg, opt, use_focal=use_focal), teacher)
        return make_train_step(model, cfg, opt, use_focal=use_focal,
                               freeze_bn=swa, device_gt=device_gt > 0)

    clock = StepClock(make_step(state), device)
    eval_step = make_eval_step(state.model, cfg, use_focal=use_focal)
    train_s, wait_s = [0.0], [0.0]
    rings = []
    if pipeline == "shm" and workers > 0:
        train_ring = ShmRingInput(dataset, global_batch, workers,
                                  raw_gt=device_gt, wire=wire,
                                  slots=tr.input_ring_slots,
                                  supervise=supervisor is not None)
        rings.append(train_ring)
    eval_ring = None
    if rings and val_dataset is not None:
        eval_ring = ShmRingInput(val_dataset, global_batch, workers,
                                 wire=wire, slots=tr.input_ring_slots,
                                 supervise=supervisor is not None)
        rings.append(eval_ring)

    def make_train_batches(epoch):
        if rings:
            it = device_prefetch(rings[0].batches(epoch), device, depth=2)
        else:
            it = batches(dataset, global_batch, epoch, pipeline="sync",
                         wire=wire, raw_gt=device_gt)
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            wait_s[0] += time.perf_counter() - t
            if batch is None:
                break
            yield batch
        train_s[0] += time.perf_counter() - t0

    make_eval_batches = None
    if val_dataset is not None:
        def make_eval_batches(epoch):
            if eval_ring is not None:
                return device_prefetch(eval_ring.batches(0), device,
                                       depth=2)
            return batches(val_dataset, global_batch, 0, pipeline="sync",
                           wire=wire)

    manager = CheckpointManager.from_config(tr.checkpoint_dir, tr)

    def milestone(epoch):
        if make_eval_batches is not None:
            loss = milestone_eval(state, eval_step, make_eval_batches(epoch))
            log_fn(f"resume milestone eval (after epoch {epoch}): loss "
                   f"{loss:.6f}")

    try:
        if swa:
            if resumed_swa:
                # saved swapped (params = average): back to the trained
                # weights, the running average kept
                swap_swa_params(state)
            epoch = start_epoch
            for epoch in range(start_epoch, start_epoch + epochs):
                state, train_loss = train_epoch(
                    state, clock, make_train_batches(epoch), cfg, epoch,
                    log_fn=log_fn)
                _log_line(tr.checkpoint_dir,
                          f"\nEpoch {epoch}\ttrain_loss: {train_loss}")
                if (epoch - start_epoch + 1) % swa_freq == 0:
                    _save_swapped(manager, update_swa(state), epoch,
                                  train_loss)
                    log_fn(f"epoch {epoch}: SWA checkpoint saved")
            if epochs and epochs % swa_freq:
                # the trailing epochs past the last cycle are averaged
                # and saved too
                _save_swapped(manager, update_swa(state), epoch, train_loss)
                log_fn(f"epoch {epoch}: final SWA checkpoint saved "
                       f"({epochs % swa_freq} trailing epochs)")
            manager.wait()
        elif supervisor is None:
            fit(state, clock, cfg, make_train_batches, epochs,
                start_epoch=start_epoch, eval_step=eval_step,
                make_eval_batches=make_eval_batches, best_loss=best_loss,
                checkpoint_manager=manager, log_fn=log_fn)
        else:
            if resumed_from is not None:
                milestone(resumed_from)
            while True:
                to_run = epochs - start_epoch
                if to_run <= 0:
                    log_fn(f"supervisor: epoch target {epochs} already "
                           "reached; nothing to train")
                    supervisor.mark_completed()
                    break
                try:
                    fit(state, clock, cfg, make_train_batches, to_run,
                        start_epoch=start_epoch, eval_step=eval_step,
                        make_eval_batches=make_eval_batches,
                        best_loss=best_loss, checkpoint_manager=manager,
                        log_fn=log_fn, should_stop=supervisor.should_stop)
                except StopRequested as e:
                    supervisor.close_segment("preempted", str(e))
                    log_fn(f"supervisor: clean stop: {e}")
                    break
                except Exception as e:
                    if supervisor.on_failure(e) != "retry":
                        raise
                    resumed = supervisor.resume(state)
                    if resumed is None:
                        state = build()
                        clock.step = make_step(state)
                        eval_step = make_eval_step(state.model, cfg,
                                                   use_focal=use_focal)
                        start_epoch, best_loss = 0, float("inf")
                    else:
                        state, meta = resumed
                        start_epoch = meta["epoch"] + 1
                        best_loss = float(meta.get("best_loss",
                                                   float("inf")))
                        milestone(meta["epoch"])
                    continue
                supervisor.mark_completed()
                break
    finally:
        manager.close()
        for ring in rings:
            ring.close()
    images = len(clock.marks) * global_batch
    return state, dict(
        steps=len(clock.marks), images=images,
        step_ms_median=clock.median_ms(),
        train_imgs_per_s=images / max(train_s[0], 1e-9),
        data_wait_ms_per_step=1e3 * wait_s[0] / max(len(clock.marks), 1),
        save_blocked_ms=[1e3 * s for s in manager.blocked_seconds],
        save_write_ms=[1e3 * s for s in manager.write_seconds])


def _save_swapped(manager, state, epoch: int, train_loss: float) -> None:
    """Save ``state`` with the SWA average swapped in (the trained weights
    in ``swa_params``), then swap back: the snapshot is the manager's
    once ``save`` returns, so training goes on from the trained
    weights."""
    from ..train import swap_swa_params

    swap_swa_params(state)
    try:
        manager.save(state, epoch, train_loss, train_loss)
    finally:
        swap_swa_params(state)


if __name__ == "__main__":
    main()
