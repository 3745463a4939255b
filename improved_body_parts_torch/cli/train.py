"""Training CLI of the port (counterpart of ``tools/train.py``)::

    python -m improved_body_parts_torch.cli.train --config canonical \\
        --epochs 100 --train-h5 data/coco_train_dataset512.h5 --workers 4
    python -m improved_body_parts_torch.cli.train --swa --resume auto ...
    # one process a card, rank 0 listening on host:port
    python -m improved_body_parts_torch.cli.train --coordinator host:port \\
        --num-processes 2 --process-id 0 ...

Builds the model (any variant of ``--config``), state and step with the
port's ``train`` package and runs ``fit`` with the async checkpoint.
Flags, with the JAX CLI's meaning:

- input: ``--workers N --input-pipeline {shm,sync}`` (the shared-memory
  ring of N spawn workers, its batches copied ahead to the device by
  ``parallel.device_prefetch``; the config's ``input_pipeline`` by
  default), ``--wire {uint8,f32}``, ``--device-gt MAX_PEOPLE`` (labels
  made on the device from padded joints); ``--train-h5`` / ``--val-h5``
  take an HDF5 corpus or a records file (``.npz``,
  ``data.fixture.save_records``, for a host without h5py);
  ``--debug-overlays`` draws the first batch of each epoch under
  ``<checkpoint_dir>/overlays`` (skipped under ``--device-gt``);
- ``--no-focal`` (plain L2), ``--on-divergence {warn,halt,skip_step}``
  (the run-health sentinel's policy: warn records a divergent window,
  halt stops the run with ``obs.DivergenceError``, skip_step drops the
  update inside the step);
- telemetry: ``--telemetry-sink`` (the JSONL event stream; ``auto`` =
  ``<checkpoint_dir>/events.jsonl``), ``--telemetry-port`` (the live
  ``/metrics`` + ``/snapshot`` + ``/healthz`` endpoint; 0 = ephemeral)
  and ``--telemetry-trace`` (the span trace; ``auto`` =
  ``<checkpoint_dir>/trace.json``), through ``obs.RunTelemetry``; the
  bundle runs whenever one of them is set or the policy is not warn,
  and the step then returns its gradient norm for the sentinel;
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
  --distill-alpha-warmup`` (``train.distill``); over more than one
  process it is the replicated multi-rank step (every rank distils its
  rows, the teacher on each rank);
- multi-card (``parallel``): ``--coordinator HOST:PORT --num-processes N
  --process-id I`` start one rank a process (NCCL on the card, gloo on
  the CPU); each rank trains ``batch_size_per_device`` rows of every
  global batch (``data.dataset.resolve_host_shard``: strided, or
  contiguous slabs when partitioned), under DDP with cross-rank
  BatchNorm; ``--partition --partition-rules NAME --mesh-model M`` hold
  the state as the partition rules lay it out on a ``(ranks / M, M)``
  mesh, and the ruleset's fingerprint rides the topology stamp;
  ``--reshard {adjust,refuse}`` is the policy for a checkpoint stamped
  under another topology (default: refuse, adjust when supervised);
  ``--lr-batch-ref`` scales the LR linearly by global batch /
  reference.  Rank 0 alone writes checkpoints, ``RUN.json`` and the
  epoch log and serves the telemetry endpoint; the event sink and trace
  of rank I > 0 get a ``.pI`` suffix.

``--resume auto`` continues from the last committed checkpoint of
``--checkpoint-dir``.  Runs on ``--device cuda`` unless asked for
``cpu``.  At exit it prints the ``CLI_REPORT`` line (``cli``): the device,
the kernels' launches, the steps and images trained, the median step
time, train imgs/s, each save's blocked and writer ms, and a SHA-256 of
the final model ``state_dict``.

Refused with an error: the retired ``--input-pipeline pool``, and
``--distill-from`` with ``--partition`` (the distillation step runs the
replicated rules, as the JAX CLI's does).
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
import torch.distributed


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
                    help="run-health sentinel policy on a non-finite "
                         "loss/grad-norm window (default: the config's "
                         "on_divergence): warn = record and continue, "
                         "halt = stop the run, skip_step = drop the "
                         "update inside the step")
    ap.add_argument("--telemetry-sink", default=None,
                    help="JSONL run-event stream (default: the config's "
                         "telemetry_sink; 'auto' = <checkpoint_dir>/"
                         "events.jsonl, '' disables)")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    help="live /metrics (Prometheus) + /snapshot (JSON) "
                         "+ /healthz endpoint port (default: the "
                         "config's telemetry_port; 0 = ephemeral, "
                         "-1 disables)")
    ap.add_argument("--telemetry-trace", default=None,
                    help="span-trace export path (default: the config's "
                         "telemetry_trace; 'auto' = <checkpoint_dir>/"
                         "trace.json, '' disables; open it at "
                         "ui.perfetto.dev)")
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
    ap.add_argument("--debug-overlays", action="store_true",
                    help="save a GT heatmap overlay of the first batch each "
                         "epoch under <checkpoint_dir>/overlays (the "
                         "reference's show_image debug display, "
                         "train.py:188-200)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameter init and the data pipeline")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--reshard", default=None, choices=("adjust", "refuse"),
                    help="a checkpoint stamped under another device "
                         "topology: 'adjust' re-places the state onto the "
                         "current mesh (global batch and world-size LR "
                         "follow the new count), 'refuse' errors out "
                         "(default: refuse, adjust under --supervised)")
    ap.add_argument("--partition", action="store_true",
                    help="hold the state as the partition ruleset lays it "
                         "out (wide conv kernels split over the mesh), "
                         "batch over 'data', contiguous-slab input shard; "
                         "the ruleset's fingerprint is stamped into every "
                         "checkpoint")
    ap.add_argument("--partition-rules", default=None,
                    help="named ruleset (default: the config's "
                         "partition_rules; 'replicated' replicates every "
                         "leaf)")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="'model' mesh-axis size (default: the config's "
                         "mesh_model_axis; data axis = ranks / model)")
    ap.add_argument("--lr-batch-ref", type=int, default=None,
                    help="global batch the base LR was tuned at: scale the "
                         "LR linearly by global batch / ref with a gradual "
                         "warmup (default: the config's lr_batch_ref; 0 "
                         "keeps the per-device world-size rule)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (multi-process training)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def _refuse(msg: str):
    raise SystemExit(msg)


def resolve_args(args):
    """The config of ``args`` with the CLI's overrides folded in, after
    the checks the JAX CLI makes (and the port's refusals); returns
    ``(cfg, teacher_cfg)``."""
    from ..config import get_config

    if args.num_processes < 1 or not (
            0 <= args.process_id < args.num_processes):
        _refuse(f"--process-id {args.process_id} is out of range for "
                f"--num-processes {args.num_processes}")
    if (args.num_processes > 1) != (args.coordinator is not None):
        _refuse("--coordinator and --num-processes > 1 start a "
                "multi-process run together: pass both or neither")
    if args.input_pipeline == "pool":
        _refuse("--input-pipeline pool (the retired spawn pool) is not "
                "ported; use shm or sync (ROADMAP.md, queue 1)")
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
        if args.partition or cfg.train.partition:
            _refuse("--distill-from runs the replicated step (the "
                    "student is small — that is the point); drop "
                    "--partition")
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
                         "distill_alpha_warmup_steps"),
                        ("partition_rules", "partition_rules"),
                        ("mesh_model", "mesh_model_axis"),
                        ("lr_batch_ref", "lr_batch_ref")):
        if getattr(args, flag) is not None:
            overrides[field] = getattr(args, flag)
    if args.partition:
        overrides["partition"] = True
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    tr = cfg.train
    if not tr.partition and (args.mesh_model is not None
                             or args.partition_rules):
        _refuse("--mesh-model/--partition-rules require --partition (or a "
                "config with partition=True)")
    if tr.partition:
        from ..parallel.partition import NAMED_RULESETS

        if args.swa:
            _refuse("--partition covers the main fit only; run the SWA "
                    "stage without it")
        if tr.partition_rules not in NAMED_RULESETS:
            _refuse(f"--partition-rules {tr.partition_rules!r}: unknown; "
                    f"available: {sorted(NAMED_RULESETS)}")
        if args.num_processes % tr.mesh_model_axis:
            _refuse(f"--mesh-model {tr.mesh_model_axis} does not divide "
                    f"--num-processes {args.num_processes}")
    return cfg, teacher_cfg


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


def make_telemetry(args, cfg, device, supervisor=None):
    """The run's ``obs.RunTelemetry`` from the telemetry flags (each
    defaults to the config's knob), or None when no sink, trace or
    endpoint is asked for and the divergence policy is ``warn``: a
    non-warn policy needs the sentinel running even then, or ``--on-
    divergence halt`` would be accepted and not enforced.  Rank I > 0
    writes its own ``.pI`` sink and trace and serves no endpoint.
    Returns ``(telemetry, sink_path, trace_path)``."""
    from ..obs import RunTelemetry, resolve_sink_path

    tr = cfg.train
    rank = args.process_id
    sink_cfg = (args.telemetry_sink if args.telemetry_sink is not None
                else tr.telemetry_sink)
    sink_path = resolve_sink_path(sink_cfg, tr.checkpoint_dir)
    trace_cfg = (args.telemetry_trace if args.telemetry_trace is not None
                 else tr.telemetry_trace)
    trace_path = resolve_sink_path(trace_cfg, tr.checkpoint_dir,
                                   default_name="trace.json")
    port = (args.telemetry_port if args.telemetry_port is not None
            else tr.telemetry_port)
    # decided from argv and config alone, the same on every rank: the
    # bundle makes the step return its gradient norm
    if not (sink_path or trace_path or port >= 0
            or tr.on_divergence != "warn"):
        return None, sink_path, trace_path
    if rank > 0:
        # one stream and one timeline a rank; the endpoint is rank 0's
        sink_path = sink_path and f"{sink_path}.p{rank}"
        trace_path = trace_path and f"{trace_path}.p{rank}"
        port = -1
    meta = {"tool": "train", "config": args.config, "seed": args.seed,
            "process_id": rank}
    if supervisor is not None:
        meta.update(run_id=supervisor.run_id, segment=supervisor.segment)
    telemetry = RunTelemetry(
        sink_path, http_port=port if port >= 0 else None, run_meta=meta,
        step_sample=tr.telemetry_sample, trace_path=trace_path,
        on_divergence=tr.on_divergence,
        grad_norm_limit=tr.health_grad_norm_limit, device=device)
    if telemetry.server is not None:
        print(f"telemetry: {telemetry.server.url}/metrics")
    return telemetry, sink_path, trace_path


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg, teacher_cfg = resolve_args(args)

    from .. import resolve_device
    from ..obs.events import strict_dump
    from ..parallel import initialize_distributed, shutdown_distributed
    from ..parallel.mesh import process_index, rank_device
    from ..train import RunSupervisor

    device = rank_device(resolve_device(args.device), args.process_id)
    had_group = torch.distributed.is_initialized()
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=device)
    tr = cfg.train
    is_lead = process_index() == 0
    supervisor = None
    argv_list = list(sys.argv[1:] if argv is None else argv)
    try:
        if args.supervised:
            supervisor = RunSupervisor(
                tr.checkpoint_dir, max_restarts=args.max_restarts,
                crash_budget=args.crash_budget,
                backoff_base_s=args.backoff_base,
                backoff_max_s=args.backoff_max,
                reshard=args.reshard or "adjust",
                rules=_partition_rules(cfg))
            supervisor.open_segment({"argv": argv_list})
            supervisor.install_signal_handlers()
        telemetry, sink_path, trace_path = make_telemetry(
            args, cfg, device, supervisor)
        if supervisor is not None:
            # /healthz reports running/draining/backing-off next to the
            # sentinel state, and the segment_start record enters the
            # stream
            supervisor.bind(telemetry)
        manifest = {"tool": "train", "config": args.config,
                    "argv": argv_list, "telemetry_events": sink_path,
                    "telemetry_trace": trace_path,
                    "on_divergence": tr.on_divergence,
                    "telemetry_port": (telemetry.server.port
                                       if telemetry is not None
                                       and telemetry.server is not None
                                       else None)}
        if supervisor is not None:
            supervisor.update_manifest(manifest)
        elif is_lead:
            os.makedirs(tr.checkpoint_dir, exist_ok=True)
            with open(os.path.join(tr.checkpoint_dir, "RUN.json"),
                      "w") as f:
                strict_dump(manifest, f, indent=2)

        try:
            _run(args, cfg, teacher_cfg, device, supervisor, telemetry)
        finally:
            # a crash, and a sentinel halt above all, must still close
            # the bundle: it saves the span trace and restores the
            # defaults
            if telemetry is not None:
                telemetry.close()
    finally:
        # the group this run started (the ranks' own, or the one-rank
        # group a partitioned run on one card brings up)
        if not had_group:
            shutdown_distributed()


def _partition_rules(cfg):
    """The run's partition ruleset, or None for the replicated regime."""
    if not cfg.train.partition:
        return None
    from ..parallel.partition import get_ruleset

    return get_ruleset(cfg.train.partition_rules)


def _run(args, cfg, teacher_cfg, device, supervisor, telemetry):
    """The CLI's mesh, datasets and :func:`train`, then its
    ``CLI_REPORT``."""
    from ..data import open_corpus
    from ..parallel import make_mesh
    from ..parallel.mesh import process_index
    from ..train import TopologyChanged
    from ..train.checkpoint import _named_state
    from . import exit_report

    tr = cfg.train
    mesh = None
    if args.num_processes > 1 or tr.partition:
        mesh = make_mesh(model=tr.mesh_model_axis if tr.partition else 1,
                         device=device)
    teacher = None
    if args.distill_from:
        teacher = load_teacher(teacher_cfg, args.distill_from, device)
        print(f"distilling from {args.distill_from} (teacher "
              f"{args.teacher_config}, alpha {tr.distill_alpha}, warmup "
              f"{tr.distill_alpha_warmup_steps} steps)")
    train_h5 = args.train_h5 or tr.hdf5_train_data
    val_h5 = args.val_h5 or tr.hdf5_val_data
    if args.num_processes > 1 and val_h5 and not os.path.exists(val_h5):
        # eval is collective: a rank that skipped it would leave the
        # others waiting in its loss reduction
        raise SystemExit(f"--val-h5 {val_h5} missing on this host; every "
                         "rank needs it in a multi-process run (or drop "
                         "--val-h5)")
    ds = open_corpus(train_h5, cfg, augment=True, seed=args.seed)
    val_ds = (open_corpus(val_h5, cfg, augment=False)
              if os.path.exists(val_h5) else None)
    pipeline = args.input_pipeline or tr.input_pipeline
    debug_overlays = args.debug_overlays and process_index() == 0
    if args.debug_overlays and args.device_gt:
        print("--debug-overlays needs host-side labels; "
              "skipped under --device-gt")
        debug_overlays = False
    try:
        state, report = train(
            cfg, ds, args.epochs or tr.epochs, device=device,
            seed=args.seed, val_dataset=val_ds, resume=args.resume,
            use_warmup=not args.no_warmup, use_focal=not args.no_focal,
            workers=args.workers, pipeline=pipeline,
            wire=args.wire or tr.input_wire, device_gt=args.device_gt,
            swa=args.swa, swa_freq=args.swa_freq,
            swa_lr_max=args.swa_lr_max, swa_lr_min=args.swa_lr_min,
            supervisor=supervisor, teacher=teacher, telemetry=telemetry,
            mesh=mesh, partition_rules=_partition_rules(cfg),
            reshard=args.reshard or "refuse", debug_overlays=debug_overlays)
    except TopologyChanged as e:
        raise SystemExit(str(e)) from None
    finally:
        if supervisor is not None:
            supervisor.uninstall_signal_handlers()
        ds.close()
        if val_ds is not None:
            val_ds.close()
    model_sd = {k[len("model/"):]: v for k, v in _named_state(state).items()
                if k.startswith("model/")}
    exit_report("train", device, config=args.config,
                process_id=args.process_id,
                num_processes=args.num_processes, **report,
                state_sha256=state_digest(model_sd))


def train(cfg, dataset, epochs: int, *, device, seed: int = 0,
          val_dataset=None, resume=None, use_warmup: bool = True,
          log_fn=print, use_focal: bool = True, workers: int = 0,
          pipeline: str = "sync", wire=None, device_gt: int = 0,
          swa: bool = False, swa_freq: int = 5, swa_lr_max: float = 1e-5,
          swa_lr_min: float = 1e-6, supervisor=None, teacher=None,
          telemetry=None, mesh=None, partition_rules=None,
          reshard: str = "refuse", debug_overlays: bool = False):
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
    model as its distilled student; ``telemetry`` (an open
    ``obs.RunTelemetry``) reports every window and epoch, exports the
    rings' internals and has the step return its gradient norm for the
    health sentinel.

    ``mesh`` (``parallel.make_mesh``; every rank of it calls ``train``
    with the same arguments) trains each rank on its host shard of the
    epoch's global batches of ``batch_size_per_device * data`` rows, with
    the LR's world size the ``'data'`` extent; ``partition_rules`` (a
    ruleset, None for the replicated regime) lays the state out and rides
    the topology stamp with its fingerprint; ``reshard`` is the policy
    for a ``resume`` stamped under another topology.  Rank 0 writes the
    checkpoints and the log.  ``debug_overlays`` writes each epoch's first
    host batch as ``<checkpoint_dir>/overlays/epoch_<N>.png`` (the person
    mask and the first keypoint over the image,
    ``utils.visualize.save_batch_overlays``); it needs host labels.

    Returns ``(state, report)``: the report holds the steps and images
    trained, the median step ms, train imgs/s over the epochs' batch
    loops, the host's data wait ms a step, and each save's blocked and
    writer ms."""
    from ..data import ShmRingInput, batches
    from ..models import build_model
    from ..parallel import (
        barrier,
        device_prefetch,
        mesh_topology,
        sharding_summary,
        train_state_shardings,
    )
    from ..parallel.mesh import (
        axis_index,
        axis_sizes,
        process_count,
        process_index,
    )
    from ..parallel.partition import get_ruleset, rules_fingerprint
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
        swap_swa_params,
        train_epoch,
        update_swa,
    )
    from ..train.loop import _log_line
    from ..train.supervisor import reshard_on_topology_change

    tr = cfg.train
    if teacher is not None and partition_rules is not None:
        raise ValueError("distillation runs the replicated step; pass no "
                         "partition_rules with a teacher")
    wire = wire or tr.input_wire
    data_index, data_ranks, model_ranks = 0, 1, 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        data_index = axis_index(mesh, "data")
        data_ranks, model_ranks = sizes["data"], sizes["model"]
    is_lead = process_index() == 0
    rank_batch = tr.batch_size_per_device
    global_batch = rank_batch * data_ranks
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    # the partitioned path takes contiguous slabs of each global batch
    # (the single-host batch, row for row); the replicated one the
    # strided shard
    shard = "batch" if partition_rules is not None else "strided"
    step_rules = partition_rules
    if mesh is not None and step_rules is None:
        step_rules = get_ruleset("replicated")
    rules_hash = (rules_fingerprint(partition_rules)
                  if partition_rules is not None else None)
    log_fn(f"device={device} mesh=data:{data_ranks},model:{model_ranks} "
           f"global_batch={global_batch} rank_batch={rank_batch} "
           f"steps/epoch={steps_per_epoch}"
           + (f" partition_rules={tr.partition_rules}#{rules_hash}"
              if partition_rules is not None else ""))

    def swa_schedule(start_step=0):
        return cyclic_swa_schedule(steps_per_epoch, swa_freq,
                                   lr_max=swa_lr_max, lr_min=swa_lr_min,
                                   start_step=start_step)

    def build():
        model = build_model(cfg, device=device, seed=seed, train=True)
        schedule = (swa_schedule() if swa else
                    lr_schedule(tr, steps_per_epoch, rank_batch, data_ranks,
                                use_warmup=use_warmup))
        optimizer = make_optimizer(model, cfg, schedule)
        return create_train_state(model, cfg, optimizer)

    state = build()
    if partition_rules is not None:
        log_fn("partitioned state: " + str(sharding_summary(
            train_state_shardings(state.model, state.optimizer, mesh,
                                  partition_rules))))
    start_epoch, best_loss, resumed_from, meta = 0, float("inf"), None, None
    if supervisor is not None:
        resumed = supervisor.resume(state, mesh, process_count(),
                                    device=device)
        if resumed is not None:
            state, meta = resumed
    elif resume:
        path = (latest_checkpoint(tr.checkpoint_dir)
                if resume == "auto" else resume)
        if path:
            state, meta = restore_checkpoint(path, state)
            state, _ = reshard_on_topology_change(
                state, meta, mesh, process_count(), reshard, path,
                log_fn=log_fn, rules=partition_rules, device=device)
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

    # the sentinel reads the step's gradient norm whenever a bundle runs
    health = telemetry is not None

    def make_step(state):
        model, opt = state.model, state.optimizer
        if teacher is not None:
            return bind_teacher(make_distill_train_step(
                model, teacher, cfg, opt, use_focal=use_focal,
                health=health, mesh=mesh), teacher)
        return make_train_step(model, cfg, opt, use_focal=use_focal,
                               freeze_bn=swa, device_gt=device_gt > 0,
                               health=health, mesh=mesh, rules=step_rules)

    clock = StepClock(make_step(state), device)
    eval_step = make_eval_step(state.model, cfg, use_focal=use_focal,
                               mesh=mesh)
    train_s, wait_s = [0.0], [0.0]
    rings = []
    if pipeline == "shm" and workers > 0:
        train_ring = ShmRingInput(dataset, rank_batch, workers,
                                  raw_gt=device_gt, wire=wire,
                                  slots=tr.input_ring_slots,
                                  supervise=supervisor is not None)
        rings.append(train_ring)
    eval_ring = None
    if rings and val_dataset is not None:
        eval_ring = ShmRingInput(val_dataset, rank_batch, workers,
                                 wire=wire, slots=tr.input_ring_slots,
                                 supervise=supervisor is not None)
        rings.append(eval_ring)
    if telemetry is not None and rings:
        train_ring.attach_telemetry(telemetry.registry)
        if eval_ring is not None:
            eval_ring.attach_telemetry(telemetry.registry,
                                       prefix="eval_input_ring")
    host = dict(process_index=data_index, process_count=data_ranks)

    if debug_overlays and device_gt:
        raise ValueError("debug_overlays needs host labels; drop device_gt")

    def with_overlay(it, epoch):
        """``it`` with its first batch drawn to the epoch's overlay."""
        from ..utils.visualize import save_batch_overlays

        overlay_dir = os.path.join(tr.checkpoint_dir, "overlays")
        os.makedirs(overlay_dir, exist_ok=True)
        for i, (images, mask, labels) in enumerate(it):
            if i == 0:
                sk = cfg.skeleton
                save_batch_overlays(
                    os.path.join(overlay_dir, f"epoch_{epoch}.png"),
                    images, labels, channels=(sk.bkg_start, sk.heat_start))
            yield images, mask, labels

    def make_train_batches(epoch):
        if rings:
            it = rings[0].batches(epoch, shard=shard, **host)
        else:
            it = batches(dataset, rank_batch, epoch, pipeline="sync",
                         wire=wire, raw_gt=device_gt, shard=shard, **host)
        if debug_overlays:
            it = with_overlay(it, epoch)
        if rings:
            it = device_prefetch(it, device, depth=2)
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
                return device_prefetch(eval_ring.batches(0, shard=shard,
                                                         **host),
                                       device, depth=2)
            return batches(val_dataset, rank_batch, 0, pipeline="sync",
                           wire=wire, shard=shard, **host)

    manager = CheckpointManager.from_config(
        tr.checkpoint_dir, tr,
        registry=telemetry.registry if telemetry is not None else None,
        topology=mesh_topology(mesh, partition_rules=rules_hash,
                               device=device))

    def milestone(epoch):
        if make_eval_batches is not None:
            loss = milestone_eval(state, eval_step, make_eval_batches(epoch),
                                  mesh=mesh)
            if is_lead:
                log_fn(f"resume milestone eval (after epoch {epoch}): loss "
                       f"{loss:.6f}")

    # ranks drift apart over their own set-up (corpus, model, resume);
    # meet before the first step's collectives
    barrier()
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
                    mesh=mesh, log_fn=log_fn, telemetry=telemetry)
                if is_lead:
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
                start_epoch=start_epoch, mesh=mesh, eval_step=eval_step,
                make_eval_batches=make_eval_batches,
                best_loss=best_loss, checkpoint_manager=manager,
                log_fn=log_fn, telemetry=telemetry)
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
                        start_epoch=start_epoch, mesh=mesh,
                        eval_step=eval_step,
                        make_eval_batches=make_eval_batches,
                        best_loss=best_loss,
                        checkpoint_manager=manager, log_fn=log_fn,
                        telemetry=telemetry,
                        should_stop=supervisor.should_stop)
                except StopRequested as e:
                    supervisor.close_segment("preempted", str(e))
                    log_fn(f"supervisor: clean stop: {e}")
                    break
                except Exception as e:
                    if supervisor.on_failure(e) != "retry":
                        raise
                    resumed = supervisor.resume(state, mesh,
                                                process_count(),
                                                device=device)
                    if resumed is None:
                        state = build()
                        clock.step = make_step(state)
                        eval_step = make_eval_step(state.model, cfg,
                                                   use_focal=use_focal,
                                                   mesh=mesh)
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


def lr_schedule(train_cfg, steps_per_epoch: int, rank_batch: int,
                data_ranks: int, use_warmup: bool = True):
    """The main fit's LR schedule, as the JAX CLI picks it: with
    ``lr_batch_ref > 0`` the large-batch recipe, linear in the global
    batch (``rank_batch * data_ranks``) over the reference; otherwise the
    step decay times the world size, the ranks that carry rows
    (train_distributed.py:388; ``'model'`` ranks split tensors)."""
    from ..train.schedule import large_batch_schedule, step_decay_schedule

    if train_cfg.lr_batch_ref > 0:
        return large_batch_schedule(train_cfg, steps_per_epoch,
                                    rank_batch * data_ranks,
                                    use_warmup=use_warmup)
    return step_decay_schedule(train_cfg, steps_per_epoch,
                               world_size=data_ranks, use_warmup=use_warmup)


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
