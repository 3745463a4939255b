"""Epoch-boundary checkpoint stall, sync against async, on a real ``fit``
(counterpart of ``tools/ckpt_bench.py``)::

    python -m improved_body_parts_torch.cli.ckpt_bench --config canonical \\
        --rounds 3 --epochs 3 --steps 12 --out ckpt_bench_torch.json

The number measured is the train loop's blocked seconds a save
(``CheckpointManager.blocked_seconds``): the sync arm blocks on the whole
``torch.save`` and commit, the async arm only on the device→host
snapshot into pinned buffers (the write overlaps validation and the
next epoch's steps).  Each arm is a real multi-epoch ``fit`` (the
train step on the focal kernels, an eval pass each epoch) of
``--config``'s full training state: parameters and BN stats, SGD
momentum and the SWA shadow.  After an untimed warm-up (one step and
one save) they run in interleaved ABBA rounds (host-load drift hits both alike);
the verdict is the median of the per-round sync / async stall ratios
against ``STALL_REDUCTION_TARGET``.  Each arm's directory is deleted
once read.

It also checks that a sync and an async save of one state restore
bit-identical tensors, and, from a ``obs.RunTelemetry`` trace of one
async arm, that the ``serialize`` / ``commit`` spans overlap later
``step_window`` / eval spans: the write left the loop's critical path.

Writes ``ckpt_bench_torch.json`` (``--out``; the JAX tool's
``CKPT_BENCH.json`` is refused) with the card's name and power limit.
``--strict`` exits 1 when the target or the bit identity fails.  Runs on
``--device cuda`` unless asked for ``cpu``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import tempfile

STALL_REDUCTION_TARGET = 5.0

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("CKPT_BENCH.json",)


def _spans(events, names):
    """(start_us, end_us, name) of every complete X span named in
    ``names`` of a trace-event list."""
    return [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("name") in names]


def write_overlaps(events) -> int:
    """Spans of the step windows, eval or the step's phases that started
    inside a ``serialize`` or ``commit`` span."""
    writes = _spans(events, {"serialize", "commit"})
    targets = _spans(events, {"step_window", "eval_epoch", "data_wait",
                              "compute"})
    return sum(1 for w0, w1, _ in writes for t0, _, _ in targets
               if w0 < t0 < w1)


def same_payload(a: dict, b: dict) -> bool:
    """Two restored payloads hold the same keys, and every tensor the same
    dtype, shape and bits."""
    import torch

    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict) or isinstance(y, dict):
            if not (isinstance(x, dict) and isinstance(y, dict)
                    and same_payload(x, y)):
                return False
        elif isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor)
                    and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny",
                    help="model and config under test (the state carries "
                         "params, momentum, BN stats and the SWA shadow at "
                         "any width)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved sync/async rounds (ABBA order)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="fit epochs an arm a round; every epoch boundary "
                         "is one measured save")
    ap.add_argument("--steps", type=int, default=12,
                    help="train steps an epoch: the wall time the "
                         "background write hides behind (a shorter epoch "
                         "than the write shows up as wait time at the "
                         "next save, which the stall counts)")
    ap.add_argument("--eval-steps", type=int, default=4)
    ap.add_argument("--print-freq", type=int, default=2)
    ap.add_argument("--out", default="ckpt_bench_torch.json")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when the stall-reduction target or the "
                         "bit identity fails")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..obs import Registry, RunTelemetry
    from ..obs.events import strict_dump, strict_dumps
    from ..train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_eval_step,
        make_optimizer,
        make_train_step,
        read_commit_meta,
        restore_checkpoint,
        save_checkpoint,
        start_swa,
        step_decay_schedule,
    )
    from ..train.checkpoint import _named_state
    from . import card_stamp, refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, print_freq=args.print_freq))
    batch = max(cfg.train.batch_size_per_device, 1)
    size = cfg.skeleton.height
    grid = size // cfg.skeleton.stride
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    imgs = tensor(rng.uniform(0, 1, (batch, size, size, 3)))
    labels = tensor(rng.uniform(0, 1, (batch, grid, grid,
                                       cfg.skeleton.num_layers)))
    mask = torch.ones((batch, grid, grid, 1), device=device)

    def make_batches(epoch, steps=args.steps):
        return ((imgs, mask, labels) for _ in range(steps))

    def make_eval_batches(epoch):
        return ((imgs, mask, labels) for _ in range(args.eval_steps))

    model = build_model(cfg, device=device, seed=0, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        cfg.train, steps_per_epoch=100))
    # the full training state a run saves: params, BN stats, momentum and
    # the SWA shadow
    state = start_swa(create_train_state(model, cfg, opt))
    # the step updates the state in place: each arm starts from this copy
    master = {k: v.detach().to("cpu", copy=True)
              for k, v in _named_state(state).items()}
    payload_bytes = int(sum(t.numel() * t.element_size()
                            for t in master.values()))

    def reset():
        with torch.no_grad():
            for k, v in _named_state(state).items():
                v.copy_(master[k])
        state.step = 0

    train_step = make_train_step(model, cfg, opt)
    eval_step = make_eval_step(model, cfg)
    work = tempfile.mkdtemp(prefix="ckpt_bench_")

    def run_arm(async_save, tag, telemetry=None, epochs=args.epochs,
                steps=args.steps):
        """One fit from the initial state; its manager's blocked seconds
        a save.  The arm's directory is deleted once read."""
        d = os.path.join(work, tag)
        reset()
        manager = CheckpointManager(d, async_save=async_save)
        try:
            fit(state, train_step, cfg,
                lambda epoch: make_batches(epoch, steps), epochs,
                eval_step=eval_step, make_eval_batches=make_eval_batches,
                checkpoint_dir=d, log_fn=lambda s: None,
                telemetry=telemetry, checkpoint_manager=manager)
        finally:
            manager.close()
            shutil.rmtree(d, ignore_errors=True)
        return list(manager.blocked_seconds)

    # untimed, one step and one save: cuDNN's algorithm choice, the
    # allocator's first blocks and the writer's first call (the pinned
    # snapshot buffers are each arm's own manager's, so no warm-up
    # reaches them; the JAX tool warms each arm to compile its step)
    run_arm(True, "warm", epochs=1, steps=1)

    sync_rounds, async_rounds = [], []
    for i in range(max(1, args.rounds)):
        order = [(False, sync_rounds), (True, async_rounds)]
        if i % 2:
            order.reverse()
        for async_save, sink in order:
            sink.append(run_arm(
                async_save, f"r{i}_{'async' if async_save else 'sync'}"))

    # interchangeability: one state through both paths
    reset()
    sync_path = save_checkpoint(os.path.join(work, "ident_sync"), state,
                                0, 1.0, 1.0)
    with CheckpointManager(os.path.join(work, "ident_async")) as m:
        async_path = m.save(state, 0, 1.0, 1.0)
    bit_identical = same_payload(restore_checkpoint(sync_path),
                                 restore_checkpoint(async_path))
    commit_meta = read_commit_meta(async_path)
    for p in (sync_path, async_path):
        shutil.rmtree(os.path.dirname(p), ignore_errors=True)

    # the timeline: the write must overlap later step / eval spans
    ev_path = os.path.join(work, "events.jsonl")
    trace_path = os.path.join(work, "trace.json")
    tele = RunTelemetry(ev_path, registry=Registry(),
                        run_meta={"tool": "ckpt_bench"},
                        trace_path=trace_path, watch_compiles=False,
                        device=device)
    try:
        run_arm(True, "instrumented", telemetry=tele)
        trace_events = tele.trace.events()
    finally:
        tele.close()

    sync_flat = [v for r in sync_rounds for v in r]
    async_flat = [v for r in async_rounds for v in r]
    per_round = [statistics.mean(s) / max(statistics.mean(a), 1e-9)
                 for s, a in zip(sync_rounds, async_rounds)]
    reduction = statistics.median(per_round)
    overlaps = write_overlaps(trace_events)
    report = {
        "config": args.config,
        "protocol": "real multi-epoch fit (the port's train step, an eval "
                    "pass each epoch) an arm; interleaved ABBA rounds; "
                    "stall = CheckpointManager.blocked_seconds a save; "
                    "verdict = median per-round sync/async ratio",
        "rounds": args.rounds,
        "epochs_per_arm": args.epochs,
        "steps_per_epoch": args.steps,
        "batch": batch, "image_size": size,
        "payload_bytes": payload_bytes,
        "saves_per_arm": len(sync_rounds[0]) if sync_rounds else 0,
        "sync_stall_ms_mean": round(statistics.mean(sync_flat) * 1e3, 3),
        "sync_stall_ms_median": round(statistics.median(sync_flat) * 1e3,
                                      3),
        "async_stall_ms_mean": round(statistics.mean(async_flat) * 1e3, 3),
        "async_stall_ms_median": round(
            statistics.median(async_flat) * 1e3, 3),
        "per_round_stall_reduction": [round(r, 2) for r in per_round],
        "stall_reduction": round(reduction, 2),
        "stall_reduction_target": STALL_REDUCTION_TARGET,
        "meets_target": bool(reduction >= STALL_REDUCTION_TARGET),
        "bit_identical_restore": bool(bit_identical),
        "write_spans": len(_spans(trace_events, {"serialize", "commit"})),
        "snapshot_spans": len(_spans(trace_events, {"snapshot"})),
        "write_overlapping_later_spans": overlaps,
        "write_overlaps_step_or_eval": bool(overlaps > 0),
        "trace": trace_path,
        "telemetry_events": ev_path,
        "platform": device.type, **card_stamp(device),
        "host_note": f"cpu_count={os.cpu_count()}, device={device.type}",
        "commit_meta_sample": commit_meta,
    }
    with open(args.out, "w") as f:
        strict_dump(report, f, indent=2)
    print(strict_dumps(report))
    if args.strict and not (report["meets_target"]
                            and report["bit_identical_restore"]):
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
