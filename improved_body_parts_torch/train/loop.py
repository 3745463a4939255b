"""Epoch-level training loop (counterpart of
``improved_body_parts_tpu/train/loop.py`` ``train_epoch``, ``eval_epoch``
and ``fit``; reference: train.py:104-206, train_distributed.py:225-379).

Each host batch goes to the device through pinned memory with a
``non_blocking`` copy (``train.step.to_device``; a batch that
``parallel.prefetch.device_prefetch`` already placed passes through), so
the copy and the host's work on the next batch overlap the step the
device is running.  The losses stay on the device and
are read back once every ``print_freq`` steps (eval: ``readback_freq``
batches), the reference's throttled readback (train_distributed.py:
272-298).  At that readback the losses (and, for a step built with
``health=True``, the gradient norms) of the window are stacked and read
back in one copy.  ``fit`` runs the epochs with the async per-epoch
checkpoint (``train.checkpoint.CheckpointManager``) and the append-only
epoch log; ``telemetry=`` (an ``obs.RunTelemetry``) reports each window
and epoch through the run's bundle.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from ..config import Config
from ..obs.health import DivergenceError
from ..obs.trace import get_tracer
from ..parallel.mesh import process_index
from ..utils import AverageMeter, StepTimer
from . import checkpoint as ckpt
from .state import TrainState
from .step import to_device
from .supervisor import StopRequested, chaos_kill_point


def _log_line(checkpoint_dir: str, text: str) -> None:
    """Append-only epoch log (reference: train_distributed.py:304-310)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "log"), "a") as f:
        f.write(text)


def _model_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _data_ranks(mesh, where: str) -> int:
    """How many ranks split the batch under ``mesh`` (1 without one): a
    rank's batch is that fraction of the global batch."""
    if mesh is None:
        return 1
    from ..parallel.mesh import axis_sizes, check_mesh

    check_mesh(mesh, where)
    return axis_sizes(mesh)["data"]


def _read_window(pending) -> List[tuple]:
    """Read back one window's (device loss, batch size, device grad norm
    or None) triples in ONE device→host copy: the losses and the grad
    norms are stacked into one tensor.  Returns (loss, batch size, grad
    norm or None) with Python floats."""
    if not pending:
        return []
    scalars = [v for v, _, _ in pending]
    scalars += [g for _, _, g in pending if g is not None]
    # float64 holds every float32 value exactly, so each read equals
    # float() of its own scalar
    vals = torch.stack([torch.as_tensor(s).detach().reshape(()).double()
                        for s in scalars]).tolist()
    n = len(pending)
    gns = iter(vals[n:])
    return [(vals[i], bs, next(gns) if g is not None else None)
            for i, (_, bs, g) in enumerate(pending)]


def _window_health(vals):
    """Summarize one window for the sentinel: the first non-finite loss
    (else the last), the first non-finite grad norm (else the window
    max) — a single check per window, worst case wins."""
    w_losses = [v for v, _, _ in vals]
    loss_h = next((v for v in w_losses if not math.isfinite(v)),
                  w_losses[-1])
    gns = [g for _, _, g in vals if g is not None]
    if not gns:
        return loss_h, None
    return loss_h, next((g for g in gns if not math.isfinite(g)), max(gns))


def train_epoch(state: TrainState, train_step: Callable,
                batches: Iterable, config: Config, epoch: int,
                mesh=None, print_freq: Optional[int] = None,
                log_fn: Callable[[str], None] = print,
                telemetry=None,
                should_stop: Optional[Callable[[], bool]] = None
                ) -> Tuple[TrainState, float]:
    """Run one epoch over ``batches`` (host (images, mask_miss, labels)
    arrays, or (images, mask_miss, joints, mask_all) for a step built with
    ``device_gt=True``); returns (state, mean loss over samples).

    ``should_stop`` is the supervisor's stop predicate
    (``train.supervisor.RunSupervisor.should_stop``), checked at each
    readback window, where the device has just synced: True raises
    :class:`train.supervisor.StopRequested`, which unwinds through
    ``fit``'s flush of the in-flight checkpoint; the partial epoch is
    dropped and a resume restarts it from the last committed checkpoint.

    ``telemetry`` (an ``obs.RunTelemetry``) turns each print window into
    a structured ``train_step`` event — loss, step time, imgs/s, and the
    data-wait vs compute split (its ``StepPhases`` wrapped around
    ``batches``) — and marks the compile watch warm after the first
    window's readback.  Each window also records a ``step_window`` trace
    span, samples the device-memory gauges into the stream and feeds the
    run-health sentinel: a step built with ``make_train_step(
    health=True)`` returns (state, loss, grad_norm), and the grad norm is
    read back HERE, stacked with the window's losses — under the
    ``halt`` policy a divergent window raises
    :class:`obs.DivergenceError`.  Any other exception out of the loop
    emits the memory forensics (largest live tensors by shape/dtype)
    into the event stream before it propagates.

    Under ``mesh`` every rank runs the epoch on its host shard of the
    batches with a step built for that mesh
    (``make_train_step(mesh=, rules=)``), whose loss is the global
    batch's; the mean and the imgs/s count the global batch (the rank's
    rows times the ``'data'`` ranks).  Only rank 0 logs."""
    data_ranks = _data_ranks(mesh, "train_epoch")
    is_lead = process_index() == 0
    print_freq = print_freq or config.train.print_freq
    dev = _model_device(state)
    losses = AverageMeter()
    timer = StepTimer()
    # (device loss, batch size, device grad-norm-or-None) triples not read
    # back yet: the weight is recorded now, so a trailing partial batch is
    # averaged at its own
    pending = []

    phases = telemetry.phases("train") if telemetry is not None else None
    if phases is not None:
        batches = phases.attribute(batches)
    trace = telemetry.trace if telemetry is not None else None
    if telemetry is not None:
        g_loss = telemetry.registry.gauge(
            "train_loss", "windowed loss readback (losses.val)")
        g_ips = telemetry.registry.gauge(
            "train_imgs_per_sec", "window throughput")
        h_step = telemetry.registry.histogram(
            "train_step_seconds", "per-step wall time (window mean)")
        window_t0 = phases.totals()
        windows = 0
        w_trace_t0 = trace.now() if trace.enabled else 0.0
    global_batch = None

    def close_window(vals, n_steps, step_no, dt, partial=False):
        """Everything one readback window owes the telemetry bundle —
        warm mark, split diff, gauges, trace span, stream record, health
        check, memory sample — one implementation for the in-loop and
        trailing-partial sites."""
        nonlocal window_t0, windows, w_trace_t0
        # the readback that produced `vals` waited for the device: every
        # steady-state lane shape has run from here on
        telemetry.mark_warm("epoch-end readback" if partial
                            else "first train window readback")
        wait, hold = phases.totals()
        d_wait = wait - window_t0[0]
        d_hold = hold - window_t0[1]
        window_t0 = (wait, hold)
        imgs_s = global_batch / max(dt, 1e-9)
        g_loss.set(losses.val)
        g_ips.set(imgs_s)
        h_step.observe(dt)
        if trace.enabled:
            # own track: a window closes mid-hold, so on the consumer's
            # track it would partially overlap the boundary batch's
            # compute span
            t_now = trace.now()
            span_args = {"epoch": epoch, "step": step_no,
                         "loss": round(losses.val, 6)}
            if partial:
                span_args["partial"] = n_steps
            trace.add_span_rel("step_window", w_trace_t0,
                               t_now - w_trace_t0, track="train-windows",
                               args=span_args)
            w_trace_t0 = t_now
        windows += 1
        # a trailing partial window always emits (an epoch shorter than
        # print_freq would otherwise emit nothing); full windows honor
        # the step_sample thinning
        if partial or windows % telemetry.step_sample == 0:
            fields = dict(
                epoch=epoch, step=step_no,
                loss=round(losses.val, 6), loss_avg=round(losses.avg, 6),
                step_s=round(dt, 6), imgs_per_sec=round(imgs_s, 2),
                data_wait_s=round(d_wait, 6), compute_s=round(d_hold, 6))
            if partial:
                fields["partial_window"] = n_steps
            telemetry.emit("train_step", **fields)
        loss_h, gn_h = _window_health(vals)
        # may raise DivergenceError (on_divergence=halt)
        telemetry.health.check(loss_h, gn_h, step=step_no, epoch=epoch)
        telemetry.memory.sample(emit=True, epoch=epoch, step=step_no)

    step_idx = -1
    try:
        for step_idx, batch in enumerate(batches):
            global_batch = batch[0].shape[0] * data_ranks
            out = train_step(state, *to_device(batch, dev))
            if len(out) == 3:  # health-instrumented step
                state, loss, gnorm = out
            else:
                (state, loss), gnorm = out, None
            pending.append((loss, global_batch, gnorm))
            if (step_idx + 1) % print_freq == 0:
                # one device sync per print_freq steps
                vals = _read_window(pending)
                pending.clear()
                for v, bs, _ in vals:
                    losses.update(v, bs)
                dt = timer.mark(print_freq)
                if telemetry is not None:
                    # may raise DivergenceError (on_divergence=halt)
                    close_window(vals, print_freq, step_idx + 1, dt)
                if is_lead:
                    log_fn(f"==> Epoch [{epoch}][{step_idx + 1}] "
                           f"loss {losses.val:.6f} ({losses.avg:.6f}) "
                           f"imgs/s {global_batch / max(dt, 1e-9):.1f}")
                chaos_kill_point("window")
                if should_stop is not None and should_stop():
                    raise StopRequested(
                        f"stop requested at epoch {epoch} step "
                        f"{step_idx + 1} (window boundary)")
        n_tail = len(pending)
        tail_vals = _read_window(pending)
        pending.clear()
        for v, bs, _ in tail_vals:
            losses.update(v, bs)
        if telemetry is not None and n_tail:
            # trailing partial window (an epoch shorter than print_freq
            # would otherwise emit nothing, and never mark the watch warm)
            close_window(tail_vals, n_tail, step_idx + 1,
                         timer.mark(n_tail), partial=True)
    except Exception as e:
        if telemetry is not None and not isinstance(
                e, (DivergenceError, StopRequested)):
            # the step loop died: name the resident device tensors before
            # unwinding (an OOM post-mortem's first question); a sentinel
            # halt carries its own diagnosis.  A failing emit must not
            # replace the original exception
            try:
                msg = str(e)
                telemetry.memory.emit_forensics(
                    reason=f"{type(e).__name__}: {msg[:300]}", epoch=epoch,
                    oom="out of memory" in msg.lower())
            except Exception:  # noqa: BLE001 — diagnostics only
                pass
        raise
    return state, losses.avg


def eval_epoch(state: TrainState, eval_step: Callable, batches: Iterable,
               mesh=None, readback_freq: int = 32) -> float:
    """Eval pass; returns the sample-weighted mean loss.  The per-batch
    losses stay on the device and are read back every ``readback_freq``
    batches.  Under ``mesh`` every rank must call it (its step reduces
    the loss over the ranks) with its host shard of the batches."""
    data_ranks = _data_ranks(mesh, "eval_epoch")
    dev = _model_device(state)
    losses = AverageMeter()
    pending = []
    for batch in batches:
        chaos_kill_point("mid_eval")
        pending.append((eval_step(state, *to_device(batch, dev)),
                        batch[0].shape[0] * data_ranks))
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
    retention knobs and closes it on exit.

    ``should_stop`` (the supervisor's predicate) is checked at each
    window readback (:func:`train_epoch`) and at each epoch boundary but
    the last: there the epoch's save has begun, and the unwind flushes it
    before :class:`train.supervisor.StopRequested` leaves ``fit``, so the
    stop loses no completed epoch.

    ``telemetry`` (an ``obs.RunTelemetry``) reaches every epoch's
    :func:`train_epoch` and gets an ``epoch`` event at each boundary (the
    train loss, the val loss when eval ran, ``saved`` when the epoch
    saved); the manager fit builds reports its checkpoint metrics to
    the bundle's registry.

    Under ``mesh`` every rank runs ``fit`` with the same arguments: the
    save and eval decisions key on epoch numbers, so the collective
    entries (the gather of a partitioned state before a save, each eval
    step's loss reduction) stay aligned.  Only rank 0 writes
    the log, the checkpoints and prints; a manager fit builds stamps the
    mesh's topology into each commit marker."""
    _data_ranks(mesh, "fit")
    is_lead = process_index() == 0
    checkpoint_dir = checkpoint_dir or config.train.checkpoint_dir
    tr = config.train
    owns_manager = checkpoint_manager is None
    manager = checkpoint_manager
    if manager is None:
        from ..parallel.mesh import mesh_topology

        manager = ckpt.CheckpointManager.from_config(
            checkpoint_dir, tr,
            registry=telemetry.registry if telemetry is not None else None,
            topology=mesh_topology(mesh, device=_model_device(state)))
    save_freq = max(1, int(tr.save_freq or 1))
    eval_freq = max(1, int(tr.eval_freq or 1))
    has_eval = eval_step is not None and make_eval_batches is not None
    last_epoch = start_epoch + epochs - 1
    try:
        for epoch in range(start_epoch, start_epoch + epochs):
            state, train_loss = train_epoch(
                state, train_step, make_batches(epoch), config, epoch,
                mesh=mesh, log_fn=log_fn, telemetry=telemetry,
                should_stop=should_stop)
            if is_lead:
                _log_line(checkpoint_dir,
                          f"\nEpoch {epoch}\ttrain_loss: {train_loss}")
            do_save = epoch % save_freq == 0 or epoch == last_epoch
            do_eval = has_eval and (epoch % eval_freq == 0
                                    or epoch == last_epoch)
            if do_save:
                # only the snapshot blocks; the write overlaps the eval
                # below and the next epoch's steps
                manager.save(state, epoch, train_loss, best_loss)
                chaos_kill_point("post_save")
            val_loss = None
            if do_eval:
                with get_tracer().span("eval_epoch", track="eval",
                                       args={"epoch": epoch}):
                    val_loss = eval_epoch(state, eval_step,
                                          make_eval_batches(epoch),
                                          mesh=mesh)
                if is_lead:
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
            if telemetry is not None:
                fields = {"epoch": epoch, "train_loss": round(train_loss, 6)}
                if val_loss is not None:
                    fields["val_loss"] = round(val_loss, 6)
                if do_save:
                    fields["saved"] = True
                telemetry.emit("epoch", **fields)
            if should_stop is not None and should_stop() \
                    and epoch != last_epoch:
                raise StopRequested(
                    f"stop requested at epoch {epoch} boundary")
    except BaseException:
        # a sentinel halt (obs.DivergenceError) or any crash must still flush the in-flight write (the run that died
        # is the one whose last checkpoint matters), without letting a
        # writer failure mask the original exception
        try:
            manager.close() if owns_manager else manager.wait()
        except Exception:  # noqa: BLE001 — the original exception wins
            pass
        raise
    manager.close() if owns_manager else manager.wait()
    return state
