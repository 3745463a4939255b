"""Fault injection against supervised training (counterpart of
``tools/chaos_train.py``)::

    python -m improved_body_parts_torch.cli.chaos_train --kills 8
    python -m improved_body_parts_torch.cli.chaos_train --config canonical \\
        --kills 2 --seed 35 --records 8 --epochs 4 --workers 0 --strict

Runs a real multi-epoch ``python -m improved_body_parts_torch.cli.train
--supervised`` on a drawn fixture corpus (``data.fixture``'s records in
``.npz`` files, so no h5py is needed) and kills it again and again: a
SIGKILL at a deterministic point inside the process (``window``: after a
step window's readback; ``post_save``: while the async checkpoint write
is in flight; ``mid_ckpt_write``: on the writer thread between the
payload and the commit marker; ``mid_eval``), through the
``IBP_CHAOS_KILL`` seam of ``train.supervisor.chaos_kill_point``; an
external SIGTERM mid-epoch (the clean preemption drain); or a SIGKILL of
every shm-ring worker (the supervised ring must rebuild, then the
segment is killed).  After every death it relaunches the same command
line, as a preempting scheduler does, until the run's ledger says the
epoch target was reached.  The kinds come in a seed-randomised order and
each in-process kill fires at a seeded hit count inside the first half
of what the segment still has to run.  Steps an epoch are the records
over the config's batch.  Asserted end to end:

- every resume lands on the last checkpoint committed before the kill
  (read post mortem from the directory, against the next segment's
  ``resume`` event; a segment that trains without one while a commit
  exists is a mismatch).  ``resumes_from_commit`` counts the segments
  that resumed from a commit: a run whose kills all land before the
  first commit checks no resume at all;
- no process leaks: every descendant of a killed child (ring workers
  too: their orphan watchdog must fire) is gone within a grace window,
  and so is, after the last child, every process that carries this
  run's token in its environment (``RUN_TOKEN_ENV``, inherited by each
  child and its workers); no segment's ``segment_end`` lists a
  surviving ``ckpt-writer`` thread;
- the final state matches an uninterrupted control run of the same seed
  and epochs: bit for bit where the device reproduces, else the final
  train / val losses within ``--loss-tol``; a control run that fails
  fails the run.  The control run is a process of its own that runs
  beside the chaos segments (on the same device), read after the last
  segment.

Writes ``chaos_train_torch.json`` (``--out``; the JAX tool's
``CHAOS*.json`` are refused) with the card's name and power limit.
``--strict`` exits 1 when an assertion fails.  The children run on
``--device`` (``cuda`` unless asked for ``cpu``) and load the kernels the
checkout has built (``ops._build``), so no segment rebuilds them.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("CHAOS*.json",)

#: names this run's processes: every child inherits it
RUN_TOKEN_ENV = "IBP_CHAOS_RUN"

KINDS = ("window", "post_save", "mid_ckpt_write", "mid_eval", "sigterm",
         "ring_worker")
#: kinds that fire inside the child, at the n-th hit of their point
IN_PROCESS = ("window", "post_save", "mid_ckpt_write", "mid_eval")


# ------------------------------------------------------------ processes
def proc_table():
    """pid -> ppid of every live process (Linux ``/proc``)."""
    table = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                # the command name may hold spaces: fields follow its ')'
                fields = f.read().rsplit(")", 1)[1].split()
            table[int(name)] = int(fields[1])
        except (OSError, IndexError, ValueError):
            continue
    return table


def descendants(pid):
    """Every live descendant pid of ``pid`` (ring workers, trackers)."""
    children = {}
    for p, pp in proc_table().items():
        children.setdefault(pp, []).append(p)
    out, frontier = [], [pid]
    while frontier:
        nxt = []
        for p in frontier:
            for c in children.get(p, []):
                out.append(c)
                nxt.append(c)
        frontier = nxt
    return out


def cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def ring_worker_pids(child_pid):
    """The train process's spawned children that are ring workers (not
    the resource tracker)."""
    return [p for p in descendants(child_pid)
            if "spawn_main" in cmdline(p)
            and "resource_tracker" not in cmdline(p)]


def processes_with_env(name, value):
    """Live pids whose environment (as they were started) holds
    ``name=value``; processes of other users, and those gone while read,
    are skipped."""
    needle = f"{name}={value}".encode()
    out = []
    for pid in proc_table():
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if needle in f.read().split(b"\0"):
                    out.append(pid)
        except OSError:
            continue
    return out


def wait_gone(pids, timeout_s=20.0):
    """Wait for ``pids`` to exit; returns the survivors (leaks)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not [p for p in pids if os.path.exists(f"/proc/{p}")]:
            return []
        time.sleep(0.25)
    return [p for p in pids if os.path.exists(f"/proc/{p}")]


# --------------------------------------------------------------- events
def read_events(path):
    """Every JSON line of the event stream at ``path`` (a torn last line
    is skipped; a missing file is no events)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
    except OSError:
        pass
    return out


def wait_for_event(path, pred, child, timeout_s=240.0, start=0):
    """Poll the stream until an event after index ``start`` satisfies
    ``pred``, or the child exits, or the timeout passes; returns it or
    None.  ``start`` keeps an earlier segment's events (the sink appends
    across segments) from answering this segment's wait."""
    deadline = time.monotonic() + timeout_s
    seen = start
    while time.monotonic() < deadline:
        events = read_events(path)
        for e in events[seen:]:
            if pred(e):
                return e
        seen = max(seen, len(events))
        if child.poll() is not None:
            # the event may have landed as the child exited
            for e in read_events(path)[seen:]:
                if pred(e):
                    return e
            return None
        time.sleep(0.1)
    return None


def resume_matches(committed_before: int, seg_events) -> bool:
    """Did a segment resume from the epoch committed before it?  Its
    ``resume`` event names that epoch, or found nothing where nothing was
    committed; a segment that trained with no ``resume`` event past a
    commit does not match (one killed before it resumed does)."""
    resume = next((e for e in seg_events if e.get("event") == "resume"),
                  None)
    if resume is None:
        return committed_before < 0 or not any(
            e.get("event") == "train_step" for e in seg_events)
    if committed_before >= 0:
        return resume.get("epoch") == committed_before
    return resume.get("found") is False


def run_ok(completed: bool, resume_mismatches, leaked, writer_leak: bool,
           control_requested: bool, final_ok) -> bool:
    """The run's verdict: completed, every resume on the last commit, no
    leaked process or writer thread, and, where a control run was asked
    for, the final state matched it (a control that failed or timed out
    leaves nothing to match, so the run fails)."""
    return bool(completed and not resume_mismatches and not leaked
                and not writer_leak
                and (final_ok is True or not control_requested))


# ----------------------------------------------------------------- plan
def steps_per_epoch(config_name: str, records: int) -> int:
    """Train steps an epoch of ``records`` at the config's batch."""
    from ..config import get_config

    batch = get_config(config_name).train.batch_size_per_device
    return max(records // max(batch, 1), 1)


def injection_plan(rng: random.Random, kills: int) -> list:
    """The injection kinds in order: every kind in turn when ``kills``
    covers them all, else seeded draws; then shuffled."""
    plan = [KINDS[i % len(KINDS)] if kills >= len(KINDS)
            else rng.choice(KINDS) for i in range(kills)]
    rng.shuffle(plan)
    return plan


def pick_hit(rng: random.Random, kind: str, committed: int, epochs: int,
             spe: int) -> int:
    """The seeded n-th hit an in-process kill fires at, inside the first
    half of what the segment still runs (it resumes at ``committed + 1``
    and runs to ``epochs``): early enough that every armed kill fires
    before the target, late enough that later kills land after commits
    and exercise resume from epoch N."""
    remaining = max(epochs - (committed + 1), 1)
    half = max(remaining // 2, 1)
    if kind == "window":
        return rng.randint(1, spe * half)
    # post_save / mid_ckpt_write / mid_eval fire once an epoch
    return rng.randint(1, half)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--epochs", type=int, default=6,
                    help="total epoch target of the supervised run")
    ap.add_argument("--records", type=int, default=6,
                    help="fixture corpus size (steps an epoch = records / "
                         "the config's batch)")
    ap.add_argument("--val-records", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1,
                    help="shm-ring workers in every child (>= 1 gives the "
                         "ring-worker kill a target)")
    ap.add_argument("--kills", type=int, default=8,
                    help="fault injections before the run may finish")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the injection plan and of both arms' "
                         "training")
    ap.add_argument("--print-freq", type=int, default=1)
    ap.add_argument("--no-control", action="store_true",
                    help="skip the uninterrupted control run and the final "
                         "comparison")
    ap.add_argument("--segment-timeout", type=int, default=420,
                    help="hard wall bound of each child")
    ap.add_argument("--loss-tol", type=float, default=0.02,
                    help="relative final-loss tolerance against the control "
                         "run where the states are not bit-identical")
    ap.add_argument("--out", default="chaos_train_torch.json")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any assertion fails")
    ap.add_argument("--device", default="cuda",
                    help="device of the train children: 'cuda' (default) "
                         "or 'cpu'")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from .. import resolve_device
    from ..data.fixture import fixture_records, save_records
    from ..obs.events import strict_dump, strict_dumps
    from ..train.checkpoint import (
        latest_checkpoint,
        read_commit_meta,
        restore_checkpoint,
    )
    from . import card_stamp, refuse_artifact
    from .ckpt_bench import same_payload

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    rng = random.Random(args.seed)
    work = tempfile.mkdtemp(prefix="chaos_train_")
    token = os.path.basename(work)
    train_corpus = os.path.join(work, "train.npz")
    val_corpus = os.path.join(work, "val.npz")
    save_records(train_corpus, fixture_records(
        num_images=args.records, people_per_image=1, seed=args.seed + 3))
    save_records(val_corpus, fixture_records(
        num_images=args.val_records, people_per_image=1, seed=args.seed + 7))

    def child_env(extra=None):
        env = dict(os.environ)
        env.pop("IBP_CHAOS_KILL", None)
        env[RUN_TOKEN_ENV] = token
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        env.update(extra or {})
        return env

    def child_argv(ckpt_dir, supervised=True):
        out = [sys.executable, "-m", "improved_body_parts_torch.cli.train",
               "--config", args.config, "--epochs", str(args.epochs),
               "--train-h5", train_corpus, "--val-h5", val_corpus,
               "--checkpoint-dir", ckpt_dir, "--workers", str(args.workers),
               "--print-freq", str(args.print_freq), "--seed",
               str(args.seed), "--telemetry-sink", "auto",
               "--device", device.type]
        if supervised:
            out += ["--supervised", "--backoff-base", "0.1",
                    "--backoff-max", "2"]
        return out

    # ---- the control run (same seed and epochs, no faults) runs beside
    # the chaos segments: a process of its own, read after the last one
    control = {"skipped": True}
    control_dir = os.path.join(work, "control")
    control_proc = None
    if not args.no_control:
        control_t0 = time.monotonic()
        control_err = open(os.path.join(work, "control.stderr"), "w+")
        control_proc = subprocess.Popen(
            child_argv(control_dir, supervised=False), env=child_env(),
            stdout=subprocess.DEVNULL, stderr=control_err, text=True)

    # ---- the chaos run: inject, die, relaunch, until completed
    chaos_dir = os.path.join(work, "chaos")

    def committed_epoch():
        path = latest_checkpoint(chaos_dir)
        if path is None:
            return -1
        meta = read_commit_meta(path)
        return meta["epoch"] if meta else -1

    spe = steps_per_epoch(args.config, args.records)
    plan = injection_plan(rng, args.kills)
    events_path = os.path.join(chaos_dir, "events.jsonl")
    segments, leaked_total, resume_mismatches = [], [], []
    injected, completed = 0, False
    for seg_idx in range(args.kills + 6):  # every injection + headroom
        kind = plan[injected] if injected < len(plan) else "none"
        committed_before = committed_epoch()
        hit = (pick_hit(rng, kind, committed_before, args.epochs, spe)
               if kind in IN_PROCESS else (1 if kind != "none" else 0))
        env_extra = ({"IBP_CHAOS_KILL": f"{kind}:{hit}"}
                     if hit and kind in IN_PROCESS else {})
        events_before = len(read_events(events_path))
        t0 = time.monotonic()
        child = subprocess.Popen(
            child_argv(chaos_dir), env=child_env(env_extra),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        descendants_seen = []
        try:
            # the process tree as soon as this segment trains, before any
            # injected death, so the leak check covers its ring workers
            wait_for_event(events_path,
                           lambda e: e.get("event") == "train_step", child,
                           timeout_s=args.segment_timeout,
                           start=events_before)
            descendants_seen = (descendants(child.pid)
                                if child.poll() is None else [])
            if kind == "sigterm" and child.poll() is None:
                child.send_signal(signal.SIGTERM)  # the clean drain
            elif kind == "ring_worker" and child.poll() is None:
                # every ring worker (train and eval rings): the supervised
                # train ring must rebuild mid-epoch, then the segment is
                # killed so the sweep goes on
                for pid in ring_worker_pids(child.pid):
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
                wait_for_event(events_path,
                               lambda e: e.get("event") == "ring_rebuild",
                               child, timeout_s=120, start=events_before)
                if child.poll() is None:
                    os.kill(child.pid, signal.SIGKILL)
            child.wait(timeout=args.segment_timeout)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=30)
        wall = time.monotonic() - t0
        stderr = child.stderr.read() if child.stderr else ""
        committed_after = committed_epoch()
        leaked = wait_gone(descendants_seen)
        leaked_total += leaked

        seg_events = read_events(events_path)[events_before:]
        resume = next((e for e in seg_events
                       if e.get("event") == "resume"), None)
        resume_ok = resume_matches(committed_before, seg_events)
        if not resume_ok:
            resume_mismatches.append({"segment": seg_idx,
                                      "expected": committed_before,
                                      "resume_event": resume})
        seg_end = next((e for e in reversed(seg_events)
                        if e.get("event") == "segment_end"), None)
        record = {
            "segment": seg_idx,
            "injection": ({"kind": kind, "hit": hit}
                          if kind != "none" else None),
            "returncode": child.returncode,
            "wall_s": round(wall, 1),
            "committed_before": committed_before,
            "committed_after": committed_after,
            "resumed_from": (resume or {}).get("epoch"),
            "resume_ok": resume_ok,
            "leaked_pids": leaked,
            "ring_rebuilds": sum(1 for e in seg_events
                                 if e.get("event") == "ring_rebuild"),
            "end_status": (seg_end or {}).get("status"),
            "live_threads_at_end": (seg_end or {}).get("live_threads"),
        }
        if child.returncode not in (0, -signal.SIGKILL) and stderr:
            record["stderr_tail"] = stderr[-1200:]
        segments.append(record)
        finished = bool(seg_end and seg_end.get("status") == "completed")
        if kind != "none" and not (finished and child.returncode == 0):
            # an injection counts only when it took the segment down (a
            # run that completes under an armed trigger is a miss)
            injected += 1
        if finished:
            completed = True
            break
        if child.returncode == 0 and kind == "none" and not seg_end:
            break  # a clean exit without a ledger close

    if control_proc is not None:
        try:
            control_proc.wait(timeout=max(
                1.0, control_t0 + args.segment_timeout * 3
                - time.monotonic()))
        except subprocess.TimeoutExpired:
            control_proc.kill()
            control_proc.wait(timeout=30)
        control = {"returncode": control_proc.returncode,
                   "wall_s": round(time.monotonic() - control_t0, 1)}
        if control_proc.returncode != 0:
            control_err.seek(0)
            control["stderr_tail"] = control_err.read()[-1500:]
        control_err.close()

    # ---- verdicts
    final_ok = bit_identical = loss_match = loss_rel_diff = None
    if completed and not args.no_control \
            and control.get("returncode") == 0:
        a, b = latest_checkpoint(control_dir), latest_checkpoint(chaos_dir)
        bit_identical = same_payload(restore_checkpoint(a),
                                     restore_checkpoint(b))
        ma, mb = read_commit_meta(a) or {}, read_commit_meta(b) or {}
        diffs = []
        # metric_value compares only where both markers keyed the same
        # metric (a chaos arm killed between its last save and eval keeps
        # train_loss where the control's was amended to val_loss)
        keys = ["train_loss"]
        if ma.get("metric") == mb.get("metric"):
            keys.append("metric_value")
        for key in keys:
            ca, cb = ma.get(key), mb.get(key)
            if isinstance(ca, (int, float)) and isinstance(cb, (int, float)):
                diffs.append(abs(ca - cb) / max(abs(ca), 1e-12))
        loss_rel_diff = max(diffs) if diffs else None
        loss_match = (loss_rel_diff is not None
                      and loss_rel_diff <= args.loss_tol)
        final_ok = bool(bit_identical or loss_match)

    # the backstop: every child has exited, so a process that still
    # carries this run's token is a leak (the per-segment snapshot misses
    # a worker the kill beat); ring workers get their watchdog's grace
    stragglers = wait_gone(processes_with_env(RUN_TOKEN_ENV, token),
                           timeout_s=20.0 if args.workers > 0 else 5.0)
    leaked_total += [p for p in stragglers if p not in leaked_total]
    writer_leak = any(
        any("ckpt-writer" in t for t in (s.get("live_threads_at_end")
                                         or []))
        for s in segments)
    report = {
        "protocol": (
            "supervised cli.train fit on a drawn fixture corpus; "
            f"{injected} injections (deterministic SIGKILL points, "
            "external SIGTERM, ring-worker kill) in seed-randomised order; "
            "relaunch until completed; each resume checked against the "
            "post-mortem committed epoch; descendants tracked for leaks; "
            "the final state compared with an uninterrupted control run"),
        "config": args.config, "epochs": args.epochs,
        "records": args.records, "workers": args.workers,
        "steps_per_epoch": spe, "seed": args.seed,
        "platform": device.type, **card_stamp(device),
        "injections_planned": len(plan),
        "injections_done": injected,
        "injection_kinds": sorted(set(plan)),
        "segments": segments,
        "segments_total": len(segments),
        "completed": completed,
        "resume_mismatches": resume_mismatches,
        "all_resumes_on_last_committed": not resume_mismatches,
        "resumes_from_commit": sum(
            1 for s in segments if s["committed_before"] >= 0
            and s["resumed_from"] == s["committed_before"]),
        "leaked_pids_total": len(leaked_total),
        "writer_thread_leaked": writer_leak,
        "control": control,
        "final_bit_identical": bit_identical,
        "final_loss_rel_diff": loss_rel_diff,
        "loss_tol": args.loss_tol,
        "final_loss_match": loss_match,
        "final_matches_control": final_ok,
        "host_note": f"cpu_count={os.cpu_count()}, device={device.type}",
        "workdir": work,
    }
    ok = run_ok(completed, resume_mismatches, leaked_total, writer_leak,
                not args.no_control, final_ok)
    report["ok"] = ok
    with open(args.out, "w") as f:
        strict_dump(report, f, indent=2)
    print(strict_dumps({k: report[k] for k in (
        "ok", "completed", "injections_done", "segments_total",
        "all_resumes_on_last_committed", "resumes_from_commit",
        "leaked_pids_total",
        "writer_thread_leaked", "final_bit_identical",
        "final_loss_rel_diff", "final_matches_control")}))
    if args.strict and not ok:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
