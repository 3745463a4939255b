"""Fold a run's JSONL telemetry stream into a human-readable summary
(counterpart of the JAX package's ``tools/telemetry_report.py``)::

    python -m improved_body_parts_torch.cli.telemetry_report \\
        checkpoints/events.jsonl
    python -m improved_body_parts_torch.cli.telemetry_report events.jsonl \\
        --json report.json

Reads the event stream an ``obs.EventSink`` writes (``cli.train
--telemetry-sink``, ``cli.serve_bench``, ``cli.chaos_serve``, an
``obs.RunTelemetry`` bundle) and reports:

- step time (mean / p50 / p95 / max) and imgs/s over the run;
- the **bottleneck verdict**: the data-wait vs device-compute split the
  trainer accumulates around each step — *input-bound* means the card
  starved waiting for batches (more ring workers; ``cli.feed_rate``
  sizes them), *compute-bound* means the input pipeline kept up and the
  step itself is the frontier;
- the first-run timeline: every ``recompile`` event after warmup.  In
  the port that event is a predictor's first run of a lane shape its
  warmup did not cover (``obs.recompile``: the kernels' build, cuDNN's
  algorithm choice, the allocator's first blocks), each one a stall on
  the serving path;
- epoch losses, ``timed`` span records, and serve snapshots when
  present;
- per-worker sink shards (``<events>.pN``, written by serve worker
  processes), discovered next to the primary stream and summarized
  SEPARATELY under ``worker_shards``; a shard whose ``run_start``
  carries another ``run_id`` than the primary stream's is a stale
  leftover of an earlier run and is skipped loudly;
- the run's telemetry history (``<events-stem>_history.jsonl`` + ``.pN``,
  written by ``obs.HistoryStore``), discovered the same way with the
  same loud stale-``run_id`` skip, and pointed at ``cli.history_report``
  for rendering (``--no-shards`` disables both discoveries).

A host-side reader of JSONL files: it touches no device and takes no
``--device``.  It keeps its own copy of the JAX tool's functions
(``_pct``, ``discover_shards``, ``summarize_shard``,
``summarize_history``, ``summarize``, ``render``); the summary's keys
are the JAX tool's, and its values equal the JAX tool's on the same
stream.  ``main(argv)`` returns the summary and prints
``cli.exit_report``'s ``CLI_REPORT`` line last.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from ..obs.events import read_events, strict_dump
# ONE threshold for every reporting tool: above this fraction of the
# attributed wall time spent waiting on data the run is input-bound;
# below half of it, compute-bound; between, mixed
from ..obs.registry import INPUT_BOUND_FRAC
from . import exit_report


def _pct(xs, q):
    """Exact percentile of a full sample list (a PercentileMeter at
    >= len capacity evicts nothing, so its estimate is exact — one
    quantile implementation shared with the /metrics endpoint)."""
    from ..utils.meters import PercentileMeter

    m = PercentileMeter(capacity=max(len(xs), 1))
    for v in xs:
        m.update(v)
    return m.percentile(q)


def discover_shards(path):
    """Per-worker sink shards ``<path>.pN`` next to a primary stream.
    Globbed rather than probed from ``.p1`` on: a crashed worker can
    leave a numbering hole that must not hide the surviving workers'
    shards."""
    shards = []
    for p in glob.glob(glob.escape(path) + ".p*"):
        suffix = p[len(path) + 2:]
        if suffix.isdigit():
            shards.append((int(suffix), p))
    return [p for _, p in sorted(shards)]


def summarize_shard(path, primary_run_id):
    """Small per-shard summary.  Shards are summarized SEPARATELY, never
    concatenated into the primary stream: a worker's monotonic ``t``
    axis starts at ITS sink open, not the parent's.  Returns ``None`` —
    after a loud stderr note — when the shard's ``run_start`` carries a
    ``run_id`` other than the primary stream's (a stale shard of an
    earlier run)."""
    events = read_events(path)
    header = next((e for e in reversed(events)
                   if e.get("event") == "run_start"), {})
    if header.get("run_id") != primary_run_id:
        print(f"{path}: shard run_id {header.get('run_id')!r} does not "
              f"match the primary stream's {primary_run_id!r}; skipping "
              "stale shard", file=sys.stderr)
        return None
    stop = next((e for e in reversed(events)
                 if e.get("event") == "worker_stop"), None)
    return {
        "path": os.path.basename(path),
        "worker": header.get("worker"),
        "pid": header.get("pid"),
        "role": header.get("role"),
        "events": len(events),
        "served": (stop or {}).get("served"),
        "clean_stop": stop is not None,
    }


def summarize_history(events_path, primary_run_id):
    """Small summary of the telemetry history an ``obs.HistoryStore``
    persisted next to this run's events (``<events-stem>_history.jsonl``
    + ``.pN``).  ``None`` when there is none, or — after a loud stderr
    note — when its header's ``run_id`` is not the primary stream's (a
    header without a run_id is kept: a store wired outside
    ``RunTelemetry`` stamps none)."""
    from ..obs.history import discover_history_shards, history_path_for

    hist_path = history_path_for(events_path)
    shards = discover_history_shards(hist_path)
    if not shards:
        return None
    header = next((e for e in read_events(shards[0])
                   if e.get("event") == "history_start"), {})
    hist_run = header.get("run_id")
    if (hist_run is not None and primary_run_id is not None
            and hist_run != primary_run_id):
        print(f"{hist_path}: history run_id {hist_run!r} does not match "
              f"the primary stream's {primary_run_id!r}; skipping stale "
              "history shards", file=sys.stderr)
        return None
    ticks = gaps = 0
    last_t = None
    for p in shards:
        for e in read_events(p):
            ev = e.get("event")
            if ev == "history_sample":
                ticks += 1
                last_t = e.get("t", last_t)
            elif ev == "history_gap":
                gaps += 1
    # every shard re-declares its series; count the last shard's
    series = sum(1 for e in read_events(shards[-1])
                 if e.get("event") == "history_series")
    return {
        "path": os.path.basename(hist_path),
        "shards": len(shards),
        "run_id": hist_run,
        "cadence_s": header.get("cadence_s"),
        "ticks": ticks,
        "series": series,
        "gaps": gaps,
        "last_t": last_t,
    }


def summarize(events):
    """Machine-readable summary dict of one parsed event stream.

    The sink appends, so a re-run over the same path stacks runs in one
    file:

    - plain runs: the summary covers the LAST run (everything from the
      final ``run_start`` on) and records how many earlier runs were
      skipped;
    - **elastic runs** (``cli.train --supervised``): every ``run_start``
      with the last one's ``run_id`` is a SEGMENT of one logical run;
      the segments are stitched together (step stats, attribution and
      epochs over all of them) and a per-segment table is added.
    """
    from ..obs.events import SCHEMA_VERSION

    starts = [i for i, e in enumerate(events)
              if e.get("event") == "run_start"]
    # split into (header, slice) runs; one headerless run for a legacy
    # stream with no run_start at all
    bounds = starts + [len(events)]
    runs = ([(events[starts[i]], events[starts[i]:bounds[i + 1]])
             for i in range(len(starts))]
            if starts else [({}, events)])
    run_id = runs[-1][0].get("run_id")
    if run_id:
        group = [(h, ev) for h, ev in runs if h.get("run_id") == run_id]
    else:
        group = [runs[-1]]
    previous_runs = len(runs) - len(group)
    header = group[-1][0]
    events = [e for _, ev in group for e in ev]
    schema = max((h.get("schema", 0) for h, _ in group), default=0)
    if schema > SCHEMA_VERSION:
        raise SystemExit(
            f"event stream schema {schema} is newer than this tool's "
            f"{SCHEMA_VERSION}; refusing to misread it — update the repo")

    segments = None
    if run_id:
        segments = []
        for h, ev in group:
            seg_start = next((e for e in ev
                              if e.get("event") == "segment_start"), None)
            seg_end = next((e for e in reversed(ev)
                            if e.get("event") == "segment_end"), None)
            resume = next((e for e in ev
                           if e.get("event") == "resume"), None)
            epochs_in = [e.get("epoch") for e in ev
                         if e.get("event") == "epoch"]
            segments.append({
                "segment": h.get("segment"),
                "time_unix": h.get("time_unix"),
                "previous_end": (seg_start or {}).get("previous_end"),
                "backoff_s": (seg_start or {}).get("backoff_s"),
                "resumed_from": (resume or {}).get("epoch"),
                "resume_eval_loss": next(
                    (e.get("loss") for e in ev
                     if e.get("event") == "resume_eval"), None),
                "windows": sum(1 for e in ev
                               if e.get("event") == "train_step"),
                "epochs": len(epochs_in),
                "epoch_range": ([epochs_in[0], epochs_in[-1]]
                                if epochs_in else None),
                "end": ((seg_end or {}).get("status")
                        or "died (no segment_end)"),
            })

    steps = [e for e in events if e.get("event") == "train_step"]
    epochs = [e for e in events if e.get("event") == "epoch"]
    recompiles = [e for e in events if e.get("event") == "recompile"]
    warm = next((e for e in events
                 if e.get("event") == "warmup_complete"), None)
    timed = [e for e in events if e.get("event") == "timed"]
    serve = [e for e in events if e.get("event", "").startswith("serve")]

    step_s = [e["step_s"] for e in steps if "step_s" in e]
    imgs_s = [e["imgs_per_sec"] for e in steps if "imgs_per_sec" in e]
    wait = sum(e.get("data_wait_s", 0.0) for e in steps)
    hold = sum(e.get("compute_s", 0.0) for e in steps)
    attributed = wait + hold
    wait_frac = wait / attributed if attributed else 0.0

    if not attributed:
        verdict = "unknown (no attributed step records)"
    elif wait_frac >= INPUT_BOUND_FRAC:
        verdict = "input-bound"
    elif wait_frac >= INPUT_BOUND_FRAC / 2:
        verdict = "mixed (input pressure)"
    else:
        verdict = "compute-bound"

    return {
        "run": {k: header.get(k) for k in
                ("schema", "time_unix", "pid", "tool", "config")
                if k in header or k == "schema"},
        "previous_runs_in_file": previous_runs,
        "run_id": run_id,
        "segments": segments,
        "windows": len(steps),
        "step_seconds": {
            "mean": sum(step_s) / len(step_s) if step_s else 0.0,
            "p50": _pct(step_s, 50), "p95": _pct(step_s, 95),
            "max": max(step_s) if step_s else 0.0,
        },
        "imgs_per_sec": {
            "mean": sum(imgs_s) / len(imgs_s) if imgs_s else 0.0,
            "last": imgs_s[-1] if imgs_s else 0.0,
        },
        "attribution": {
            "data_wait_s": round(wait, 6),
            "compute_s": round(hold, 6),
            "data_wait_frac": round(wait_frac, 4),
            "compute_frac": round(1.0 - wait_frac, 4) if attributed else 0.0,
        },
        "verdict": verdict,
        "warmup_complete_t": warm.get("t") if warm else None,
        "recompiles_post_warmup": len(recompiles),
        "recompile_timeline": [
            {"t": e.get("t"), "duration_s": e.get("duration_s"),
             "source": e.get("source")} for e in recompiles],
        "epochs": [{"epoch": e.get("epoch"),
                    "train_loss": e.get("train_loss"),
                    **({"val_loss": e["val_loss"]} if "val_loss" in e
                       else {})} for e in epochs],
        "timed_spans": len(timed),
        "serve_events": len(serve),
    }


def render(summary):
    """Human-readable report text."""
    s = summary
    lines = []
    run = s["run"]
    lines.append("== telemetry report ==")
    lines.append(f"run: tool={run.get('tool', '?')} "
                 f"config={run.get('config', '?')} pid={run.get('pid')}")
    if s.get("previous_runs_in_file"):
        lines.append(f"(file holds {s['previous_runs_in_file']} earlier "
                     "run(s); reporting the last)")
    segs = s.get("segments")
    if segs and len(segs) > 1:
        lines.append(f"elastic run {s.get('run_id')}: {len(segs)} "
                     "segments stitched (stats below aggregate all of "
                     "them)")
        lines.append("  seg  prev-end       resumed  windows  epochs"
                     "   resume-eval  end")
        for g in segs:
            er = g.get("epoch_range")
            er_txt = f"{er[0]}-{er[1]}" if er else "-"
            rev = g.get("resume_eval_loss")
            rev_txt = f"{rev:.4f}" if rev is not None else "-"
            rf = g.get("resumed_from")
            lines.append(
                f"  {g.get('segment', '?'):>3}  "
                f"{str(g.get('previous_end', '?')):<13}  "
                f"{str(rf) if rf is not None else '-':>7}  "
                f"{g.get('windows', 0):>7}  {er_txt:>6}  "
                f"{rev_txt:>11}  {g.get('end', '?')}")
    st = s["step_seconds"]
    lines.append(
        f"steps: {s['windows']} windows | step "
        f"{st['mean'] * 1e3:.1f} ms mean / {st['p50'] * 1e3:.1f} p50 / "
        f"{st['p95'] * 1e3:.1f} p95 / {st['max'] * 1e3:.1f} max | "
        f"{s['imgs_per_sec']['mean']:.1f} imgs/s mean")
    a = s["attribution"]
    lines.append(
        f"attribution: data-wait {a['data_wait_s']:.2f} s "
        f"({a['data_wait_frac'] * 100:.1f}%) vs compute "
        f"{a['compute_s']:.2f} s ({a['compute_frac'] * 100:.1f}%)")
    lines.append(f"verdict: {s['verdict']}")
    if s["verdict"] == "input-bound":
        lines.append("  -> the device starved on input; add ring workers "
                     "(cli.feed_rate sizes them)")
    elif s["verdict"].startswith("compute"):
        lines.append("  -> input kept up; the step itself is the "
                     "frontier (cli.train_bench / cli.perf_audit)")
    n_rc = s["recompiles_post_warmup"]
    if s["warmup_complete_t"] is None:
        lines.append("first runs: warmup never marked (short/aborted run)")
    elif n_rc == 0:
        lines.append("first runs after warmup: 0 (steady state held)")
    else:
        lines.append(f"first runs after warmup: {n_rc} — each a lane "
                     "shape the warmup missed, a stall on the path:")
        for e in s["recompile_timeline"][:20]:
            lines.append(f"  t={e['t']:.2f}s  {e['duration_s']:.3f}s "
                         f"({e['source']})")
        if n_rc > 20:
            lines.append(f"  ... {n_rc - 20} more")
    if s["epochs"]:
        last = s["epochs"][-1]
        lines.append(f"epochs: {len(s['epochs'])} | last train_loss "
                     f"{last.get('train_loss')}"
                     + (f" val_loss {last['val_loss']}"
                        if "val_loss" in last else ""))
    if s.get("worker_shards"):
        lines.append(f"worker sink shards: {len(s['worker_shards'])}")
        for g in s["worker_shards"]:
            served = g.get("served")
            lines.append(
                f"  worker {g.get('worker')} (pid {g.get('pid')}): "
                f"{g['events']} events, served "
                f"{served if served is not None else '?'}, "
                + ("clean stop" if g["clean_stop"]
                   else "no worker_stop (crashed?)"))
    h = s.get("history")
    if h:
        lines.append(
            f"telemetry history: {h['path']} — {h['shards']} shard(s), "
            f"{h['ticks']} ticks @ {h['cadence_s']}s, {h['series']} "
            f"series, {h['gaps']} gap(s) (cli.history_report renders it)")
    return "\n".join(lines)


def main(argv=None) -> dict:
    """Print the report of one stream; returns the summary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("events", help="JSONL event stream "
                                   "(obs.EventSink output)")
    ap.add_argument("--json", default=None,
                    help="also write the machine-readable summary here")
    ap.add_argument("--no-shards", action="store_true",
                    help="skip auto-discovery of <events>.pN worker "
                         "sink shards and the <events-stem>_history"
                         ".jsonl telemetry history")
    args = ap.parse_args(argv)

    events = read_events(args.events)
    if not events:
        raise SystemExit(f"no events parsed from {args.events}")
    summary = summarize(events)
    shard_paths = [] if args.no_shards else discover_shards(args.events)
    if shard_paths:
        shards = [summarize_shard(p, summary.get("run_id"))
                  for p in shard_paths]
        summary["worker_shards"] = [s for s in shards if s is not None]
    if not args.no_shards:
        hist = summarize_history(args.events, summary.get("run_id"))
        if hist is not None:
            summary["history"] = hist
    print(render(summary))
    if args.json:
        with open(args.json, "w") as f:
            strict_dump(summary, f, indent=2)
        print(f"\nwrote {args.json}")
    # a host-side reader: its CLI_REPORT names the CPU it ran on
    exit_report("telemetry_report", torch.device("cpu"),
                windows=summary["windows"], verdict=summary["verdict"],
                recompiles_post_warmup=summary["recompiles_post_warmup"])
    return summary


if __name__ == "__main__":
    main()
