"""Fold a run's span trace into a ``.perfetto.json`` + critical-path text
(counterpart of the JAX package's ``tools/trace_report.py``)::

    python -m improved_body_parts_torch.cli.trace_report trace.json
    python -m improved_body_parts_torch.cli.trace_report trace.json \\
        --json summary.json

Input is the Chrome ``trace_event`` JSON that ``obs.trace.TraceRecorder``
exports (``TraceRecorder.save``; ``cli.fleet_audit --keep-workdir`` leaves
one beside its workers' shards).  This tool:

- validates the events structurally (every record needs name/ph/ts/
  pid/tid; complete spans need a non-negative ``dur``) and refuses a
  file with no valid events — a truncated or hand-damaged trace should
  fail loudly here, not render as an empty mystery in the UI;
- auto-discovers per-worker trace shards next to the input
  (``<trace>.pN`` — what ``ProcessRouter(trace_path=...)`` hands each
  worker process) and STITCHES them into the parent timeline: every
  shard's events are rebased onto the parent's clock axis via the
  ``t0_mono`` anchor both exports carry (CLOCK_MONOTONIC is
  system-wide on Linux, so the shift is exact, not estimated), the
  shard's process is renamed ``serve worker N``, and the router's
  ``cat="proc"`` flow ids line up with the workers' — one request
  renders as ONE arc: router submit → worker serve → router deliver.
  A shard with no ``t0_mono`` anchor cannot be placed and is skipped
  loudly;
- writes a normalized ``<input>.perfetto.json`` (events sorted
  parent-before-child) that loads directly at https://ui.perfetto.dev
  or ``chrome://tracing``;
- prints a text critical-path summary: per-span-name aggregates (count,
  total/mean/max); the step-window account (data-wait vs compute totals
  and the >=40%-wait input-bound verdict, ``obs.registry.
  INPUT_BOUND_FRAC``); serve requests (count, latency spread from the
  async begin/end pairs, mean batch occupancy from the ``execute``
  spans); the cross-process flow arcs.

A host-side reader of JSON files: it touches no device and takes no
``--device``.  It keeps its own copy of the JAX tool's functions
(``_load_events``, ``discover_shards``, ``stitch_shards``,
``summarize``, ``render_text``), which give the JAX tool's output on the
same files.
"""
from __future__ import annotations

import argparse
import glob
import json
import statistics
import sys

from ..obs.events import strict_dump
# ONE threshold for every reporting tool: the fraction of the attributed
# split spent waiting on data above which the run is input-bound
from ..obs.registry import INPUT_BOUND_FRAC

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def _load_events(path):
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        other = data.get("otherData", {})
    else:
        events, other = data, {}
    if not isinstance(events, list):
        raise SystemExit(f"{path}: no traceEvents array — not a Chrome "
                         "trace_event file")
    valid, invalid = [], 0
    for ev in events:
        if not isinstance(ev, dict):
            invalid += 1
            continue
        if ev.get("ph") == "M":  # metadata: no timestamp by spec
            if "name" not in ev or "pid" not in ev:
                invalid += 1
                continue
        elif any(k not in ev for k in _REQUIRED) or (
                ev["ph"] == "X" and ev.get("dur", -1) < 0):
            invalid += 1
            continue
        valid.append(ev)
    if not valid:
        raise SystemExit(f"{path}: 0 structurally valid trace events "
                         f"({invalid} invalid) — refusing to report")
    return valid, invalid, other


def discover_shards(path):
    """Per-worker trace shards next to ``path``: ``<path>.p1``,
    ``<path>.p2``, ... (the ``ProcessRouter`` → worker ``trace_path``
    naming).  Globbed, not probed consecutively: a SIGKILLed worker
    never flushes its shard, and that hole must not hide the survivors'
    shards.  Returns existing paths sorted by worker number."""
    out = []
    for p in glob.glob(glob.escape(path) + ".p*"):
        suffix = p[len(path) + 2:]
        if suffix.isdigit():
            out.append((int(suffix), p))
    return [p for _, p in sorted(out)]


def stitch_shards(parent_other, shard_paths):
    """Load worker trace shards and rebase them onto the parent's
    timeline axis.

    Both exports carry ``otherData.t0_mono`` — the absolute
    CLOCK_MONOTONIC anchor their relative timestamps count from.  The
    clock is system-wide, so ``(t0_shard - t0_parent)`` microseconds is
    the EXACT shift that places a worker span among the router's spans
    (no correlation or estimation step).  Returns ``(events, infos)``:
    the rebased shard events (metadata process names rewritten to
    ``serve worker N``) and one info dict per shard for the summary.
    """
    t0_parent = parent_other.get("t0_mono")
    events, infos = [], []
    for path in shard_paths:
        # worker number from the .pN suffix (worker_idx + 1)
        n = int(path.rsplit(".p", 1)[1])
        try:
            sh_events, sh_invalid, sh_other = _load_events(path)
        except SystemExit as e:
            print(f"warning: skipping trace shard {path}: {e}",
                  file=sys.stderr)
            continue
        t0_shard = sh_other.get("t0_mono")
        if t0_parent is None or t0_shard is None:
            print(f"warning: skipping trace shard {path}: no t0_mono "
                  "anchor on "
                  + ("both exports" if t0_parent is None else "the shard")
                  + " — cannot place it on the parent's axis",
                  file=sys.stderr)
            continue
        shift_us = (float(t0_shard) - float(t0_parent)) * 1e6
        for ev in sh_events:
            ev = dict(ev)
            if ev["ph"] == "M":
                if ev["name"] == "process_name":
                    ev["args"] = {"name": f"serve worker {n - 1}"}
            else:
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            events.append(ev)
        infos.append({"path": path, "worker": n - 1,
                      "events": len(sh_events),
                      "invalid": sh_invalid,
                      "shift_ms": round(shift_us / 1e3, 3),
                      "dropped_events": int(
                          sh_other.get("dropped_events", 0))})
    return events, infos


def _verdict(wait_frac):
    """The three-way reading of the data-wait / compute split, including
    the mixed band (the JAX package's ``tools/telemetry_report.py``
    reads the same split the same way)."""
    if wait_frac >= INPUT_BOUND_FRAC:
        return "input-bound"
    if wait_frac >= INPUT_BOUND_FRAC / 2:
        return "mixed (input pressure)"
    return "compute-bound"


def _track_names(events):
    return {ev.get("tid"): ev.get("args", {}).get("name", str(ev.get("tid")))
            for ev in events
            if ev["ph"] == "M" and ev["name"] == "thread_name"
            and "tid" in ev}


def summarize(events, other):
    spans = [e for e in events if e["ph"] == "X"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["dur"] / 1e3)  # ms
    names = {
        name: {"count": len(ds), "total_ms": round(sum(ds), 3),
               "mean_ms": round(statistics.fmean(ds), 3),
               "max_ms": round(max(ds), 3)}
        for name, ds in sorted(by_name.items(),
                               key=lambda kv: -sum(kv[1]))}

    windows = by_name.get("step_window", [])
    wait = sum(by_name.get("data_wait", []))
    hold = sum(by_name.get("compute", []))
    split = wait + hold
    verdict = None
    if split > 0:
        verdict = _verdict(wait / split)

    # serve lifecycle: latency from async begin/end pairs keyed by id,
    # occupancy from the execute spans' batch args
    opened, lat_ms = {}, []
    for e in events:
        if e.get("cat") == "serve" and e["name"] == "request":
            if e["ph"] == "b":
                opened[e.get("id")] = e["ts"]
            elif e["ph"] == "e" and e.get("id") in opened:
                lat_ms.append((e["ts"] - opened.pop(e["id"])) / 1e3)
    # cross-process flow arcs (router submit → worker serve → router
    # deliver): a stitched fleet timeline shows starts ≈ steps ≈
    # finishes; steps at 0 with starts present means the worker shards
    # were NOT stitched (or workers ran with telemetry off)
    flows = {"s": 0, "t": 0, "f": 0}
    for e in events:
        if e.get("cat") == "proc" and e["ph"] in flows:
            flows[e["ph"]] += 1
    proc_flows = ({"starts": flows["s"], "steps": flows["t"],
                   "finishes": flows["f"]}
                  if any(flows.values()) else None)

    batches = [e.get("args", {}).get("batch") for e in spans
               if e["name"] == "execute"]
    batches = [b for b in batches if b]
    serve = None
    if lat_ms or batches:
        serve = {
            "requests": len(lat_ms) + len(opened),
            "unfinished": len(opened),
            "latency_ms": ({"mean": round(statistics.fmean(lat_ms), 3),
                            "max": round(max(lat_ms), 3)}
                           if lat_ms else None),
            "execute_batches": len(batches),
            "mean_batch_occupancy": (round(statistics.fmean(batches), 3)
                                     if batches else None),
        }

    return {
        "events": len(events),
        "spans": len(spans),
        "dropped_events": int(other.get("dropped_events", 0)),
        # a lossy ring means every aggregate below UNDERCOUNTS — the
        # same signal rides the registry as trace_spans_dropped_total
        # so a live scrape sees it too (obs.trace.attach_registry)
        "lossy": bool(int(other.get("dropped_events", 0))),
        "tracks": sorted(_track_names(events).values()),
        "by_name": names,
        "step_windows": {
            "count": len(windows),
            "total_ms": round(sum(windows), 3),
            "data_wait_ms": round(wait, 3),
            "compute_ms": round(hold, 3),
            "data_wait_frac": (round(wait / split, 4) if split else None),
        },
        "verdict": verdict,
        "serve": serve,
        "proc_flows": proc_flows,
    }


def render_text(summary):
    lines = [f"trace: {summary['spans']} spans / {summary['events']} "
             f"events on {len(summary['tracks'])} tracks"]
    if summary["lossy"]:
        lines.append(
            f"WARNING: LOSSY TRACE — the ring dropped "
            f"{summary['dropped_events']} events past capacity; every "
            f"total below undercounts.  Raise TraceRecorder(capacity=) "
            f"(and watch trace_spans_dropped_total on /metrics).")
    sw = summary["step_windows"]
    if sw["count"]:
        lines.append(
            f"step windows: {sw['count']}  data_wait "
            f"{sw['data_wait_ms']:.1f} ms  compute "
            f"{sw['compute_ms']:.1f} ms  wait_frac "
            f"{sw['data_wait_frac']:.0%}" if sw["data_wait_frac"]
            is not None else f"step windows: {sw['count']}")
    if summary["verdict"]:
        lines.append(f"verdict: {summary['verdict']}")
    if summary["serve"]:
        sv = summary["serve"]
        lines.append(
            f"serve: {sv['requests']} requests over "
            f"{sv['execute_batches']} batches"
            + (f", mean occupancy {sv['mean_batch_occupancy']}"
               if sv["mean_batch_occupancy"] else "")
            + (f", latency mean {sv['latency_ms']['mean']:.1f} ms "
               f"max {sv['latency_ms']['max']:.1f} ms"
               if sv["latency_ms"] else ""))
    if summary.get("shards"):
        lines.append(
            "stitched worker shards: "
            + ", ".join(f"worker {s['worker']} ({s['events']} ev, "
                        f"shift {s['shift_ms']:+.1f} ms)"
                        for s in summary["shards"]))
    if summary.get("proc_flows"):
        pf = summary["proc_flows"]
        lines.append(
            f"cross-process flow arcs: {pf['starts']} submits → "
            f"{pf['steps']} worker serves → {pf['finishes']} delivers")
    lines.append("critical path (total span time, desc):")
    for name, st in list(summary["by_name"].items())[:10]:
        lines.append(f"  {name:<14} {st['total_ms']:>10.1f} ms  "
                     f"x{st['count']}  mean {st['mean_ms']:.2f}  "
                     f"max {st['max_ms']:.2f}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    """Run the report; returns the summary (with ``shards`` and
    ``perfetto``, as the ``--json`` file holds it)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace JSON written by "
                    "TraceRecorder.save (a run's or a router's export)")
    ap.add_argument("--out", default=None,
                    help="normalized Perfetto output path (default: "
                         "<trace>.perfetto.json)")
    ap.add_argument("--json", default=None,
                    help="also write the summary dict to this path")
    ap.add_argument("--no-shards", action="store_true",
                    help="do not auto-discover/stitch <trace>.pN worker "
                         "shards")
    args = ap.parse_args(argv)

    events, invalid, other = _load_events(args.trace)
    if invalid:
        print(f"warning: dropped {invalid} structurally invalid events",
              file=sys.stderr)
    shard_infos = []
    if not args.no_shards:
        shard_events, shard_infos = stitch_shards(
            other, discover_shards(args.trace))
        events = events + shard_events
        if shard_infos:
            # the lossy flag must see the WHOLE stitched timeline
            other = dict(other)
            other["dropped_events"] = (
                int(other.get("dropped_events", 0))
                + sum(s["dropped_events"] for s in shard_infos))
    # parent-before-child: ts ascending, longer span first on ties
    body = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    meta = [e for e in events if e["ph"] == "M"]
    # suffix-strip only a TRAILING .json: multi-process traces are named
    # trace.json.pN, and rsplit would collapse every process's default
    # output onto the lead process's file
    stem = args.trace[:-5] if args.trace.endswith(".json") else args.trace
    out_path = args.out or stem + ".perfetto.json"
    with open(out_path, "w") as f:
        strict_dump({"traceEvents": meta + body, "displayTimeUnit": "ms",
                     "otherData": other}, f)

    summary = summarize(events, other)
    summary["shards"] = shard_infos
    summary["perfetto"] = out_path
    if args.json:
        with open(args.json, "w") as f:
            strict_dump(summary, f, indent=2)
    print(render_text(summary))
    print(f"perfetto export: {out_path} (open at https://ui.perfetto.dev)")
    return summary


if __name__ == "__main__":
    main()
