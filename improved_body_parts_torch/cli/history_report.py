"""Render a run's telemetry history: load curves, trends, gap table —
with a shard completeness verifier (counterpart of the JAX package's
``tools/history_report.py``)::

    python -m improved_body_parts_torch.cli.history_report \\
        runs/events_history.jsonl
    python -m improved_body_parts_torch.cli.history_report \\
        runs/events_history.jsonl --series serve_queue_depth --window 30 \\
        --strict

Reads the ``*_history.jsonl`` (+ ``.pN``) shards an ``obs.HistoryStore``
persisted, replays them offline and renders:

- a **verifier block** first, so an incomplete or inconsistent stream
  cannot pass for a healthy one: every shard parses, headers agree
  (run_id / cadence / schema), shard numbers are contiguous, sample
  times strictly increase, every sampled key was declared, and the
  persisted ``history_gap`` records match what re-detection over the
  tick spacing finds, count for count;
- per-series **load curves** (text bars over the raw ring) and the
  window **trend** (slope/s) of the requested series (default: the
  control-plane signal set the stream carries);
- the **gap table**: every sampler blackout with its span and missed
  tick estimate.

A host-side reader of JSONL files: it touches no device and takes no
``--device``.  It keeps its own copy of the JAX tool's functions
(``verify_history``, ``render_curve``, ``summarize``, ``render``), which
give the JAX tool's verdicts and models on the same shards.
``main(argv)`` returns the verifier and the model, prints
``cli.exit_report``'s ``CLI_REPORT`` line last, and under ``--strict``
exits 1 when the verifier finds a problem.
"""
from __future__ import annotations

import argparse

import torch

from ..obs.events import read_events, strict_dumps
from ..obs.history import (
    HISTORY_SCHEMA,
    HistoryStore,
    discover_history_shards,
)
from . import exit_report

#: default series to render when none are named — the serving
#: control-plane signal set (whatever subset the stream carries)
DEFAULT_SERIES = (
    "serve_queue_depth",
    "pool_queue_depth",
    "serve_completed_total",
    "serve_hop_conservation_frac",
)

CURVE_WIDTH = 48
CURVE_ROWS = 24


def verify_history(path):
    """Structural + accounting verification of one history stream.
    Returns ``(ok, problems, stats)``."""
    problems = []
    shards = discover_history_shards(path)
    if not shards:
        return False, [f"no shards found at {path!r}"], {}
    header = None
    declared = set()
    ticks = 0
    persisted_gaps = []
    last_t = None
    redetected = 0
    for i, p in enumerate(shards):
        recs = read_events(p)
        if not recs:
            problems.append(f"{p}: empty shard")
            continue
        first = recs[0]
        if first.get("event") != "history_start":
            problems.append(f"{p}: first record is "
                            f"{first.get('event')!r}, not history_start")
        else:
            if first.get("schema", 0) > HISTORY_SCHEMA:
                problems.append(
                    f"{p}: schema {first.get('schema')} > supported "
                    f"{HISTORY_SCHEMA}")
            if first.get("shard") != i:
                problems.append(
                    f"{p}: header says shard {first.get('shard')}, "
                    f"position says {i} (missing or reordered shard)")
            if header is None:
                header = first
            else:
                for k in ("run_id", "cadence_s", "gap_factor", "levels"):
                    if first.get(k) != header.get(k):
                        problems.append(
                            f"{p}: header {k}={first.get(k)!r} != "
                            f"shard-0 {header.get(k)!r}")
        for rec in recs:
            ev = rec.get("event")
            if ev == "history_series":
                declared.add(rec.get("key"))
            elif ev == "history_gap":
                persisted_gaps.append(rec)
            elif ev == "history_sample":
                t = rec.get("t")
                if not isinstance(t, (int, float)):
                    problems.append(f"{p}: sample without numeric t")
                    continue
                if last_t is not None:
                    if t <= last_t:
                        problems.append(
                            f"{p}: non-increasing t {t} after {last_t}")
                    elif header is not None and (
                            t - last_t > header.get("gap_factor", 2.5)
                            * header.get("cadence_s", 0.25)):
                        redetected += 1
                last_t = t
                ticks += 1
                undeclared = set(rec.get("v", {})) - declared
                if undeclared:
                    problems.append(
                        f"{p}: sampled undeclared series "
                        f"{sorted(undeclared)[:3]}"
                        f"{'…' if len(undeclared) > 3 else ''}")
    if header is None:
        problems.append("no history_start header in any shard")
    if len(persisted_gaps) != redetected:
        problems.append(
            f"gap accounting break: {len(persisted_gaps)} persisted "
            f"history_gap records vs {redetected} re-detected from "
            "tick spacing")
    stats = {
        "shards": len(shards),
        "ticks": ticks,
        "series_declared": len(declared),
        "gaps_persisted": len(persisted_gaps),
        "gaps_redetected": redetected,
        "run_id": header.get("run_id") if header else None,
        "cadence_s": header.get("cadence_s") if header else None,
        "last_t": last_t,
    }
    return not problems, problems, stats


def render_curve(points, width=CURVE_WIDTH, rows=CURVE_ROWS):
    """Text load curve: the last ``rows`` of the raw points, thinned,
    as value-scaled bars."""
    if not points:
        return ["  (no samples)"]
    # thin to at most `rows` lines, newest last
    step = max(1, len(points) // rows)
    pts = points[::step][-rows:]
    vmax = max(abs(v) for _, v in pts) or 1.0
    out = []
    for t, v in pts:
        bar = "#" * max(0, int(round(abs(v) / vmax * width)))
        out.append(f"  t={t:12.3f}  {v:14.6g}  {bar}")
    return out


def summarize(path, series, window_s):
    """Replay the stream and build the render model."""
    store = HistoryStore.replay(path)
    doc = store.doc()
    present = [s for s in (series or DEFAULT_SERIES) if s in doc["keys"]]
    missing = [s for s in (series or ()) if s not in doc["keys"]]
    blocks = []
    for key in present:
        q = store.query(key)
        block = {
            "series": key,
            "kind": q["kind"],
            "points": q["points"],
            "latest": store.latest(key),
            "trend": store.trend(key, window_s),
            "quantiles": store.window_quantiles(key, window_s),
        }
        if q["kind"] == "counter":
            block["rate"] = store.rate(key, window_s)
        blocks.append(block)
    return {"doc": doc, "signals": store.signals(),
            "blocks": blocks, "missing": missing}


def render(path, model, verdict, window_s):
    ok, problems, stats = verdict
    lines = [f"history report: {path}", ""]
    lines.append(f"verifier: {'OK' if ok else 'FAIL'} — "
                 f"{stats.get('shards', 0)} shard(s), "
                 f"{stats.get('ticks', 0)} ticks, "
                 f"{stats.get('series_declared', 0)} series, "
                 f"gaps {stats.get('gaps_persisted', 0)} persisted / "
                 f"{stats.get('gaps_redetected', 0)} re-detected, "
                 f"run_id={stats.get('run_id')!r}")
    for p in problems:
        lines.append(f"  !! {p}")
    doc = model["doc"]
    lines.append("")
    lines.append(f"store: cadence {doc['cadence_s']} s, raw ring "
                 f"{doc['raw_capacity']}, levels "
                 f"{['%gs x %d' % (w, c) for w, c in doc['levels']]}, "
                 f"{doc['series']} series, {doc['samples']} samples, "
                 f"last_t {doc['last_t']}")
    sig = model["signals"]
    lines.append(f"signals @ t={sig.get('t')}: queue_depth="
                 f"{sig.get('queue_depth')} admitted="
                 f"{sig.get('admitted_depth')} conservation="
                 f"{sig.get('hop_conservation_frac')} "
                 f"completed_rate={sig.get('completed_rate')}/s")
    for m in model["missing"]:
        lines.append(f"  (requested series {m!r} not in stream)")
    for b in model["blocks"]:
        lines.append("")
        head = f"-- {b['series']} ({b['kind']})"
        if b.get("rate") is not None:
            head += f"  rate[{window_s:g}s]={b['rate']:.6g}/s"
        if b.get("trend") is not None:
            head += f"  trend[{window_s:g}s]={b['trend']:.6g}/s"
        lines.append(head)
        if b.get("quantiles"):
            q = b["quantiles"]
            lines.append("   window quantiles: "
                         + "  ".join(f"{k}={v:.6g}"
                                     for k, v in q.items()))
        lines.extend(render_curve(b["points"]))
    gaps = doc["gaps"]
    lines.append("")
    lines.append(f"gaps: {gaps['count']} "
                 "(sampler blackouts — marked, never interpolated)")
    for g in gaps["recent"]:
        lines.append(f"  {g['t_prev']:.3f} -> {g['t']:.3f}  "
                     f"(~{g['missed']} missed ticks)")
    return "\n".join(lines)


def main(argv=None) -> dict:
    """Print the report of one history stream; returns ``{"verifier":
    {ok, problems, **stats}, **model}``.  Exits 1 under ``--strict`` when
    the verifier finds a problem."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="history stream path "
                                 "(*_history.jsonl; .pN auto-discovered)")
    ap.add_argument("--series", nargs="+", default=None,
                    help="series keys to render "
                         f"(default: {', '.join(DEFAULT_SERIES)})")
    ap.add_argument("--window", type=float, default=30.0,
                    help="window seconds for rate/trend/quantiles")
    ap.add_argument("--json", action="store_true",
                    help="emit the model as strict JSON, not text")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when the verifier finds problems")
    args = ap.parse_args(argv)

    verdict = verify_history(args.path)
    ok, problems, stats = verdict
    if ok or stats.get("ticks"):
        model = summarize(args.path, args.series, args.window)
    else:
        model = {"doc": {}, "signals": {}, "blocks": [], "missing": []}
    out = {"verifier": {"ok": ok, "problems": problems, **stats}, **model}
    if args.json:
        print(strict_dumps(out, indent=2, sort_keys=True, default=str))
    elif model["doc"]:
        print(render(args.path, model, verdict, args.window))
    else:
        print(f"history report: {args.path}")
        print("verifier: FAIL")
        for p in problems:
            print(f"  !! {p}")
    # a host-side reader: its CLI_REPORT names the CPU it ran on
    exit_report("history_report", torch.device("cpu"), ok=ok,
                problems=len(problems), ticks=stats.get("ticks", 0))
    if args.strict and not ok:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
