"""Reconstruct per-request causal trees and verify causal completeness
(counterpart of the JAX package's ``tools/request_report.py``)::

    python -m improved_body_parts_torch.cli.request_report \\
        serve_bench_torch_events.jsonl --top 10
    python -m improved_body_parts_torch.cli.request_report records.json \\
        --strict

Input is a JSONL event stream containing ``request`` records (what
``obs.reqtrace.ReqTrace`` emits through the run's event sink — the
benches' ``*_events.jsonl`` files, or the stream a serving process
writes), or a JSON file with a top-level ``"records"`` list.  For each
request the record carries the whole causal tree: one node per
component that handled it (batcher, pool, policy, cascade, stream,
process worker), the edge kind that created each node (submit / retry /
hedge / failover / escalate / migrate) with its reason annotation, and
each node's hop waterfall.

The tool answers the two questions the raw records exist for:

- **Where did the slow requests' budgets go?**  ``--top N`` renders the
  N slowest requests as indented trees with their per-hop waterfalls.
- **Is the tracing itself trustworthy?**  Causal completeness is
  verified over EVERY record: exactly one delivering leaf per request
  (the ``won_by`` chain from the root must exist, terminate, and end at
  a leaf — or at the interior node itself only when a client-side
  deadline resolved it), zero orphan nodes (every ``parent`` resolves
  inside the tree), zero duplicate node ids, zero duplicate request
  ids, and chain-hop conservation (the delivering chain's hop sum
  covers ``--min-coverage`` of the end-to-end span).  ``--strict`` exits
  nonzero on any violation.

A host-side reader of JSON files: it touches no device and takes no
``--device``.  It keeps its own copy of the JAX tool's functions
(``discover_shards``, ``load_records``, ``verify``, ``render_tree``,
``slowest``), which give the JAX tool's verdicts on the same records.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys

from ..obs.events import read_events, strict_dump

#: chain-hop conservation floor: the delivering chain's hop sum must
#: cover this fraction of the request's end-to-end span
MIN_COVERAGE = 0.95


def discover_shards(path):
    """Per-worker sink shards ``<path>.pN`` next to a primary stream
    (worker processes write their own shard so streams never
    interleave).  Globbed rather than probed consecutively from
    ``.p1`` — a crashed worker can leave a numbering hole that must
    not hide the surviving workers' shards."""
    shards = []
    for p in glob.glob(glob.escape(path) + ".p*"):
        suffix = p[len(path) + 2:]
        if suffix.isdigit():
            shards.append((int(suffix), p))
    return [p for _, p in sorted(shards)]


def load_records(path, shards=True):
    """``request`` records from a JSONL event stream or a JSON file
    with a top-level ``records`` list.

    For JSONL streams, per-worker sink shards (``<path>.pN``) are
    auto-discovered and their request records concatenated — unlike
    timing summaries, a request record carries its whole causal tree
    and durations in ms, so merging across processes is sound.  A shard
    whose ``run_start`` carries a ``run_id`` other than the primary
    stream's is a stale leftover from an earlier run: skipped loudly."""
    if path.endswith(".jsonl"):
        events = read_events(path)
        run_id = next((e.get("run_id") for e in reversed(events)
                       if e.get("event") == "run_start"), None)
        records = [e for e in events if e.get("event") == "request"]
        for sp in (discover_shards(path) if shards else []):
            sev = read_events(sp)
            srid = next((e.get("run_id") for e in reversed(sev)
                         if e.get("event") == "run_start"), None)
            if srid != run_id:
                print(f"{sp}: shard run_id {srid!r} does not match the "
                      f"primary stream's {run_id!r}; skipping stale "
                      "shard", file=sys.stderr)
                continue
            records.extend(e for e in sev
                           if e.get("event") == "request")
        return records
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        recs = data.get("records")
        if recs is None:
            raise SystemExit(
                f"{path}: no 'records' list — pass a JSONL event "
                "stream or a JSON file with a records list")
        return recs
    return data


def verify(records, min_coverage=MIN_COVERAGE):
    """Causal-completeness verdict over every record; returns the
    summary dict (``violations`` lists each failing request with the
    rule it broke)."""
    seen_req = set()
    out = {
        "requests": len(records),
        "duplicate_requests": 0,
        "duplicate_nodes": 0,
        "orphan_nodes": 0,
        "delivering_leaf_violations": 0,
        "coverage_violations": 0,
        "edge_kinds": {},
        "violations": [],
    }
    coverages = []
    for rec in records:
        req = rec.get("req")
        problems = []
        if req in seen_req:
            out["duplicate_requests"] += 1
            problems.append("duplicate request id")
        seen_req.add(req)
        nodes = rec.get("nodes", [])
        by_id = {}
        for n in nodes:
            if n.get("node") in by_id:
                out["duplicate_nodes"] += 1
                problems.append(f"duplicate node id {n.get('node')}")
            by_id[n.get("node")] = n
            kind = n.get("kind", "?")
            out["edge_kinds"][kind] = out["edge_kinds"].get(kind, 0) + 1
        roots = [n for n in nodes if n.get("parent") is None]
        for n in nodes:
            if n.get("parent") is not None and \
                    n["parent"] not in by_id:
                out["orphan_nodes"] += 1
                problems.append(
                    f"orphan node {n.get('node')} (parent "
                    f"{n['parent']} missing)")
        # the delivering chain: follow won_by from the root
        children = {}
        for n in nodes:
            if n.get("parent") is not None:
                children.setdefault(n["parent"], []).append(n)
        chain_ok = len(roots) == 1
        if chain_ok:
            cur, hops_sum, steps = roots[0], 0.0, 0
            while True:
                hops_sum += sum(cur.get("hops_ms", {}).values())
                nxt = by_id.get(cur.get("won_by"))
                if cur.get("won_by") is not None and nxt is None:
                    chain_ok = False
                    problems.append(
                        f"won_by {cur['won_by']} not in tree")
                    break
                if nxt is None:
                    # chain terminus: must be a LEAF — exactly one
                    # delivering leaf — unless a client-side deadline
                    # resolved the request at an interior node (the
                    # only layer that can legally deliver without a
                    # child outcome)
                    is_leaf = not children.get(cur.get("node"))
                    deadline = "DeadlineExceeded" in str(
                        cur.get("status", ""))
                    if not is_leaf and not deadline:
                        chain_ok = False
                        problems.append(
                            f"chain ends at interior node "
                            f"{cur.get('node')} without a deadline")
                    break
                cur = nxt
                steps += 1
                if steps > len(nodes):
                    chain_ok = False
                    problems.append("won_by cycle")
                    break
            e2e = rec.get("e2e_ms", 0.0)
            if chain_ok and e2e > 0:
                cov = hops_sum / e2e
                coverages.append(cov)
                if cov < min_coverage:
                    out["coverage_violations"] += 1
                    problems.append(
                        f"chain hops cover {cov:.1%} of e2e "
                        f"(< {min_coverage:.0%})")
        else:
            problems.append(f"{len(roots)} roots (need exactly 1)")
        if not chain_ok:
            out["delivering_leaf_violations"] += 1
        if problems:
            out["violations"].append({"req": req, "problems": problems})
    if coverages:
        coverages.sort()
        out["chain_coverage"] = {
            "mean": round(sum(coverages) / len(coverages), 4),
            "p50": round(coverages[len(coverages) // 2], 4),
            "min": round(coverages[0], 4),
        }
    out["complete"] = not out["violations"]
    return out


def render_tree(rec):
    """One request as an indented causal tree with hop waterfalls."""
    nodes = rec.get("nodes", [])
    children = {}
    roots = []
    for n in nodes:
        if n.get("parent") is None:
            roots.append(n)
        else:
            children.setdefault(n["parent"], []).append(n)
    chain = set(rec.get("chain", []))
    lines = [f"req {rec.get('req')}  e2e {rec.get('e2e_ms')} ms  "
             f"status {rec.get('status')}  chain covers "
             f"{rec.get('hop_coverage', 0):.1%}"]

    def walk(n, depth):
        extras = {k: v for k, v in n.items()
                  if k not in ("node", "parent", "comp", "kind",
                               "t0_ms", "dur_ms", "status", "won_by",
                               "hops_ms")}
        hops = "  ".join(f"{h}={v}" for h, v in
                         n.get("hops_ms", {}).items())
        star = "*" if n.get("node") in chain else " "
        extra = ("  [" + " ".join(f"{k}={v}"
                                  for k, v in extras.items()) + "]"
                 if extras else "")
        lines.append(
            f"  {'  ' * depth}{star}{n.get('comp')}/{n.get('kind')}"
            f"  {n.get('dur_ms')} ms  ({n.get('status')}){extra}"
            + (f"\n  {'  ' * depth}   hops: {hops}" if hops else ""))
        for c in sorted(children.get(n.get("node"), []),
                        key=lambda x: x.get("t0_ms", 0)):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def slowest(records, top):
    return sorted(records, key=lambda r: -r.get("e2e_ms", 0.0))[:top]


def main(argv=None) -> dict:
    """Run the report; returns the verification summary.  Exits 1 under
    ``--strict`` when a record breaks a rule."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("events", help="JSONL event stream with `request` "
                    "records, or a JSON file with a `records` list")
    ap.add_argument("--top", type=int, default=10,
                    help="render the N slowest request trees")
    ap.add_argument("--min-coverage", type=float, default=MIN_COVERAGE,
                    help="chain-hop conservation floor (fraction of "
                         "e2e the delivering chain must account for)")
    ap.add_argument("--json", default=None,
                    help="also write the verification summary + "
                         "slowest trees to this path")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any completeness violation")
    ap.add_argument("--no-shards", action="store_true",
                    help="skip auto-discovery of <events>.pN worker "
                         "sink shards")
    args = ap.parse_args(argv)

    records = load_records(args.events, shards=not args.no_shards)
    if not records:
        raise SystemExit(f"{args.events}: 0 request records — nothing "
                         "to report (was reqtrace enabled?)")
    summary = verify(records, args.min_coverage)
    slow = slowest(records, args.top)

    print(f"{summary['requests']} request records; "
          f"complete={summary['complete']} "
          f"(orphans={summary['orphan_nodes']}, "
          f"dup_nodes={summary['duplicate_nodes']}, "
          f"dup_reqs={summary['duplicate_requests']}, "
          f"leaf_violations={summary['delivering_leaf_violations']}, "
          f"coverage_violations={summary['coverage_violations']})")
    print("edge kinds: " + ", ".join(
        f"{k}={v}" for k, v in sorted(summary["edge_kinds"].items())))
    if "chain_coverage" in summary:
        cc = summary["chain_coverage"]
        print(f"chain coverage: mean {cc['mean']:.1%}  p50 "
              f"{cc['p50']:.1%}  min {cc['min']:.1%}")
    print(f"\nslowest {len(slow)} requests:")
    for rec in slow:
        print(render_tree(rec))
    for v in summary["violations"][:10]:
        print(f"VIOLATION req {v['req']}: {'; '.join(v['problems'])}",
              file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            strict_dump({"summary": summary, "slowest": slow}, f,
                        indent=2)
    if args.strict and not summary["complete"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
