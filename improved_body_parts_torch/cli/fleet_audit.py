"""Fleet observability audit (counterpart of the JAX package's
``tools/fleet_audit.py``)::

    python -m improved_body_parts_torch.cli.fleet_audit --rounds 6
    python -m improved_body_parts_torch.cli.fleet_audit --quick
    python -m improved_body_parts_torch.cli.fleet_audit \\
        --predictor constant --rounds 1 --requests 4 --clients 2

Proves the fleet observability plane (worker-process telemetry over the
shm wire, merged ``/metrics`` + ``/fleet``, cross-process trace
stitching, crash flight recorder) against five gates on a LIVE 2-worker
``ProcessRouter``:

1. **Overhead** — interleaved obs-ON/obs-OFF A/B, paired per-round
   overhead, median < ``OVERHEAD_GATE_PCT``%.  The OFF arm installs the
   null sink, null tracer and ``telemetry=False`` workers EXPLICITLY
   (the A/A hazard: an arm that merely *forgot* to configure telemetry
   measures nothing).
2. **Conservation** — at ON-arm quiescence, router-view submitted vs
   Σ worker-view served + in-flight ≥ ``MIN_COVERAGE``.
3. **Compiles** — per-arm compile-delta accounting: the parent's
   ``CompileWatch`` delta + every worker's own first-run counters
   (telemetry block on the ON arm, heartbeat float on the OFF arm) must
   show 0 post-warmup first runs.
4. **Scrape** — one live ``MetricsServer`` over the merged registry:
   ``/metrics`` must expose the ``REQUIRED_FAMILIES`` under ``worker=``
   labels, ``/fleet`` the per-worker document + conservation block,
   ``/healthz`` the fleet extra, ``/slo`` the tracker state.
5. **Chaos** — one SIGKILL mid-batch: the exhumed flight recorder's
   ``worker_postmortem`` must pass ``obs.fleet.verify_postmortem`` (it
   names the killed batch's slot/seq and last completed hop).

Plus the trace-stitch proof: the ON arm's parent export + per-worker
``.pN`` shards stitch (``cli.trace_report``) into one timeline whose
``cat="proc"`` flow arcs thread router submit → worker serve → router
deliver.

The workers' predictor:

- ``--predictor model`` (default): each worker builds
  ``serve.artifacts:checkpoint_predictor`` from a JSON spec (``--config``,
  ``--checkpoint`` or the seeded init of ``--seed``, ``--params-dtype``,
  boxsize ``--size``, ``--device``) and serves ``--size``² images; it
  runs on ``--device cuda`` unless asked for ``cpu``, and raises without
  a card.  The report then carries, for each worker generation that
  stopped, its kernel launches and requests served after warmup (from
  the ``worker_warm`` / ``worker_stop`` events of its sink shard).
- ``--predictor constant``: the JAX tool's protocol — the host-only
  ``serve.worker:constant_predictor`` with a ``DELAY_S`` hold, 48×48
  images in a 64×64 wire.

The chaos round's router is the JAX tool's under either predictor (the
constant predictor holding each request ``CHAOS_DELAY_S``): the
postmortem it gates is exhumed from the flight ring, whatever the
predictor.

The three routers' workers start together (ON, OFF and the chaos
round's); the A/B's rounds keep the JAX tool's order.  Writes
``fleet_obs_torch.json`` (``--out``; the JAX tool's ``FLEET_OBS.json`` is
refused before any work), prints ``cli.exit_report``'s ``CLI_REPORT``
line last, and exits 1 exactly when the report's ``ok`` is false.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import statistics
import tempfile
import threading
import time
from typing import Callable, Optional

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("FLEET_OBS.json",)
#: paired-median throughput overhead the ON arm may cost, percent
OVERHEAD_GATE_PCT = 2.0
#: minimum (served + in-flight) / submitted coverage at quiescence
MIN_COVERAGE = 0.95

CONSTANT_SPEC = "improved_body_parts_torch.serve.worker:constant_predictor"
MODEL_SPEC = "improved_body_parts_torch.serve.artifacts:checkpoint_predictor"
#: per-request simulated device time of the constant predictor — large
#: enough that the plane's per-request cost (~tens of µs) lands well
#: under the gate, small enough that a round stays sub-second
DELAY_S = 0.003
#: the constant predictor's hold in the chaos round: the kill lands on a
#: request in flight
CHAOS_DELAY_S = 0.2

#: /metrics families that must appear with a worker= label on the ON
#: arm: hop latency, occupancy, first runs, device memory, served, up
REQUIRED_FAMILIES = (
    "fleet_worker_hop_latency_seconds",
    "fleet_worker_batch_occupancy_mean",
    "fleet_worker_xla_compiles_total",
    "fleet_worker_device_bytes_in_use",
    "fleet_worker_served_total",
    "fleet_worker_up",
)
DECODE_KERNELS = ("topk_peaks", "limb_pair_stats", "greedy_assemble")
#: the model predictor's wire: 17 COCO keypoints (the process wire's
#: default of 18 adds a None to every person), the lane's person table
MODEL_PARTS, MODEL_PEOPLE = 17, 32


def router_kwargs(args, *, chaos: bool = False) -> dict:
    """The ``ProcessRouter`` arguments of one router of the audit:
    spec, workers, wire and lifecycle (the JAX tool's for the constant
    predictor, the same lifecycle around ``checkpoint_predictor`` for
    the model).  The chaos round's router is the JAX tool's under either
    predictor: the postmortem it gates is read from the flight ring, not
    from the predictor, and the constant predictor's ``CHAOS_DELAY_S``
    hold is what keeps a request in flight for the kill."""
    if args.predictor == "constant" or chaos:
        spec_kwargs = {"num_parts": 18, "n_people": 2,
                       "delay_s": CHAOS_DELAY_S if chaos else DELAY_S}
        return dict(spec=CONSTANT_SPEC, num_workers=2,
                    spec_kwargs=spec_kwargs, slots=16 if chaos else 8,
                    max_image_hw=(64, 64), num_parts=18, max_people=8,
                    restart_after_s=0.3, probe_interval_s=0.05)
    spec_kwargs = {"config": args.config, "checkpoint": args.checkpoint,
                   "params_dtype": args.params_dtype, "boxsize": args.size,
                   "seed": args.seed, "device": args.device}
    return dict(spec=MODEL_SPEC, num_workers=2, spec_kwargs=spec_kwargs,
                slots=8,
                max_image_hw=(args.size, args.size),
                num_parts=MODEL_PARTS, max_people=MODEL_PEOPLE,
                restart_after_s=0.3, probe_interval_s=0.05)


def audit_images(side: int):
    """The audit's 8 seeded uint8 ``side``² images (rng 0): 48 for the
    constant predictor (the JAX tool's), ``--size`` for the model."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
            for _ in range(8)]


def run_slice(router, images, n_clients, requests):
    """Closed-loop slice: n_clients threads, each ``requests``
    submit→result round-trips; returns imgs/sec."""
    from ..serve import submit_with_retry

    errs = []

    def work(cid):
        for i in range(requests):
            img = images[(cid + i) % len(images)]
            try:
                fut, _ = submit_with_retry(router.submit, img,
                                           base_s=0.002, max_s=0.05)
                fut.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — surfaced in report
                errs.append(repr(e))
                return
    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise SystemExit(f"audit slice failed: {errs[0]}")
    return round(n_clients * requests / wall, 3)


def worker_generations(shard_paths) -> list:
    """One record a worker generation in the sink shards: its pid and,
    where it reached ``worker_stop``, the requests it served and each
    decode kernel's launches after its warmup (``worker_stop`` minus the
    last ``worker_warm``; a generation never warmed counts from its
    start).  A generation killed before its stop has ``stopped`` False
    and no counts."""
    from ..obs.events import read_events

    gens = []
    for path in shard_paths:
        if not os.path.exists(path):
            continue
        gen = warm = None
        for rec in read_events(path):
            ev = rec.get("event")
            if ev == "run_start":
                gen = {"shard": os.path.basename(path), "pid": None,
                       "stopped": False}
                gens.append(gen)
                warm = {"served": 0, "kernel_launches": {
                    k: 0 for k in DECODE_KERNELS}}
            elif gen is None:
                continue
            elif ev == "worker_start":
                gen["pid"] = rec["pid"]
            elif ev == "worker_warm":
                warm = rec
            elif ev == "worker_stop":
                stop = rec.get("kernel_launches") or {}
                gen.update(stopped=True,
                           served=rec["served"] - warm["served"],
                           launches={k: stop.get(k, 0)
                                     - warm["kernel_launches"].get(k, 0)
                                     for k in DECODE_KERNELS})
    return gens


def _get(url: str):
    """(status, body) of one GET; an error status is an answer here, not
    an exception (``/slo`` answers 503 while its objectives burn, which a
    real model's latency can make them do; ``/healthz`` 503 while
    unhealthy, which the scrape gate reads)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def audit(args, serve_hook: Optional[Callable] = None) -> dict:
    """The five gates and the trace-stitch proof; returns the report.
    ``serve_hook``, when given, is called with the ON arm's router after
    the unmeasured warm slices (the ON plane installed): a caller serves
    its own requests through the audited fleet, before the A/B rounds,
    so the workers' counters are published again by the time the
    conservation gate reads them at quiescence.  Every router is stopped
    on the way out, whatever raised."""
    from ..obs.events import NullSink, set_sink
    from ..obs.trace import NullTraceRecorder, set_tracer

    routers = []
    try:
        return _audit(args, routers, serve_hook)
    finally:
        for router in routers:
            router.stop()
        set_sink(NullSink())
        set_tracer(NullTraceRecorder())


def _audit(args, routers: list, serve_hook) -> dict:
    from ..obs.events import EventSink, NullSink, set_sink
    from ..obs.fleet import verify_postmortem
    from ..obs.health import HealthSentinel
    from ..obs.http import MetricsServer
    from ..obs.recompile import CompileWatch
    from ..obs.registry import Registry
    from ..obs.slo import SLOTracker, default_objectives
    from ..obs.trace import NullTraceRecorder, TraceRecorder, set_tracer
    from ..serve.router import ProcessRouter
    from .trace_report import discover_shards, stitch_shards, summarize

    workdir = tempfile.mkdtemp(prefix="fleet_audit_")
    trace_path = os.path.join(workdir, "trace.json")
    sink_path = os.path.join(workdir, "events.jsonl")
    chaos_sink = os.path.join(workdir, "chaos_events.jsonl")
    images = audit_images(48 if args.predictor == "constant"
                          else args.size)
    hw = tuple(images[0].shape[:2])
    # the JAX tool warms the wire's size; a model worker serves one image
    # a call, so its lane warms at the images' size and batch 1
    warm = (([hw], dict(batch_sizes=[1])) if args.predictor == "model"
            else ([(64, 64)], {}))

    # ---------------------------------------------------------- ON arm
    # real sink + tracer + telemetry=True workers; installed while the
    # ON router spawns so the run_id rides into the worker shards
    sink = EventSink(sink_path, run_meta={"run_id": "fleet-audit"})
    tracer = TraceRecorder(capacity=65536, t0=sink.t0)
    null_tracer = NullTraceRecorder()
    null_sink = NullSink()
    set_sink(sink)
    set_tracer(tracer)
    registry = Registry()
    watch = CompileWatch(registry=registry, sink=null_sink).install()
    slo = SLOTracker(default_objectives(), default_class="interactive")
    on_router = ProcessRouter(**router_kwargs(args), telemetry=True,
                              trace_path=trace_path, slo=slo)
    routers.append(on_router)
    on_router.register_into(registry)
    t_start = time.perf_counter()
    on_router.start()
    # the chaos round's router (the JAX tool's) starts now too (its own
    # sink shards, so no two live workers append to one file); it idles
    # until gate 5
    chaos_router = ProcessRouter(**router_kwargs(args, chaos=True),
                                 telemetry=True, sink_path=chaos_sink)
    routers.append(chaos_router)
    chaos_router.start()

    # --------------------------------------------------------- OFF arm
    # the A/A hazard rule: disable EXPLICITLY — null sink + null tracer
    # + telemetry=False (workers install NullSink/NullTraceRecorder and
    # never publish; only the 4-float heartbeat moves).  The SLO
    # tracker feeds on BOTH arms: it is not the fleet plane under test,
    # so its per-request cost must cancel in the pair
    set_sink(null_sink)
    set_tracer(null_tracer)
    off_router = ProcessRouter(**router_kwargs(args), telemetry=False,
                               slo=slo)
    routers.append(off_router)
    off_router.start()
    # every worker process starts beside the others; the warmups wait
    # for them in the JAX tool's order
    on_router.warmup(warm[0], **warm[1])
    off_router.warmup(warm[0], **warm[1])
    chaos_router.warmup([(64, 64)])
    start_s = time.perf_counter() - t_start
    watch.mark_warm("fleet audit warmup")
    c_warm = int(watch.compiles.value)

    # one unmeasured slice per arm: first-touch costs (track
    # registration, ring growth, page faults on the telem block) are
    # startup, not per-request overhead
    set_sink(sink)
    set_tracer(tracer)
    run_slice(on_router, images, args.clients, args.requests)
    set_sink(null_sink)
    set_tracer(null_tracer)
    run_slice(off_router, images, args.clients, args.requests)
    if serve_hook is not None:
        set_sink(sink)
        set_tracer(tracer)
        serve_hook(on_router)

    report = {
        "generated_by": "improved_body_parts_torch/cli/fleet_audit.py",
        "protocol": {
            "workers": 2, "clients": args.clients,
            "requests_per_client": args.requests,
            "rounds": args.rounds, "predictor": args.predictor,
            "predictor_delay_s": (DELAY_S if args.predictor == "constant"
                                  else None),
            "image_hw": list(hw),
            "chaos_router": f"{CONSTANT_SPEC}, delay {CHAOS_DELAY_S} s",
            "interleaved": True,
            "off_arm": "explicit NullSink + NullTraceRecorder + "
                       "telemetry=False (never 'unconfigured')",
        },
        "workers_started_and_warmed_s": round(start_s, 3),
    }
    if args.predictor == "model":
        report["protocol"].update(
            config=args.config, checkpoint=args.checkpoint,
            params_dtype=args.params_dtype, seed=args.seed,
            device=args.device)

    # ------------------------------------------- 1: interleaved A/B
    on_ips, off_ips = [], []
    arm_compile_delta = {"on": 0, "off": 0}
    for rnd in range(args.rounds):
        set_sink(sink)
        set_tracer(tracer)
        c0 = int(watch.compiles.value)
        on_ips.append(run_slice(on_router, images, args.clients,
                                args.requests))
        arm_compile_delta["on"] += int(watch.compiles.value) - c0
        set_sink(null_sink)
        set_tracer(null_tracer)
        c0 = int(watch.compiles.value)
        off_ips.append(run_slice(off_router, images, args.clients,
                                 args.requests))
        arm_compile_delta["off"] += int(watch.compiles.value) - c0
        print(f"round {rnd}: on {on_ips[-1]} vs off {off_ips[-1]} "
              "imgs/s", flush=True)
    per_round = [round((off - on) / off * 100.0, 3)
                 for on, off in zip(on_ips, off_ips)]
    median_overhead = round(statistics.median(per_round), 3)
    report["overhead"] = {
        "on_imgs_per_sec": on_ips, "off_imgs_per_sec": off_ips,
        "per_round_overhead_pct": per_round,
        "paired_median_overhead_pct": median_overhead,
        "gate_pct": OVERHEAD_GATE_PCT,
        "ok": bool(median_overhead < OVERHEAD_GATE_PCT),
    }

    # restore the ON plane for the remaining gates
    set_sink(sink)
    set_tracer(tracer)

    # ------------------------------------------- 2: conservation
    cons = on_router.fleet.conservation()
    report["conservation"] = {
        **cons, "gate": MIN_COVERAGE,
        "ok": bool(cons["frac"] is not None
                   and cons["frac"] >= MIN_COVERAGE),
    }

    # ------------------------------------------- 3: compile deltas
    telem_rows = [w["telemetry"]
                  for w in on_router.fleet_state()["workers"]]
    worker_recompiles = {
        "on": sum(int(t.get("recompiles_post_warmup", 0))
                  for t in telem_rows),
        "off": sum(int(w["recompiles_post_warmup"])
                   for w in off_router.worker_stats()),
    }
    report["compiles"] = {
        "parent_warmup_compiles": c_warm,
        "parent_per_arm_delta": arm_compile_delta,
        "worker_recompiles_post_warmup": worker_recompiles,
        "ok": bool(arm_compile_delta["on"] == 0
                   and arm_compile_delta["off"] == 0
                   and worker_recompiles["on"] == 0
                   and worker_recompiles["off"] == 0),
    }

    # ------------------------------------------- 4: live scrape
    import json

    sentinel = HealthSentinel(registry=registry, sink=null_sink)
    sentinel.set_extra("fleet", on_router.health_extra)
    with MetricsServer(registry, health=sentinel.state, slo=slo.state,
                       fleet=on_router.fleet_state) as srv:
        _, prom = _get(srv.url + "/metrics")
        _, body = _get(srv.url + "/fleet")
        fleet_doc = json.loads(body)
        healthz_code, body = _get(srv.url + "/healthz")
        healthz = json.loads(body)
        slo_code, _ = _get(srv.url + "/slo")
    missing = [f for f in REQUIRED_FAMILIES
               if f'{f}{{' not in prom.replace(" ", "")
               or 'worker="0"' not in prom or 'worker="1"' not in prom]
    report["scrape"] = {
        "families_required": list(REQUIRED_FAMILIES),
        "families_missing": missing,
        "fleet_route_workers": len(fleet_doc.get("workers", [])),
        "fleet_route_conservation":
            fleet_doc.get("conservation", {}).get("frac"),
        "healthz_status": healthz.get("status"),
        "healthz_fleet_workers": len(
            (healthz.get("fleet") or {}).get("workers", [])),
        "healthz_code": healthz_code,
        "slo_code": slo_code,
        "ok": bool(not missing
                   and len(fleet_doc.get("workers", [])) == 2
                   and healthz_code == 200
                   and len((healthz.get("fleet") or {})
                           .get("workers", [])) == 2),
    }

    # stop the A/B fleet (the poison pill flushes the worker trace shards)
    on_router.stop()
    off_router.stop()
    tracer.save(trace_path)

    # ------------------------------------------- trace stitch
    with open(trace_path) as f:
        parent = json.load(f)
    shards = discover_shards(trace_path)
    shard_events, shard_infos = stitch_shards(
        parent.get("otherData", {}), shards)
    stitched = parent["traceEvents"] + shard_events
    summary = summarize([e for e in stitched if isinstance(e, dict)],
                        parent.get("otherData", {}))
    pf = summary.get("proc_flows") or {}
    report["trace_stitch"] = {
        "shards": shard_infos,
        "proc_flows": pf,
        "ok": bool(len(shard_infos) == 2
                   and pf.get("starts", 0) > 0
                   and pf.get("steps", 0) > 0
                   and pf.get("finishes", 0) > 0),
    }

    # ------------------------------------------- 5: chaos postmortem
    with chaos_router:
        img = audit_images(48)[0]
        chaos_router.submit(img).result(timeout=60)
        pid0 = chaos_router.workers[0].worker_stats()["pid"]
        futs = [chaos_router.submit(img) for _ in range(6)]
        time.sleep(0.05)                       # land the kill MID-batch
        in_flight = chaos_router.workers[0].worker_info()["in_flight"]
        os.kill(pid0, signal.SIGKILL)
        resolved = {"ok": 0, "error": 0}
        for f in futs:
            try:
                f.result(timeout=60)
                resolved["ok"] += 1
            except Exception:  # noqa: BLE001 — typed = resolved
                resolved["error"] += 1
        deadline = time.perf_counter() + 10
        while (chaos_router.workers[0].last_postmortem is None
               and time.perf_counter() < deadline):
            time.sleep(0.02)
        pm = chaos_router.workers[0].last_postmortem
    pm_ok, pm_problems = (verify_postmortem(pm) if pm is not None
                          else (False, ["no postmortem exhumed"]))
    report["chaos"] = {
        "injection": "SIGKILL worker 0 mid-batch",
        "killed_pid": pid0,
        "in_flight_at_kill": in_flight,
        "futures_resolved": resolved,
        "postmortem_ok": pm_ok,
        "postmortem_problems": pm_problems,
        "postmortem": pm,
        "ok": bool(pm_ok and sum(resolved.values()) == len(futs)),
    }

    # every worker generation's launches after its warmup (the kernels
    # run in the workers; the constant predictor launches none)
    gens = worker_generations(
        [f"{p}.p{i + 1}" for p in (sink_path, chaos_sink)
         for i in range(2)])
    report["worker_generations"] = gens
    report["worker_launches_after_warmup"] = {
        k: sum(g["launches"][k] for g in gens if g["stopped"])
        for k in DECODE_KERNELS}

    set_sink(null_sink)
    set_tracer(null_tracer)
    sink.close()
    if not args.keep_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    else:
        report["workdir"] = workdir

    report["ok"] = bool(all(report[k]["ok"] for k in
                            ("overhead", "conservation", "compiles",
                             "scrape", "trace_stitch", "chaos")))
    return report


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6,
                    help="interleaved A/B round pairs")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=50,
                    help="closed-loop requests per client per round")
    ap.add_argument("--quick", action="store_true",
                    help="CI budget: 3 rounds x 20 requests")
    ap.add_argument("--keep-workdir", action="store_true",
                    help="keep the trace/sink workdir for inspection")
    ap.add_argument("--predictor", choices=("model", "constant"),
                    default="model",
                    help="the workers' predictor: checkpoint_predictor "
                         "on --device (default), or the JAX tool's "
                         "host-only constant predictor")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", default=None,
                    help="epoch directory of train.checkpoint (default: "
                         "the seeded init of --seed)")
    ap.add_argument("--params-dtype", default="fp32",
                    choices=("fp32", "bf16", "auto", "int8"))
    ap.add_argument("--size", type=int, default=256,
                    help="the square image side (and boxsize) the model "
                         "workers serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for --predictor model")
    ap.add_argument("--out", default="fleet_obs_torch.json")
    return ap


def main(argv=None, serve_hook: Optional[Callable] = None) -> dict:
    """Run the audit, write the artifact and print the report; returns
    it, or exits 1 when its ``ok`` is false.  ``serve_hook``: see
    :func:`audit`."""
    args = _parser().parse_args(argv)
    from . import refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)
    if args.quick:
        args.rounds, args.requests = 3, 20
    import torch

    from .. import resolve_device
    from ..obs.events import strict_dump
    from . import card_stamp, exit_report

    # the constant predictor is host only; the model runs on --device,
    # which raises here, before any process starts, without a card
    device = (resolve_device(args.device) if args.predictor == "model"
              else torch.device("cpu"))
    report = audit(args, serve_hook=serve_hook)
    report.update(card_stamp(device))

    with open(args.out, "w") as f:
        strict_dump(report, f, indent=2, sort_keys=True)
    ov = report["overhead"]
    print(f"overhead: median {ov['paired_median_overhead_pct']}% "
          f"(gate < {ov['gate_pct']}%) "
          f"{'OK' if ov['ok'] else 'FAIL'}")
    print(f"conservation: frac {report['conservation']['frac']} "
          f"(gate >= {report['conservation']['gate']}) "
          f"{'OK' if report['conservation']['ok'] else 'FAIL'}")
    print(f"compiles: {report['compiles']['parent_per_arm_delta']} "
          f"{'OK' if report['compiles']['ok'] else 'FAIL'}")
    print(f"scrape: missing={report['scrape']['families_missing']} "
          f"{'OK' if report['scrape']['ok'] else 'FAIL'}")
    print(f"trace stitch: {report['trace_stitch']['proc_flows']} "
          f"{'OK' if report['trace_stitch']['ok'] else 'FAIL'}")
    print(f"chaos: postmortem_ok={report['chaos']['postmortem_ok']} "
          f"{'OK' if report['chaos']['ok'] else 'FAIL'}")
    print(f"wrote {args.out}  overall: "
          f"{'OK' if report['ok'] else 'FAIL'}")
    exit_report("fleet_audit", device, ok=report["ok"],
                worker_launches_after_warmup=report[
                    "worker_launches_after_warmup"])
    if not report["ok"]:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
