"""Multi-stream closed-loop streaming benchmark of the port: N simulated
webcams through ONE serving engine, per-stream FPS and end-to-end
latency (the port's counterpart of ``tools/stream_bench.py``)::

    python -m improved_body_parts_torch.cli.stream_bench --config tiny \\
        --streams 2 --frames 8 --size 128 --boxsize 128 --fastpath \\
        --device cpu --out stream_bench.json

Each simulated webcam is a deterministic synthetic video
(``stream.SyntheticVideo``: moving drawn stick people) driven closed-loop
through its own ``StreamSession``: the client submits frames as fast as
the session admits them, the session's ``max_in_flight`` bound pipelines
the stream against the engine, and results (tracked people) deliver
strictly in frame order.

Rounds interleave an N-stream arm and a serial 1-stream arm, so drift on
the host hits both arms of a round alike; the scaling ratio is the median
per-round ``aggregate_multi_fps / single_stream_fps``.  First runs of a
lane shape after warmup (``obs.CompileWatch``) are counted and must be 0.
``--fastpath`` interleaves a fastpath-on and a fastpath-off N-stream arm
instead, with the three-tier conservation block, and reruns both arms
over the ground-truth ``DetectionEngine`` on the ``static`` and
``slow_pan`` scenes (:func:`quality_arm`), gating equal synthetic AP and
identity switches.

The batcher serves across ``--devices N`` replicas
(``Predictor.device_replica``): cards 0..N-1, every visible card for 0,
more than are visible refused; on ``--device cpu``, N CPU replicas (the
JAX tool's virtual host devices).  The artifact records
``serve_devices`` and the requests each replica completed.

The model is ``--checkpoint``'s (an epoch directory of
``train.checkpoint``) or the seeded init of ``--config``; ``--planted N``
(default 2) adds N planted people's maps to its output
(``cli.e2e_bench.PlantedModel``: the whole forward still runs), so a
random init gives the decode real people.  It runs on ``--device cuda``
unless asked for ``cpu`` and writes one strict-JSON artifact, ``--out``
(default ``stream_bench_torch.json`` in the working directory; the JAX
tool's ``STREAM_BENCH.json`` / ``STREAM_FASTPATH.json`` are refused).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time

import numpy as np

from ..obs.events import strict_dump, strict_dumps
from .e2e_bench import PlantedModel, planted_maps

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("STREAM_BENCH.json", "STREAM_FASTPATH.json")


def run_streams(manager, videos, frames, policy, max_in_flight=None,
                fastpath=None):
    """Drive one closed-loop slice: each video gets its own session +
    client thread; returns (wall_s, per-session snapshots in stream
    order, id-stability flags).  ``max_in_flight=1`` is the serial
    baseline (submit → wait → next, no pipelining); ``fastpath`` is a
    ``FastPathConfig`` for the temporal-coherence arm (None = every
    frame pays a full forward)."""
    from ..stream import FrameDropped

    sessions = [manager.open(f"cam{i}", policy=policy,
                             max_in_flight=max_in_flight,
                             fastpath=fastpath)
                for i in range(len(videos))]
    stable = [True] * len(videos)
    errors = []

    def client(ci):
        vid = videos[ci]
        session = sessions[ci]
        futs = []
        try:
            for t in range(frames):
                futs.append(session.submit_frame(vid.frame(t % len(vid))))
            first_ids = None
            for fut in futs:
                try:
                    tracked = fut.result(timeout=600)
                except FrameDropped:
                    continue        # accounted by the session metrics
                ids = sorted(p.track_id for p in tracked)
                if first_ids is None:
                    first_ids = ids
                elif ids != first_ids:
                    stable[ci] = False
        except Exception as e:  # noqa: BLE001 — surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(videos))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    snaps = [s.snapshot() for s in sessions]
    for s in sessions:
        s.close(timeout_s=60)
    if errors:
        raise errors[0]
    return wall, snaps, stable


def arm_summary(wall, snaps, stable):
    delivered = sum(s["frames_delivered"] for s in snaps)
    return {
        "streams": len(snaps),
        "wall_s": round(wall, 3),
        "aggregate_fps": round(delivered / wall, 3) if wall else 0.0,
        "per_stream_fps": [s["fps"] for s in snaps],
        "per_stream_p50_ms": [s["e2e_latency_ms"]["p50"] for s in snaps],
        "per_stream_p95_ms": [s["e2e_latency_ms"]["p95"] for s in snaps],
        "frames_delivered": delivered,
        "frames_dropped": sum(s["frames_dropped"] for s in snaps),
        "frames_failed": sum(s["frames_failed"] for s in snaps),
        # engine-admission sheds absorbed by the sessions' jittered
        # backoff (serve.policy) — reported, never counted as failures
        "engine_shed_retries": sum(s["engine_shed_retries"]
                                   for s in snaps),
        "track_births": sum(s["tracker"]["births"] for s in snaps),
        "track_deaths": sum(s["tracker"]["deaths"] for s in snaps),
        "track_ids_stable": all(stable),
    }


def fastpath_block(snaps):
    """Aggregate the per-stream three-tier accounting into the artifact's
    per-tier conservation block + per-tier p50/p95/p99 latency block.

    Counters sum exactly across streams; ``exact`` holds iff every
    stream's own invariant held AND the summed ledger balances.  The
    percentile block reports, per tier and quantile, the MEDIAN across
    streams of that stream's quantile (reservoirs cannot be merged)."""
    fps = [s["fastpath"] for s in snaps]
    keys = ("submitted", "answered_tracker", "answered_roi",
            "escalated_full", "failed", "dropped", "depth")
    conservation = {k: sum(f[k] for f in fps) for k in keys}
    conservation["exact"] = (
        all(f["exact"] for f in fps)
        and conservation["submitted"]
        == sum(conservation[k] for k in keys[1:]))
    escalations = {}
    for f in fps:
        for reason, n in f["escalations"].items():
            escalations[reason] = escalations.get(reason, 0) + n
    tier_latency = {}
    for tier in ("tracker", "roi", "full"):
        answered = [f["tier_latency_ms"][tier] for f in fps
                    if f["tier_latency_ms"][tier]["count"] > 0]
        if not answered:
            continue
        tier_latency[tier] = {
            "count": sum(t["count"] for t in answered),
            **{q: round(float(np.median([t[q] for t in answered])), 3)
               for q in ("p50", "p95", "p99")}}
    submitted = max(conservation["submitted"], 1)
    return {
        "conservation": conservation,
        "escalations": escalations,
        "tier_latency_ms": tier_latency,
        "skip_rate": round(conservation["answered_tracker"] / submitted, 4),
        "roi_rate": round(conservation["answered_roi"] / submitted, 4),
    }


#: COCO-style OKS thresholds for the synthetic-AP quality gate
OKS_THRESHOLDS = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))


class SyntheticAP:
    """OKS-matched average precision against the generator's ground
    truth: per frame, GT people greedily match delivered people on the
    same OKS similarity the tracker uses; per threshold t,
    ``AP_t = matches(OKS >= t) / max(n_gt, n_delivered)`` summed over
    frames, and the reported AP is the mean over the COCO threshold
    ladder.  An arm that delivers exactly the GT scores 1.0."""

    def __init__(self):
        self.tp = {t: 0 for t in OKS_THRESHOLDS}
        self.denom = 0

    def update(self, gt_people, tracked):
        from ..stream.track import (
            _extent_area,
            _to_arrays,
            greedy_match,
            keypoint_similarity,
        )

        refs = [_to_arrays(coords) for _, coords in gt_people]
        dets = [_to_arrays(p.keypoints) for p in tracked]
        sim = np.zeros((len(refs), len(dets)), dtype=np.float64)
        for gi, (gxy, gvalid) in enumerate(refs):
            area = _extent_area(gxy, gvalid)
            for di, (dxy, dvalid) in enumerate(dets):
                sim[gi, di] = keypoint_similarity(
                    gxy, gvalid, dxy, dvalid, area=area)
        matched = [sim[gi, di] for gi, di in greedy_match(sim, 1e-6)]
        for t in OKS_THRESHOLDS:
            self.tp[t] += sum(1 for s in matched if s >= t)
        self.denom += max(len(refs), len(dets))

    def value(self):
        if self.denom == 0:
            return 0.0
        return float(sum(self.tp[t] / self.denom
                         for t in OKS_THRESHOLDS)) / len(OKS_THRESHOLDS)


def quality_arm(scene, frames, size, people, seed, fp_cfg):
    """One deterministic quality protocol run: a stamped-frame
    ``SyntheticVideo`` scene driven through a ``StreamSession`` over the
    ground-truth ``DetectionEngine`` (no model, no device — the engine
    answers crops honestly, windowed to what the crop can see).
    Returns synthetic-AP, IDSW, engine forwards, and — fastpath arms —
    the tier mix + conservation, so the A/B can gate EQUAL quality at a
    fraction of the forwards."""
    from ..stream import (
        DetectionEngine,
        IdentitySwitchCounter,
        SessionManager,
        SyntheticVideo,
    )

    vid = SyntheticVideo(seed=seed, num_people=people, size=(size, size),
                         num_frames=frames, scene=scene)
    eng = DetectionEngine(vid)
    manager = SessionManager(eng, smoothing=None, max_in_flight=1)
    session = manager.open(f"q_{scene}", fastpath=fp_cfg)
    ap = SyntheticAP()
    idsw = IdentitySwitchCounter()
    for t in range(frames):
        tracked = session.submit_frame(vid.stamped_frame(t)).result(
            timeout=120)
        gt = vid.gt(t)
        ap.update(gt, tracked)
        idsw.update(gt, tracked)
    snap = session.snapshot()
    manager.close_all(timeout_s=60)
    out = {
        "frames": frames,
        "synthetic_ap": round(ap.value(), 6),
        "identity_switches": idsw.switches,
        "engine_forwards": eng.calls,
    }
    if fp_cfg is not None:
        out["fastpath"] = fastpath_block([snap])
    return out


class PreRendered:
    """Pre-rendered frame cycle for one simulated webcam (rendering is
    cv2 host work; pre-rendering keeps the measured loop pure
    submit/deliver)."""

    def __init__(self, vid):
        self._frames = vid.frames()

    def __len__(self):
        return len(self._frames)

    def frame(self, t):
        return self._frames[t]


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", default=None,
                    help="an epoch directory of train.checkpoint (default: "
                         "the seeded init of --config)")
    ap.add_argument("--streams", type=int, default=4,
                    help="concurrent simulated webcams in the multi arm")
    ap.add_argument("--frames", type=int, default=24,
                    help="frames each stream submits per round")
    ap.add_argument("--video-frames", type=int, default=16,
                    help="distinct frames per synthetic video (cycled)")
    ap.add_argument("--people", type=int, default=2,
                    help="moving stick people per stream")
    ap.add_argument("--size", type=int, default=256,
                    help="square frame size of the simulated webcams")
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved verdict rounds")
    ap.add_argument("--policy", default="block",
                    choices=["block", "drop_oldest"])
    ap.add_argument("--max-in-flight", type=int, default=4,
                    help="per-stream pipeline depth (the backpressure "
                         "bound)")
    ap.add_argument("--smoothing", default="one_euro",
                    choices=["none", "one_euro", "ema"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--decode-workers", type=int, default=2)
    ap.add_argument("--boxsize", type=int, default=0,
                    help="override InferenceModelParams.boxsize (0 = the "
                         "default protocol)")
    ap.add_argument("--planted", type=int, default=2,
                    help="plant GT-style maps for N synthetic people into "
                         "the network's output (0 = the network alone)")
    ap.add_argument("--planted-canvas", type=int, default=0,
                    help="canvas px the planted crowd is laid out on "
                         "(0 = auto)")
    ap.add_argument("--fastpath", action="store_true",
                    help="temporal-coherence A/B: rounds interleave a "
                         "fastpath-on and a fastpath-off N-stream arm, "
                         "with the three-tier conservation block and the "
                         "quality protocols (static + slow_pan scenes "
                         "over the ground-truth engine)")
    ap.add_argument("--fp-max-skip-run", type=int, default=3)
    ap.add_argument("--fp-min-stable", type=int, default=2)
    ap.add_argument("--fp-roi-width", type=int, default=0,
                    help="ROI crop width in px: the one extra warmup "
                         "bucket (size, roi_width); 0 disables the ROI "
                         "tier")
    ap.add_argument("--fp-roi-margin", type=int, default=32)
    ap.add_argument("--fp-full-refresh-every", type=int, default=4)
    ap.add_argument("--fp-people-delta", type=int, default=0,
                    help="tolerated |person-count delta| before a full "
                         "forward is owed (a planted model's crops can "
                         "decode another count than the full frame)")
    ap.add_argument("--fp-gate", type=float, default=3.0,
                    help="aggregate-fps multiplier the fastpath-on arm "
                         "must reach (median per-round ratio)")
    ap.add_argument("--fp-quality-frames", type=int, default=48)
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32"])
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="device replicas the batcher serves across "
                         "(0 = every visible card; on --device cpu, N "
                         "CPU replicas, 0 = one)")
    ap.add_argument("--telemetry-sink", default="auto",
                    help="JSONL event stream ('auto' = <out>_events"
                         ".jsonl, 'none' disables)")
    ap.add_argument("--telemetry-port", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="stream_bench_torch.json",
                    help="the artifact (relative to the working "
                         "directory)")
    return ap


def build_predictor(args, device):
    """The bench's ``Predictor``: ``--checkpoint`` or the seeded init of
    ``--config`` at ``--params-dtype``, wrapped in ``PlantedModel``
    when ``--planted`` > 0."""
    from ..config import get_config
    from ..serve import checkpoint_predictor

    pred = checkpoint_predictor(args.config, args.checkpoint,
                                params_dtype=args.params_dtype,
                                boxsize=args.boxsize, device=device)
    if args.planted > 0:
        sk = get_config(args.config).skeleton
        canvas = (args.planted_canvas if args.planted_canvas > 0
                  else max(int(args.size / 0.6) + 64, 640))
        pred.model = PlantedModel(pred.model, planted_maps(
            sk, args.planted, np.random.default_rng(0), canvas=canvas), sk)
    return pred


def serve_devices(count: int, device) -> list:
    """The replicas' devices for ``--devices count`` on ``device``: cards
    0..N-1 (0 = every visible card; more than are visible is refused),
    or N CPU replicas (the JAX tool's virtual host devices)."""
    import torch

    if count < 0:
        raise SystemExit(f"--devices {count}: must be >= 0")
    if device.type == "cpu":
        return [torch.device("cpu")] * max(count, 1)
    visible = torch.cuda.device_count()
    if count > visible:
        raise SystemExit(f"--devices {count}: only {visible} CUDA "
                         f"device(s) are visible")
    return [torch.device("cuda", i) for i in range(count or visible)]


def main(argv=None):
    args = _parser().parse_args(argv)

    from .. import resolve_device
    from ..obs import Registry, RunTelemetry
    from ..serve import DynamicBatcher
    from ..stream import FastPathConfig, SessionManager, SyntheticVideo
    from . import exit_report, refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)

    device = resolve_device(args.device)
    devices = serve_devices(args.devices, device)
    print(f"platform={device.type} serve_devices={len(devices)}",
          flush=True)
    pred = build_predictor(args, device)
    videos = [PreRendered(SyntheticVideo(seed=i, num_people=args.people,
                                         size=(args.size, args.size),
                                         num_frames=args.video_frames))
              for i in range(args.streams)]

    fp_cfg = None
    if args.fastpath:
        fp_cfg = FastPathConfig(
            max_skip_run=args.fp_max_skip_run,
            min_stable=args.fp_min_stable,
            roi_width=args.fp_roi_width,
            roi_margin=args.fp_roi_margin,
            full_refresh_every=args.fp_full_refresh_every,
            people_delta=args.fp_people_delta)

    sink_path = None
    if args.telemetry_sink not in ("none", ""):
        sink_path = (os.path.splitext(args.out)[0] + "_events.jsonl"
                     if args.telemetry_sink == "auto"
                     else args.telemetry_sink)
    telemetry = RunTelemetry(
        sink_path, registry=Registry(),
        http_port=(args.telemetry_port if args.telemetry_port >= 0
                   else None),
        run_meta={"tool": "stream_bench", "config": args.config,
                  "device": device.type},
        device=device)
    if telemetry.server is not None:
        print(f"telemetry: {telemetry.server.url}/metrics", flush=True)
    try:
        report = _bench(args, device, devices, pred, videos, fp_cfg,
                        telemetry, sink_path, DynamicBatcher,
                        SessionManager)
    finally:
        telemetry.close()
    _write(args.out, report)
    exit_report("stream_bench", device, config=args.config,
                **report["verdict"])
    return report


def _write(path, report):
    with open(path, "w") as f:
        strict_dump(report, f, indent=2)


def _bench(args, device, devices, pred, videos, fp_cfg, telemetry,
           sink_path, DynamicBatcher, SessionManager):
    """The rounds and the verdicts, over a batcher of one
    ``Predictor.device_replica`` on each of ``devices``; returns the
    artifact's document (its ``verdict`` block is also the
    ``CLI_REPORT``'s fields)."""
    report = {
        "device": device.type, "config": args.config,
        "checkpoint": args.checkpoint,
        "streams": args.streams, "frames_per_stream": args.frames,
        "people_per_stream": args.people, "size": args.size,
        "policy": args.policy, "max_in_flight": args.max_in_flight,
        "smoothing": args.smoothing, "rounds": args.rounds,
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
        "planted_people": args.planted,
        "serve_devices": len(devices),
        "telemetry_events": sink_path,
        "fastpath_mode": bool(args.fastpath),
    }
    if fp_cfg is not None:
        report["fastpath_config"] = dataclasses.asdict(fp_cfg)
    smoothing = None if args.smoothing == "none" else args.smoothing
    with DynamicBatcher(pred, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        max_queue=args.max_queue,
                        decode_workers=args.decode_workers,
                        use_native=not args.no_native,
                        devices=devices,
                        registry=telemetry.registry) as server:
        # the fast path's ROI tier lands in exactly ONE extra lane
        # bucket (full height, roi_width), warmed here with the
        # full-frame bucket so the 0-first-runs-after-warmup gate covers
        # both tiers
        warm_shapes = [(args.size, args.size)]
        if fp_cfg is not None and 0 < fp_cfg.roi_width < args.size:
            warm_shapes.append((args.size, fp_cfg.roi_width))
        warm = server.warmup(warm_shapes)
        report["warmup"] = {
            "bucket_shapes": [list(s) for s in warm["bucket_shapes"]],
            "batch_sizes": list(warm["batch_sizes"]),
            "newly_compiled": warm["newly_compiled"]}
        manager = SessionManager(server, registry=telemetry.registry,
                                 smoothing=smoothing,
                                 max_in_flight=args.max_in_flight,
                                 policy=args.policy)
        # one untimed traffic slice through the sessions' own paths (and
        # the fast path's tracker tier, ROI crop and paste-back)
        run_streams(manager, videos, max(4, args.max_batch), args.policy)
        if fp_cfg is not None:
            run_streams(manager, videos, max(4, args.max_batch),
                        args.policy, fastpath=fp_cfg)
        telemetry.mark_warm("stream warmup + warm slice")
        rounds = []
        watch = telemetry.compile_watch
        for r in range(max(1, args.rounds)):
            if fp_cfg is not None:
                c0 = int(watch.recompiles.value)
                wall, snaps, stable = run_streams(
                    manager, videos, args.frames, args.policy,
                    fastpath=fp_cfg)
                on = arm_summary(wall, snaps, stable)
                on["recompile_delta"] = int(watch.recompiles.value) - c0
                on["fastpath"] = fastpath_block(snaps)
                c0 = int(watch.recompiles.value)
                off = arm_summary(*run_streams(
                    manager, videos, args.frames, args.policy))
                off["recompile_delta"] = int(watch.recompiles.value) - c0
                rounds.append({"fastpath_on": on, "fastpath_off": off})
                telemetry.emit(
                    "stream_fastpath_round", round=r,
                    on_aggregate_fps=on["aggregate_fps"],
                    off_aggregate_fps=off["aggregate_fps"],
                    skip_rate=on["fastpath"]["skip_rate"],
                    conservation_exact=on["fastpath"]["conservation"][
                        "exact"])
                print(f"round {r}: fastpath {on['aggregate_fps']} fps "
                      f"agg (skip {on['fastpath']['skip_rate']}, roi "
                      f"{on['fastpath']['roi_rate']}) vs baseline "
                      f"{off['aggregate_fps']} fps", flush=True)
                continue
            multi = arm_summary(*run_streams(manager, videos, args.frames,
                                             args.policy))
            # baseline arm: ONE webcam driven serially (depth 1)
            single = arm_summary(*run_streams(
                manager, videos[:1], args.frames, args.policy,
                max_in_flight=1))
            rounds.append({"multi": multi, "single": single})
            telemetry.emit(
                "stream_round", round=r,
                multi_aggregate_fps=multi["aggregate_fps"],
                single_fps=single["per_stream_fps"][0],
                dropped=multi["frames_dropped"])
            print(f"round {r}: multi {multi['aggregate_fps']} fps agg "
                  f"(per-stream {multi['per_stream_fps']}) vs single "
                  f"{single['per_stream_fps'][0]} fps", flush=True)
        serve_snap = server.metrics.snapshot()
        manager.close_all(timeout_s=60)
    report["rounds_detail"] = rounds
    report["serve_replica_completed"] = {
        str(r): n
        for r, n in server.metrics.completed_by_replica().items()}
    report["mean_batch_occupancy"] = serve_snap["mean_batch_occupancy"]
    report["occupancy_histogram"] = serve_snap["occupancy_histogram"]
    report["decode_fused"] = serve_snap["decode_fused"]
    report["decode_host_fallback"] = serve_snap["decode_host_fallback"]
    report["engine_hops_ms"] = serve_snap["hops_ms"]
    report["engine_hop_conservation_frac"] = \
        serve_snap["hop_conservation_frac"]
    recompiles = int(telemetry.compile_watch.recompiles.value)
    report["recompiles_post_warmup"] = recompiles
    arms = (("fastpath_on", "fastpath_off") if fp_cfg is not None
            else ("multi",))
    main_arm = arms[0]
    last = rounds[-1][main_arm]
    for key in ("per_stream_fps", "per_stream_p50_ms", "per_stream_p95_ms"):
        report[key] = last[key]
    for key, name in (("frames_delivered", "frames_delivered_total"),
                      ("frames_dropped", "frames_dropped_total"),
                      ("frames_failed", "frames_failed_total"),
                      ("engine_shed_retries", "engine_shed_retries_total")):
        report[name] = sum(r[a][key] for r in rounds for a in arms)
    min_fps = min(min(r[a]["per_stream_fps"]) for r in rounds for a in arms)
    report["min_stream_fps"] = round(min_fps, 3)
    report["all_streams_sustained"] = bool(
        min_fps > 0.0 and report["frames_failed_total"] == 0
        and (report["frames_dropped_total"] == 0
             or args.policy == "drop_oldest"))
    if fp_cfg is None:
        ratios = sorted(r["multi"]["aggregate_fps"]
                        / max(r["single"]["per_stream_fps"][0], 1e-9)
                        for r in rounds)
        report["per_round_scaling_ratio"] = [round(x, 3) for x in ratios]
        report["median_scaling_ratio"] = round(ratios[len(ratios) // 2], 3)
        report["track_ids_stable_all_rounds"] = all(
            r["multi"]["track_ids_stable"] for r in rounds)
        report["verdict"] = {
            "all_streams_sustained": report["all_streams_sustained"],
            "median_scaling_ratio": report["median_scaling_ratio"],
            "recompiles_post_warmup": recompiles}
        telemetry.emit("stream_verdict", **report["verdict"])
        return report
    _fastpath_verdict(args, fp_cfg, rounds, report, telemetry)
    return report


def _fastpath_verdict(args, fp_cfg, rounds, report, telemetry):
    """The fastpath A/B's whole-run ledger, speedup and quality gates."""
    ratios = sorted(r["fastpath_on"]["aggregate_fps"]
                    / max(r["fastpath_off"]["aggregate_fps"], 1e-9)
                    for r in rounds)
    report["per_round_fastpath_speedup"] = [round(x, 3) for x in ratios]
    report["median_fastpath_speedup"] = round(ratios[len(ratios) // 2], 3)
    report["fastpath_speedup_gate"] = args.fp_gate
    report["fastpath_speedup_sustained"] = bool(
        report["median_fastpath_speedup"] >= args.fp_gate)
    keys = ("submitted", "answered_tracker", "answered_roi",
            "escalated_full", "failed", "dropped", "depth")
    cons = {k: sum(r["fastpath_on"]["fastpath"]["conservation"][k]
                   for r in rounds) for k in keys}
    cons["exact"] = all(r["fastpath_on"]["fastpath"]["conservation"]["exact"]
                        for r in rounds)
    esc = {}
    for r in rounds:
        for reason, n in r["fastpath_on"]["fastpath"]["escalations"].items():
            esc[reason] = esc.get(reason, 0) + n
    report["fastpath_conservation"] = cons
    report["fastpath_escalations"] = esc
    report["fastpath_tier_latency_ms"] = \
        rounds[-1]["fastpath_on"]["fastpath"]["tier_latency_ms"]
    report["fastpath_skip_rate"] = round(
        cons["answered_tracker"] / max(cons["submitted"], 1), 4)
    report["fastpath_roi_rate"] = round(
        cons["answered_roi"] / max(cons["submitted"], 1), 4)
    report["fastpath_arm_recompile_delta_total"] = sum(
        r["fastpath_on"]["recompile_delta"] for r in rounds)
    report["baseline_arm_recompile_delta_total"] = sum(
        r["fastpath_off"]["recompile_delta"] for r in rounds)
    report["track_ids_stable_all_rounds"] = all(
        r["fastpath_off"]["track_ids_stable"] for r in rounds)
    report["fastpath_track_ids_stable_all_rounds"] = all(
        r["fastpath_on"]["track_ids_stable"] for r in rounds)
    # deterministic quality protocols: both arms over the ground-truth
    # DetectionEngine (honest crops, people_delta=0), static + slow_pan
    q_cfg = dataclasses.replace(fp_cfg, people_delta=0)
    quality = {}
    for scene in ("static", "slow_pan"):
        q_on = quality_arm(scene, args.fp_quality_frames, args.size,
                           args.people, 3, q_cfg)
        q_off = quality_arm(scene, args.fp_quality_frames, args.size,
                            args.people, 3, None)
        quality[scene] = {
            "fastpath_on": q_on,
            "fastpath_off": q_off,
            "ap_equal": bool(q_on["synthetic_ap"] == q_off["synthetic_ap"]),
            "idsw_equal": bool(q_on["identity_switches"]
                               == q_off["identity_switches"]),
            "forwards_saved_frac": round(
                1.0 - q_on["engine_forwards"]
                / max(q_off["engine_forwards"], 1), 4),
        }
        print(f"quality[{scene}]: ap {q_on['synthetic_ap']} vs "
              f"{q_off['synthetic_ap']}, idsw "
              f"{q_on['identity_switches']} vs "
              f"{q_off['identity_switches']}, forwards "
              f"{q_on['engine_forwards']} vs "
              f"{q_off['engine_forwards']}", flush=True)
    report["quality"] = quality
    report["quality_equal_all_scenes"] = all(
        q["ap_equal"] and q["idsw_equal"] for q in quality.values())
    report["verdict"] = {
        "fastpath_speedup_sustained": report["fastpath_speedup_sustained"],
        "median_fastpath_speedup": report["median_fastpath_speedup"],
        "quality_equal_all_scenes": report["quality_equal_all_scenes"],
        "fastpath_conservation_exact": cons["exact"],
        "recompiles_post_warmup": report["recompiles_post_warmup"]}
    telemetry.emit("stream_fastpath_verdict", **report["verdict"])
    print(strict_dumps(report["verdict"]), flush=True)


if __name__ == "__main__":
    main()
