"""Test-time-augmentation grids on one checkpoint, and the fused-vs-looped
grid A/B (``--ab``) -- the port's counterpart of ``tools/tta_bench.py``::

    python -m improved_body_parts_torch.cli.tta_bench --config synth \\
        --checkpoint ckpt/epoch_1 --anno person_keypoints_synth.json \\
        --images val/ --boxsize 128 --device cpu --out tta_torch.json
    python -m improved_body_parts_torch.cli.tta_bench --ab --config tiny \\
        --size 128 --scales 0.5,0.75,1.0 --rotations 0,30,-30

Grid mode scores the checkpoint under each named grid (:data:`GRIDS`,
the reference's TTA surface: scale_search x rotation x flip, reference:
evaluate.py:87-96) with the OKS evaluator on the compact lane, the grid
running on the device, and writes AP and wall seconds per grid.

``--ab`` compares the grid's two dispatch forms (``Predictor.fused_tta``)
on synthetic images, over the checkpoint's model or a seeded init.
``--planted N`` (default 2) wraps the model in ``cli.e2e_bench``'s
``PlantedModel`` over N planted people, so the payloads decode to people.
A parity pass (untimed; it also warms both forms) holds the fused and
looped packed rows equal bit for bit on every image, scores the fused
arm's decoded people against the looped arm's (:func:`oks_ap`, looped
standing as ground truth: bit-equal payloads score exactly 1.0) and
reads each arm's dispatches per image from ``Predictor.dispatch_count``
(1 fused, entries + 1 looped).  Then ``--rounds`` rounds each run a fused
and a looped arm over the same images, every row fetched to the host, so
drift on the host hits both arms of a round alike; the verdict is the
median per-round looped / fused time, which must reach ``--gate``
(1.3 by default) on the card (on the CPU the gate does not bind, as the
JAX tool's does not).  The first dispatches after the parity pass are
counted per arm (``obs.RunTelemetry``'s compile watch) and must be 0.
The exit code is the JAX tool's verdict: 0 when the payloads and the AP
parity are equal, the fused arm takes 1 dispatch an image (and the
looped one entries + 1), nothing ran first after warmup and the gate
holds wherever it binds; 1 otherwise.  ``--telemetry-sink`` (``auto`` =
``<out stem>_events.jsonl``, ``none`` disables it) streams a
``tta_ab_round`` event a round and a ``tta_ab_verdict`` event.

Both modes write one strict JSON artifact (``--out``: ``tta_torch.json``
for the grids, ``tta_ab_torch.json`` under ``--ab``; the JAX tool's
``TTA.json``, ``TTA_AB.json`` and ``TTA_AB_events.jsonl`` are refused
before any work) and run on ``--device cuda`` unless asked for ``cpu``.
``chip_smoke.py`` calls :func:`ab_report` in its process.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import numpy as np

from .e2e_bench import synth_images

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("TTA.json", "TTA_AB.json", "TTA_AB_events.jsonl")
GRID_OUT, AB_OUT = "tta_torch.json", "tta_ab_torch.json"

GRIDS = {
    "single_scale": {},
    "rotation_pm30": {"rotation_search": (0.0, 30.0, -30.0)},
    # the hard synthetic tier rotates figures up to +-60 deg, past what a
    # +-30 grid covers (reference: evaluate.py:89-90 takes any angles)
    "rotation_pm60": {"rotation_search": (0.0, 30.0, -30.0, 60.0, -60.0)},
    "multi_scale": {"scale_search": (0.8, 1.0, 1.2)},
    "ms_rot_pm60": {"scale_search": (0.8, 1.0, 1.2),
                    "rotation_search": (0.0, 30.0, -30.0, 60.0, -60.0)},
}


def run_arm(pred, images, prm, fused: bool, mode: str = "compact"):
    """Every image through the grid dispatch, its packed row fetched (the
    round trip a caller pays).  Returns (ms an image on the host clock,
    dispatches an image, the fetched rows as (row, decode grid height,
    coordinate scale))."""
    lat, dispatches, rows = [], [], []
    for img in images:
        d0 = pred.dispatch_count
        t0 = time.perf_counter()
        packed, grid_h, scale = pred._compact_ms_dispatch(
            img, None, prm, mode=mode, fused=fused)
        rows.append((packed.cpu().numpy(), grid_h, scale))
        lat.append((time.perf_counter() - t0) * 1e3)
        dispatches.append(pred.dispatch_count - d0)
    return lat, dispatches, rows


def arm_summary(lat, dispatches, recompile_delta: int = 0) -> dict:
    return {"images": len(lat), "total_ms": float(np.sum(lat)),
            "p50_ms": float(np.median(lat)),
            "mean_ms": float(np.mean(lat)),
            "dispatches_per_image": list(dispatches),
            "median_dispatches_per_image": float(np.median(dispatches)),
            "recompile_delta": recompile_delta}


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit for bit (-0.0 differs from 0.0)."""
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def oks_ap(ref_people, det_people) -> float:
    """OKS-matched AP of one arm's decoded people against the other's
    over the COCO threshold ladder (``cli.stream_bench``'s matching),
    ``ref_people`` standing as ground truth: equal people score exactly
    1.0, and so do two empty sets (the port's copy of
    ``tools/tta_bench.py``'s ``oks_ap``)."""
    from ..stream.track import (
        _extent_area,
        _to_arrays,
        greedy_match,
        keypoint_similarity,
    )

    thresholds = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))
    tp = {t: 0 for t in thresholds}
    denom = 0
    for refs_raw, dets_raw in zip(ref_people, det_people):
        refs = [_to_arrays(kp) for kp, _ in refs_raw]
        dets = [_to_arrays(kp) for kp, _ in dets_raw]
        sim = np.zeros((len(refs), len(dets)), dtype=np.float64)
        for gi, (gxy, gvalid) in enumerate(refs):
            area = _extent_area(gxy, gvalid)
            for di, (dxy, dvalid) in enumerate(dets):
                sim[gi, di] = keypoint_similarity(gxy, gvalid, dxy,
                                                  dvalid, area=area)
        matched = [sim[gi, di] for gi, di in greedy_match(sim, 1e-6)]
        for t in thresholds:
            tp[t] += sum(1 for s in matched if s >= t)
        denom += max(len(refs), len(dets))
    if denom == 0:
        return 1.0
    return float(sum(tp[t] / denom for t in thresholds)) / len(thresholds)


def ap_parity(pred, prm, rows_f, rows_l) -> dict:
    """The fused arm's people against the looped arm's (``oks_ap``), each
    compact row decoded on the host with ``decode_compact``."""
    from ..infer.decode import decode_compact

    def people(rows):
        return [decode_compact(pred._unpack_compact(row, pred.compact_topk,
                                                    grid_h, scale),
                               prm, pred.skeleton)
                for row, grid_h, scale in rows]

    fused, looped = people(rows_f), people(rows_l)
    ap = oks_ap(looped, fused)
    return {"fused_vs_looped_oks_ap": ap,
            "people_per_image": [len(p) for p in looped],
            "equal": bool(ap == 1.0)}


def ab_report(pred, images, prm, rounds: int = 3,
              mode: str = "compact", telemetry=None) -> dict:
    """The fused-vs-looped A/B of ``prm``'s grid over ``images``: the
    parity pass, then ``rounds`` interleaved timed rounds (with none, the
    ms an image are the parity pass's, first calls included).  In the
    compact mode the report has the arms' AP parity (:func:`ap_parity`).
    Under ``telemetry`` (an ``obs.RunTelemetry``) the parity pass marks
    the run warm, each arm of a round records the first runs its
    dispatches made, and each round emits a ``tta_ab_round`` event.
    Returns the report; ``report["ok"]`` is False when a payload differs
    between the arms or an arm's dispatch count is off."""
    n_entries = len(prm.scale_search) * len(prm.rotation_search)
    lat_f, disp_f, rows_f = run_arm(pred, images, prm, True, mode)
    lat_l, disp_l, rows_l = run_arm(pred, images, prm, False, mode)
    equal = [same_bits(a[0], b[0]) for a, b in zip(rows_f, rows_l)]
    report = {"mode": mode, "images": len(images),
              "scale_search": list(prm.scale_search),
              "rotation_search": list(prm.rotation_search),
              "grid_entries": n_entries, "rounds": rounds,
              "payload_equal_per_image": equal,
              "payload_equal_all_images": all(equal),
              "fused_dispatches_per_image": disp_f,
              "looped_dispatches_per_image": disp_l}
    if mode == "compact":
        report["ap_parity"] = ap_parity(pred, prm, rows_f, rows_l)
    report["fused_ms_per_image"] = float(np.mean(lat_f))
    report["looped_ms_per_image"] = float(np.mean(lat_l))
    watch = None
    if telemetry is not None:
        telemetry.mark_warm("parity pass ran both arms over every image")
        watch = telemetry.compile_watch
    detail = []
    for r in range(rounds):
        arms = {}
        for name, fused in (("fused", True), ("looped", False)):
            c0 = watch.recompiles.value if watch is not None else 0
            lat, disp, _ = run_arm(pred, images, prm, fused, mode)
            c1 = watch.recompiles.value if watch is not None else 0
            arms[name] = arm_summary(lat, disp, int(c1 - c0))
        detail.append(arms)
        if telemetry is not None:
            telemetry.emit("tta_ab_round", round=r,
                           fused_total_ms=arms["fused"]["total_ms"],
                           looped_total_ms=arms["looped"]["total_ms"])
    report["rounds_detail"] = detail
    if detail:
        ratios = sorted(r["looped"]["total_ms"]
                        / max(r["fused"]["total_ms"], 1e-9) for r in detail)
        report["per_round_fused_speedup"] = ratios
        report["median_fused_speedup"] = statistics.median(ratios)
        report["fused_ms_per_image"] = statistics.median(
            r["fused"]["mean_ms"] for r in detail)
        report["looped_ms_per_image"] = statistics.median(
            r["looped"]["mean_ms"] for r in detail)
    report["ok"] = bool(all(equal)
                        and set(disp_f) == {1}
                        and set(disp_l) == {n_entries + 1})
    return report


def gate_verdict(report: dict, gate: float, binding: bool,
                 recompiles_post_warmup: int) -> dict:
    """The JAX tool's verdict keys on an :func:`ab_report` with rounds:
    the speedup gate (binding on the card only), the median dispatches of
    each arm over the rounds, the first runs after warmup by arm and in
    all.  Adds them to ``report`` and returns it."""
    detail = report["rounds_detail"]
    report["fused_speedup_gate"] = gate
    report["fused_speedup_gate_binding"] = binding
    report["fused_speedup_sustained"] = bool(
        report["median_fused_speedup"] >= gate)
    for arm in ("fused", "looped"):
        report[f"median_{arm}_dispatches_per_image"] = float(np.median(
            [d for r in detail for d in r[arm]["dispatches_per_image"]]))
        report[f"{arm}_arm_recompile_delta_total"] = sum(
            r[arm]["recompile_delta"] for r in detail)
    report["recompiles_post_warmup"] = int(recompiles_post_warmup)
    return report


def ab_ok(report: dict) -> bool:
    """The JAX tool's exit rule (``tools/tta_bench.py``): payloads equal,
    AP parity equal, the fused arm 1 dispatch an image, no first run after
    warmup, and the speedup gate sustained wherever it binds; and, as the
    port's tool held before, the looped arm entries + 1 dispatches an
    image."""
    return bool(report["payload_equal_all_images"]
                and report["ap_parity"]["equal"]
                and report["median_fused_dispatches_per_image"] == 1.0
                and report["median_looped_dispatches_per_image"]
                == report["grid_entries"] + 1
                and report["recompiles_post_warmup"] == 0
                and (report["fused_speedup_sustained"]
                     or not report["fused_speedup_gate_binding"]))


def grid_aps(predictor, anno: str, images_dir: str, names,
             max_images: int = 500, use_native: bool = True,
             results_dir: str = "results") -> dict:
    """{grid name: AP, AP50, AP75, AR and seconds} of ``predictor`` on the
    val set, each grid through the compact lane (``validation_oks``)."""
    from ..config import default_inference_params
    from ..infer.evaluate import validation_oks

    base, _ = default_inference_params()
    results = {}
    for name in names:
        t0 = time.perf_counter()
        metrics = validation_oks(
            predictor, anno, images_dir, max_images=max_images,
            params=dataclasses.replace(base, **GRIDS[name]),
            use_native=use_native,
            compact=True, dump_name=f"tta_{name}", results_dir=results_dir)
        entry = {k: metrics[k] for k in ("AP", "AP50", "AP75", "AR")}
        entry["seconds"] = time.perf_counter() - t0
        for k, v in GRIDS[name].items():
            entry[k] = list(v)
        results[name] = entry
        print(f"{name}: AP={metrics['AP']:.4f} ({entry['seconds']:.1f} s)",
              flush=True)
    return results


def sink_path(out: str, telemetry_sink: str):
    """The A/B's event stream: ``auto`` -> ``<out stem>_events.jsonl``,
    ``none`` (or empty) -> None, else the path itself."""
    if telemetry_sink in ("none", ""):
        return None
    if telemetry_sink == "auto":
        return os.path.splitext(out)[0] + "_events.jsonl"
    return telemetry_sink


def main(argv=None):
    ap = argparse.ArgumentParser(description="TTA grid comparison / "
                                             "fused-vs-looped grid A/B")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--anno", default=None)
    ap.add_argument("--images-dir", "--images", dest="images_dir",
                    default=None, help="val image directory (grid mode)")
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--boxsize", type=int, default=0,
                    help="0 = the config's (grid mode) or --size (--ab)")
    ap.add_argument("--grids", nargs="+", default=list(GRIDS),
                    choices=list(GRIDS))
    ap.add_argument("--out", default=GRID_OUT,
                    help=f"the artifact; {AB_OUT} under --ab")
    ap.add_argument("--results-dir", default=None,
                    help="where the per-grid detection dumps land; "
                         "default: a temp dir")
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--ab", action="store_true",
                    help="run the fused-vs-looped grid A/B on synthetic "
                         "images instead (no val set needed)")
    ap.add_argument("--num-images", type=int, default=6)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--scales", default="0.5,0.75,1.0")
    ap.add_argument("--rotations", default="0,30,-30")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--gate", type=float, default=1.3,
                    help="A/B: the median per-round speedup the fused arm "
                         "must sustain (binding on the card)")
    ap.add_argument("--planted", type=int, default=2,
                    help="A/B: plant GT-style maps of N synthetic people "
                         "(decodable payloads for the AP-parity gate; 0 "
                         "runs the bare model)")
    ap.add_argument("--telemetry-sink", default="auto",
                    help="A/B: JSONL event stream ('auto' = <out "
                         "stem>_events.jsonl, 'none' disables it)")
    args = ap.parse_args(argv)

    from . import refuse_artifact

    if args.ab:
        if args.out == GRID_OUT:
            args.out = AB_OUT
        events = sink_path(args.out, args.telemetry_sink)
        if events is not None:
            refuse_artifact(events, JAX_ARTIFACTS, flag="--telemetry-sink")
        if args.rounds < 1:
            ap.error("--rounds must be >= 1")
    refuse_artifact(args.out, JAX_ARTIFACTS)
    from .. import resolve_device

    device = resolve_device(args.device)
    if args.ab:
        raise SystemExit(0 if ab_main(args, events, device)["ok"] else 1)

    for flag in ("checkpoint", "anno", "images_dir"):
        if getattr(args, flag) is None:
            ap.error(f"--{flag.replace('_', '-')} is required in grid "
                     "mode (or pass --ab)")
    from ..obs.events import strict_dump, strict_dumps
    from . import exit_report
    from .evaluate import load_predictor

    predictor = load_predictor(args.config, args.checkpoint, device=device,
                               boxsize=args.boxsize,
                               params_dtype=args.params_dtype)
    results_dir = args.results_dir or tempfile.mkdtemp(prefix="tta_results_")
    results = grid_aps(predictor, args.anno, args.images_dir, args.grids,
                       max_images=args.max_images,
                       use_native=not args.no_native,
                       results_dir=results_dir)
    out = {"config": args.config, "checkpoint": args.checkpoint,
           "val": os.path.abspath(args.images_dir),
           "decode_path": "compact (the grid on the device)",
           "params_dtype": args.params_dtype, "device": device.type,
           "grids": results}
    with open(args.out, "w") as f:
        strict_dump(out, f, indent=2)
    print(strict_dumps({k: v["AP"] for k, v in results.items()}))
    exit_report("tta_bench", device, grids={k: v["AP"]
                                           for k, v in results.items()})


def ab_main(args, events, device) -> dict:
    """The ``--ab`` run: the planted predictor, :func:`ab_report` under
    ``obs.RunTelemetry``, the gate; writes the artifact and returns it,
    ``ok`` being :func:`ab_ok`."""
    from ..config import default_inference_params, get_config
    from ..obs import Registry, RunTelemetry
    from ..obs.events import strict_dump, strict_dumps
    from ..serve.artifacts import checkpoint_predictor
    from . import card_stamp, exit_report
    from .e2e_bench import PlantedModel, planted_maps

    boxsize = args.boxsize or args.size
    pred = checkpoint_predictor(args.config, args.checkpoint,
                                params_dtype=args.params_dtype,
                                boxsize=boxsize, device=device)
    if args.planted > 0:
        sk = get_config(args.config).skeleton
        canvas = max(int(boxsize / 0.6) + 64, 256)
        pred.model = PlantedModel(pred.model, planted_maps(
            sk, args.planted, np.random.default_rng(0), canvas=canvas), sk)
    base, _ = default_inference_params()
    prm = dataclasses.replace(
        base,
        scale_search=tuple(float(s) for s in args.scales.split(",")),
        rotation_search=tuple(float(r) for r in args.rotations.split(",")))
    images = synth_images(args.num_images, args.size,
                          np.random.default_rng(1))
    telemetry = RunTelemetry(
        events, registry=Registry(), device=device,
        run_meta={"tool": "tta_bench_ab", "config": args.config,
                  "platform": device.type})
    try:
        report = ab_report(pred, images, prm, args.rounds,
                           telemetry=telemetry)
        gate_verdict(report, args.gate, binding=device.type == "cuda",
                     recompiles_post_warmup=int(
                         telemetry.compile_watch.recompiles.value))
        report.update(config=args.config, checkpoint=args.checkpoint,
                      size=args.size, boxsize=boxsize,
                      planted_people=max(args.planted, 0),
                      params_dtype=args.params_dtype, platform=device.type,
                      telemetry_events=events, **card_stamp(device))
        report["ok"] = ab_ok(report)
        verdict = {k: report[k] for k in (
            "payload_equal_all_images", "median_fused_speedup",
            "fused_speedup_sustained", "median_fused_dispatches_per_image",
            "recompiles_post_warmup")}
        verdict["ap_parity_equal"] = report["ap_parity"]["equal"]
        telemetry.emit("tta_ab_verdict", **verdict)
    finally:
        telemetry.close()
    with open(args.out, "w") as f:
        strict_dump(report, f, indent=2)
    print(strict_dumps({**verdict, "fused_ms_per_image":
                        report["fused_ms_per_image"],
                        "looped_ms_per_image": report["looped_ms_per_image"],
                        "ok": report["ok"]}))
    exit_report("tta_bench", device, ok=report["ok"])
    return report


if __name__ == "__main__":
    main()
