"""Test-time-augmentation grids on one checkpoint, and the fused-vs-looped
grid A/B (``--ab``) -- the port's counterpart of ``tools/tta_bench.py``::

    python -m improved_body_parts_torch.cli.tta_bench --config synth \\
        --checkpoint ckpt/epoch_1 --anno person_keypoints_synth.json \\
        --images val/ --boxsize 128 --device cpu --out TTA.json

Grid mode scores the checkpoint under each named grid (:data:`GRIDS`,
the reference's TTA surface: scale_search x rotation x flip, reference:
evaluate.py:87-96) with the OKS evaluator on the compact lane, the grid
running on the device, and writes AP and wall seconds per grid.

``--ab`` compares the grid's two dispatch forms (``Predictor.fused_tta``)
on synthetic images, over the checkpoint's model or a seeded init: a
parity pass (untimed, it also warms both) holds the fused and looped
packed rows equal bit for bit on every image and reads each arm's
dispatches per image from ``Predictor.dispatch_count`` (1 fused,
entries + 1 looped); then ``--rounds`` rounds each run a fused and a
looped arm over the same images, every row fetched to the host, so
drift on the host hits both arms of a round alike; the verdict is the
median per-round looped / fused time.  It exits 1 when a payload differs
or a dispatch count is off.

Both modes write one strict JSON artifact (``--out``) and run on
``--device cuda`` unless asked for ``cpu``.  ``chip_smoke.py`` calls
:func:`ab_report` in its process.
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
    dispatches an image, the fetched rows)."""
    lat, dispatches, rows = [], [], []
    for img in images:
        d0 = pred.dispatch_count
        t0 = time.perf_counter()
        packed, _, _ = pred._compact_ms_dispatch(img, None, prm, mode=mode,
                                                 fused=fused)
        rows.append(packed.cpu().numpy())
        lat.append((time.perf_counter() - t0) * 1e3)
        dispatches.append(pred.dispatch_count - d0)
    return lat, dispatches, rows


def arm_summary(lat, dispatches) -> dict:
    return {"images": len(lat), "total_ms": float(np.sum(lat)),
            "p50_ms": float(np.median(lat)),
            "mean_ms": float(np.mean(lat)),
            "dispatches_per_image": list(dispatches),
            "median_dispatches_per_image": float(np.median(dispatches))}


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit for bit (-0.0 differs from 0.0)."""
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def ab_report(pred, images, prm, rounds: int = 3,
              mode: str = "compact") -> dict:
    """The fused-vs-looped A/B of ``prm``'s grid over ``images``: the
    parity pass, then ``rounds`` interleaved timed rounds (with none, the
    ms an image are the parity pass's, first calls included).  Returns
    the report; ``report["ok"]`` is False when a payload differs between
    the arms or an arm's dispatch count is off."""
    n_entries = len(prm.scale_search) * len(prm.rotation_search)
    lat_f, disp_f, rows_f = run_arm(pred, images, prm, True, mode)
    lat_l, disp_l, rows_l = run_arm(pred, images, prm, False, mode)
    equal = [same_bits(a, b) for a, b in zip(rows_f, rows_l)]
    report = {"mode": mode, "images": len(images),
              "scale_search": list(prm.scale_search),
              "rotation_search": list(prm.rotation_search),
              "grid_entries": n_entries, "rounds": rounds,
              "payload_equal_per_image": equal,
              "payload_equal_all_images": all(equal),
              "fused_dispatches_per_image": disp_f,
              "looped_dispatches_per_image": disp_l}
    report["fused_ms_per_image"] = float(np.mean(lat_f))
    report["looped_ms_per_image"] = float(np.mean(lat_l))
    detail = []
    for _ in range(rounds):
        lat_f, d_f, _ = run_arm(pred, images, prm, True, mode)
        lat_l, d_l, _ = run_arm(pred, images, prm, False, mode)
        detail.append({"fused": arm_summary(lat_f, d_f),
                       "looped": arm_summary(lat_l, d_l)})
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


def main(argv=None):
    ap = argparse.ArgumentParser(description="TTA grid comparison / "
                                             "fused-vs-looped grid A/B")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--anno", default=None)
    ap.add_argument("--images-dir", "--images", dest="images_dir",
                    default=None, help="val image directory (grid mode)")
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--boxsize", type=int, default=0)
    ap.add_argument("--grids", nargs="+", default=list(GRIDS),
                    choices=list(GRIDS))
    ap.add_argument("--out", default="TTA.json")
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
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..config import default_inference_params
    from ..obs.events import strict_dump, strict_dumps
    from ..serve.artifacts import checkpoint_predictor
    from . import exit_report

    device = resolve_device(args.device)
    if args.ab:
        if args.out == "TTA.json":
            args.out = "TTA_AB.json"
        if args.rounds < 1:
            ap.error("--rounds must be >= 1")
        pred = checkpoint_predictor(args.config, args.checkpoint,
                                    params_dtype=args.params_dtype,
                                    boxsize=args.boxsize or args.size,
                                    device=device)
        base, _ = default_inference_params()
        prm = dataclasses.replace(
            base,
            scale_search=tuple(float(s) for s in args.scales.split(",")),
            rotation_search=tuple(float(r)
                                  for r in args.rotations.split(",")))
        images = synth_images(args.num_images, args.size,
                              np.random.default_rng(1))
        report = ab_report(pred, images, prm, args.rounds)
        report.update(config=args.config, checkpoint=args.checkpoint,
                      size=args.size, params_dtype=args.params_dtype,
                      device=device.type)
        with open(args.out, "w") as f:
            strict_dump(report, f, indent=2)
        print(strict_dumps({k: report.get(k) for k in (
            "payload_equal_all_images", "median_fused_speedup",
            "fused_ms_per_image", "looped_ms_per_image", "ok")}))
        exit_report("tta_bench", device, ok=report["ok"])
        raise SystemExit(0 if report["ok"] else 1)

    for flag in ("checkpoint", "anno", "images_dir"):
        if getattr(args, flag) is None:
            ap.error(f"--{flag.replace('_', '-')} is required in grid "
                     "mode (or pass --ab)")
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


if __name__ == "__main__":
    main()
