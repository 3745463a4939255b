"""End-to-end inference FPS of the port: network forward plus full decode
to skeletons, in every inference mode (the port's counterpart of
``tools/e2e_bench.py``)::

    python -m improved_body_parts_torch.cli.e2e_bench --images 30 \\
        --planted 3 --out e2e_bench_torch.json

The modes (``--modes``, a comma-separated subset; all by default):

1. ``full``: ``Predictor.predict`` (the host full-map protocol, single
   scale + flip) and the host decode;
2. ``fast``: ``predict_fast`` (NMS on the device, decode at the scaled
   resolution);
3. ``pipelined``: ``pipelined_inference`` (forward N+1 overlaps the
   threaded decode of N);
4. ``compact``, ``compact-pipelined``, ``compact-batch``:
   ``predict_compact`` (peak records and limb candidates from the device;
   the host assembles), alone, pipelined, and ``--batch`` images a
   dispatch;
5. ``device-decode``, ``device-decode-batch``: the fused lane
   (``predict_decoded``: forward, ``topk_peaks``, ``limb_pair_stats`` and
   ``greedy_assemble`` on the card; the host looks up coordinates), alone
   and ``--batch`` images a dispatch.  ``--device-decode`` runs only
   these two.

A seeded init has near-empty maps, so ``--planted N`` adds N synthetic
people's ground-truth maps to the network's output (:class:`PlantedModel`:
the whole forward still runs, so the device time is the real one) and
the decode gets a trained-model-like workload.  Every timing window ends
in a read back to the host and a device sync.  The artifact (``--out``,
default ``e2e_bench_torch.json``; the JAX tool's ``E2E_BENCH.json`` is
refused) has the JAX tool's keys, plus ``device`` and ``power_limit``
(the card's name and ``nvidia-smi`` limit) and ``precision`` (TF32 and
autocast).  It runs on ``--device cuda`` unless asked for ``cpu``.

This module also holds the synthetic fixtures the other tools share, as
the JAX package's tools import them from ``tools/e2e_bench.py``:
:func:`synth_images`, :func:`planted_maps` (and :func:`plant`, which also
returns the planted joints) and :class:`PlantedModel`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("E2E_BENCH.json",)

MODES = ("full", "fast", "pipelined", "compact", "compact-pipelined",
         "compact-batch", "device-decode", "device-decode-batch")

#: the reference's end-to-end rates (reference: README.md:68, 121)
REFERENCE_FPS = {"python_assignment": 5.2, "cpp_rebuild_e2e": "7-8"}


def synth_images(n: int, size: int, rng) -> list:
    """BGR uint8 images with mild structure (blobs over a dark noise
    floor), as the JAX tools draw them."""
    imgs = []
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(n):
        img = rng.integers(0, 60, (size, size, 3)).astype(np.uint8)
        for _ in range(rng.integers(2, 5)):
            cx, cy = rng.integers(size // 8, 7 * size // 8, 2)
            r = rng.integers(size // 16, size // 6)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
            img = np.clip(img + (blob[..., None] * 180), 0, 255
                          ).astype(np.uint8)
        imgs.append(img)
    return imgs


#: the stick figure of the planted people: each part's (dx, dy) offset
#: from the figure's anchor, in units of its height (``cli.cascade_bench``
#: plants the same figure)
STICK_LAYOUT = (("nose", 0, 0.12), ("neck", 0, 0.21), ("Rsho", -0.09, 0.22),
                ("Lsho", 0.09, 0.22), ("Relb", -0.13, 0.33),
                ("Lelb", 0.13, 0.33), ("Rwri", -0.14, 0.43),
                ("Lwri", 0.14, 0.43), ("Rhip", -0.05, 0.45),
                ("Lhip", 0.05, 0.45), ("Rkne", -0.06, 0.59),
                ("Lkne", 0.06, 0.59), ("Rank", -0.06, 0.72),
                ("Lank", 0.06, 0.72), ("Reye", -0.02, 0.10),
                ("Leye", 0.02, 0.10), ("Rear", -0.04, 0.11),
                ("Lear", 0.04, 0.11))


def plant(skeleton, n_people, rng, canvas=1024):
    """(joints, maps) of N synthetic stick people: joints (N, num_parts,
    3) in canvas px, and their stride-grid GT maps (the data pipeline's
    own ``Heatmapper``) plus 1e-6 of noise.  People land in the top-left
    60% of the canvas, which must cover the predictor's padded input."""
    from ..data.heatmapper import Heatmapper

    sk = dataclasses.replace(skeleton, width=canvas, height=canvas)
    joints = np.zeros((n_people, sk.num_parts, 3), np.float32)
    joints[:, :, 2] = 2
    region = canvas * 0.6
    for p in range(n_people):
        cx = rng.uniform(0.2, 0.8) * region
        scale = rng.uniform(0.5, 0.8) * region
        y0 = rng.uniform(0.0, 0.2) * region
        for name, dx, dy in STICK_LAYOUT:
            joints[p, sk.parts_dict[name]] = [cx + dx * scale,
                                              y0 + dy * scale, 1]
    maps = Heatmapper(sk).create_heatmaps(
        joints, np.ones(sk.grid_shape, np.float32))
    return joints, (maps + rng.uniform(0, 1e-6, maps.shape)
                    ).astype(np.float32)


def planted_maps(skeleton, n_people, rng, canvas=1024):
    """The maps of :func:`plant` (``tools/e2e_bench.py``'s
    ``planted_maps``, equal array for array on the same rng)."""
    return plant(skeleton, n_people, rng, canvas)[1]


class PlantedModel:
    """Wraps the real network: output = planted GT maps + 1e-3 × the
    real last-stack output, so the full forward still runs while the maps
    hold decodable people.  The predictor's lanes are [image...,
    mirror...]; the mirror lanes get the width-flipped, channel-permuted
    maps, so the flip merge gives back the planted people at full
    amplitude."""

    def __init__(self, model, maps, skeleton):
        import torch

        self.model = model
        dev = next(model.parameters()).device
        self.maps = torch.from_numpy(maps).to(dev)
        self.perm = (list(skeleton.flip_paf_ord)
                     + [skeleton.paf_layers + i
                        for i in skeleton.flip_heat_ord])
        self.num_layers = skeleton.num_layers

    def __getattr__(self, name):
        if name == "model":      # not set yet: a copy being made
            raise AttributeError(name)
        return getattr(self.model, name)

    def to(self, device):
        """The wrapper on ``device`` (a serving replica's deep copy is
        moved so)."""
        self.model = self.model.to(device)
        self.maps = self.maps.to(device)
        return self

    def __call__(self, imgs):
        import torch

        out = self.model(imgs)[-1][0].float()
        n2, h, w, _ = out.shape
        if self.maps.shape[0] < h or self.maps.shape[1] < w:
            raise ValueError("planted canvas smaller than the model grid; "
                             "raise the canvas")
        m = self.maps[:h, :w, :self.num_layers]
        mirror = m.flip(1)[..., self.perm]
        n = n2 // 2
        return [[torch.cat([m[None] + 1e-3 * out[:n],
                            mirror[None] + 1e-3 * out[n:]], dim=0)]]


def planted_gap(skeleton, people, joints) -> float:
    """Largest keypoint error in px of the decoded ``people`` (a list of
    (COCO keypoints, score)) against the planted ``joints`` ((N,
    num_parts, 2+) in image px), each planted person matched to its
    nearest decoded one; inf when the counts differ."""
    if len(people) != len(joints):
        return float("inf")
    worst = 0.0
    for person in joints:
        want = {gt: person[dt, :2]
                for dt, gt in skeleton.dt_gt_mapping.items()
                if gt is not None}
        errs = [max(float(np.hypot(kps[gt][0] - xy[0], kps[gt][1] - xy[1]))
                    for gt, xy in want.items())
                for kps, _ in people]
        worst = max(worst, min(errs))
    return worst


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--images", type=int, default=30)
    ap.add_argument("--decode-workers", type=int, default=2)
    ap.add_argument("--out", default="e2e_bench_torch.json")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated subset of sections to run")
    ap.add_argument("--device-decode", action="store_true",
                    help="run ONLY the fused device-decode sections "
                         "(forward, peaks, limbs and greedy assembly on "
                         "the card), sequential and batched-pipelined")
    ap.add_argument("--batch", type=int, default=8,
                    help="chunk size of the batch modes")
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32"],
                    help="weight storage; auto = bf16 on the card, fp32 on "
                         "the CPU")
    ap.add_argument("--planted", type=int, default=0,
                    help="plant GT-style maps for N synthetic people into "
                         "the model output (realistic decode workload)")
    ap.add_argument("--boxsize", type=int, default=0,
                    help="override InferenceModelParams.boxsize (0 = the "
                         "default protocol); the planted canvas scales "
                         "with it (1.6 x boxsize, 1024 px by default).  "
                         "Set it to the image size to keep CPU runs small")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None, decoded=None) -> dict:
    """Run the modes and write the artifact; returns its document.  When
    ``decoded`` is a dict, each mode's people per image land in it under
    the mode's name, and with ``--planted`` the planted joints in image
    px under ``"planted_joints"`` (what :func:`planted_gap` holds them
    to) and the planted maps under ``"planted_maps"``."""
    args = _parser().parse_args(argv)
    modes = ({"device-decode", "device-decode-batch"} if args.device_decode
             else set(args.modes.split(",")))
    unknown = modes - set(MODES)
    if unknown:
        raise SystemExit(f"--modes: unknown {sorted(unknown)}; pick from "
                         f"{', '.join(MODES)}")

    from .. import resolve_device
    from ..config import get_config
    from ..obs.events import strict_dump, strict_dumps
    from ..serve.artifacts import checkpoint_predictor
    from . import card_stamp, precision_stamp, refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    print(f"platform={device.type}", flush=True)
    cfg = get_config(args.config)
    rng = np.random.default_rng(0)
    imgs = synth_images(args.images, args.size, rng)
    pred = checkpoint_predictor(args.config, None,
                                params_dtype=args.params_dtype,
                                boxsize=args.boxsize, device=device)
    if args.planted > 0:
        # people land in the canvas' top-left 55%, inside the resized
        # image's boxsize px
        canvas = int(1.6 * args.boxsize) if args.boxsize else 1024
        joints, maps = plant(cfg.skeleton, args.planted, rng, canvas)
        pred.model = PlantedModel(pred.model, maps, cfg.skeleton)
        if decoded is not None:
            # the predictor resizes the image to boxsize rows; the maps'
            # canvas px are the resized image's px
            decoded["planted_joints"] = (joints[..., :2] * args.size
                                         / pred.model_params.boxsize)
            decoded["planted_maps"] = maps
    if decoded is None:
        decoded = {}

    report = {"platform": device.type, "config": args.config,
              "size": args.size, "images": args.images,
              "planted_people": max(args.planted, 0),
              "reference_fps": REFERENCE_FPS,
              **card_stamp(device), "precision": precision_stamp(pred.model)}

    def flush():
        with open(args.out, "w") as f:
            strict_dump(report, f, indent=2)

    run = dict(pred=pred, imgs=imgs, sk=cfg.skeleton, args=args,
               report=report, flush=flush, decoded=decoded, device=device)
    if "full" in modes:
        run_full(**run)
    if "fast" in modes:
        run_fast(**run)
    if "pipelined" in modes:
        run_pipelined(**run)
    if modes & {"compact", "compact-pipelined", "compact-batch"}:
        run_compact_modes(modes=modes, **run)
    if modes & {"device-decode", "device-decode-batch"}:
        run_device_decode_modes(modes=modes, **run)
    flush()
    print(strict_dumps(report))
    return report


def _timed(device, fn):
    """(seconds, fn's value): the window ends in a device sync."""
    from . import sync

    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def run_full(pred, imgs, sk, args, report, flush, decoded, device):
    from ..infer.decode import decode

    pred.predict(imgs[0])  # the first run of the shape

    def loop():
        out = []
        for im in imgs:
            heat, paf = pred.predict(im)
            out.append(decode(heat, paf, pred.params, sk))
        return out

    dt, decoded["full"] = _timed(device, loop)
    dt /= len(imgs)
    report["full_path_fps"] = round(1.0 / dt, 2)
    report["full_path_ms"] = round(dt * 1e3, 1)
    flush()
    n_dec = sum(len(p) for p in decoded["full"])
    print(f"full ensemble+decode: {1.0 / dt:.2f} FPS "
          f"({dt * 1e3:.0f} ms/img, {n_dec} detections)", flush=True)


def run_fast(pred, imgs, sk, args, report, flush, decoded, device):
    from ..infer.decode import decode

    pred.predict_fast(imgs[0])  # the first run of the shape

    def loop():
        out = []
        for im in imgs:
            heat, paf, mask, scale = pred.predict_fast(im)
            out.append(decode(heat, paf, pred.params, sk, peak_mask=mask,
                              coord_scale=scale))
        return out

    dt, decoded["fast"] = _timed(device, loop)
    dt /= len(imgs)
    report["fast_path_fps"] = round(1.0 / dt, 2)
    flush()
    print(f"fast path: {1.0 / dt:.2f} FPS", flush=True)


def run_pipelined(pred, imgs, sk, args, report, flush, decoded, device):
    from ..infer.pipeline import pipelined_inference

    dt, decoded["pipelined"] = _timed(device, lambda: list(
        pipelined_inference(pred, imgs,
                            decode_workers=args.decode_workers)))
    dt /= len(imgs)
    report["pipelined_fps"] = round(1.0 / dt, 2)
    report["decode_workers"] = args.decode_workers
    flush()
    print(f"pipelined: {1.0 / dt:.2f} FPS", flush=True)


def run_compact_modes(pred, imgs, sk, args, report, flush, decoded, device,
                      modes):
    from ..infer.pipeline import compact_decode_fn, pipelined_inference

    # the same transparent fallback as pipelined_inference: an overflow
    # of the device records re-runs the image on the full-map path
    decode_one = compact_decode_fn(pred)

    def run_compact(im):
        return decode_one(pred.predict_compact(im), im)

    if modes & {"compact", "compact-pipelined"}:
        run_compact(imgs[0])  # the first run (batch mode warms its own)
    if "compact" in modes:
        dt, decoded["compact"] = _timed(
            device, lambda: [run_compact(im) for im in imgs])
        dt /= len(imgs)
        report["compact_fps"] = round(1.0 / dt, 2)
        flush()
        print(f"compact: {1.0 / dt:.2f} FPS", flush=True)

    if "compact-pipelined" in modes:
        dt, decoded["compact-pipelined"] = _timed(device, lambda: list(
            pipelined_inference(pred, imgs,
                                decode_workers=args.decode_workers,
                                compact=True)))
        dt /= len(imgs)
        report["compact_pipelined_fps"] = round(1.0 / dt, 2)
        report["decode_workers"] = args.decode_workers
        flush()
        print(f"compact pipelined: {1.0 / dt:.2f} FPS", flush=True)

    if "compact-batch" in modes:
        # throughput mode: N images + mirrors a dispatch, pipelined
        b = args.batch
        list(pipelined_inference(pred, imgs[:b],
                                 decode_workers=args.decode_workers,
                                 compact_batch=b))
        dt, decoded["compact-batch"] = _timed(device, lambda: list(
            pipelined_inference(pred, imgs,
                                decode_workers=args.decode_workers,
                                compact_batch=b)))
        dt /= len(imgs)
        report["compact_batch_fps"] = round(1.0 / dt, 2)
        report["compact_batch"] = b
        flush()
        print(f"compact batch({b}) pipelined: {1.0 / dt:.2f} FPS",
              flush=True)


def run_device_decode_modes(pred, imgs, sk, args, report, flush, decoded,
                            device, modes):
    """The fused lane: forward, compact extraction and greedy assembly on
    the card; the host finishes with an O(people) id→coordinate lookup,
    falling back one level per overflow class
    (``infer.pipeline.device_decode_fn``)."""
    from ..infer.pipeline import device_decode_fn, pipelined_inference

    finish = device_decode_fn(pred)

    if "device-decode" in modes:
        finish(pred.predict_decoded(imgs[0]), imgs[0])  # the first run

        def loop():
            out, fused = [], 0
            for im in imgs:
                res = pred.predict_decoded(im)
                fused += bool(res.ok)
                out.append(finish(res, im))
            return out, fused

        dt, (decoded["device-decode"], fused) = _timed(device, loop)
        dt /= len(imgs)
        report["device_decode_fps"] = round(1.0 / dt, 2)
        report["device_decode_fused"] = fused
        report["device_decode_host_fallback"] = len(imgs) - fused
        flush()
        print(f"device-decode: {1.0 / dt:.2f} FPS "
              f"({fused}/{len(imgs)} fused)", flush=True)

    if "device-decode-batch" in modes:
        b = args.batch
        list(pipelined_inference(pred, imgs[:b],
                                 decode_workers=args.decode_workers,
                                 compact_batch=b, device_decode=True))
        dt, decoded["device-decode-batch"] = _timed(device, lambda: list(
            pipelined_inference(pred, imgs,
                                decode_workers=args.decode_workers,
                                compact_batch=b, device_decode=True)))
        dt /= len(imgs)
        report["device_decode_batch_fps"] = round(1.0 / dt, 2)
        report["device_decode_batch"] = b
        flush()
        print(f"device-decode batch({b}) pipelined: {1.0 / dt:.2f} FPS",
              flush=True)


if __name__ == "__main__":
    main()
