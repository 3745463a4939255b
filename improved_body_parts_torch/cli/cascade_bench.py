"""Cascade serving against teacher-only serving on a mixed easy / hard
stream (the port's counterpart of ``tools/cascade_bench.py``)::

    python -m improved_body_parts_torch.cli.cascade_bench \\
        --student-config canonical_student --teacher-config canonical \\
        --size 512 --out cascade_bench_torch.json

The protocol is the JAX tool's:

- both tiers run their real forwards (the student ``--student-config``,
  the teacher ``--teacher-config``, each from a seeded init) behind
  :class:`TieredPlantedModel`, a flip-aware planted-maps shim: each
  lane's input brightness selects, on the device, an easy planted crowd
  (``--easy-people``) or a hard one (``--hard-people``), so the hard
  frames decode to more people than ``--max-people`` and the cascade's
  ``EscalationPolicy`` escalates exactly them;
- ``--clients`` closed-loop clients drive a stream of 16 frames, a
  ``--hard-frac`` share of them bright (hard); rounds alternate a
  cascade slice and a teacher-only slice (``DynamicBatcher(...,
  device_decode=True)`` over the teacher), and the verdict is the
  median per-round imgs/s ratio, so drift on the host hits both arms of
  a round alike;
- the quality gate: every unique image decoded once by each arm and
  scored with ``infer.oks.evaluate_oks`` against the planted ground
  truth; the cascade's AP must be within ``--ap-tol`` (relative) of
  teacher-only's.  Both tiers plant the same maps, so the gate holds the
  serving layer (escalation loses nobody), not the student's quality;
- warmup runs every batch of both tiers first (``CascadeEngine.warmup``),
  and the artifact records the first runs after it
  (``obs.RunTelemetry``'s compile watch), which must be 0.

The artifact (``--out``, default ``cascade_bench_torch.json``; the JAX
tool's ``CASCADE_BENCH.json`` is refused before any work) is strict JSON
with the JAX tool's keys plus the card's name and power limit
(``cli.card_stamp``).  The tool exits 0 whatever the verdict, as the JAX
tool does: the verdict lives in the artifact.  It runs on ``--device
cuda`` unless asked for ``cpu``.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from .e2e_bench import STICK_LAYOUT

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("CASCADE_BENCH.json",)

#: frames in the mixed stream (the JAX tool's)
N_STREAM = 16


def plant_people(skeleton, n_people, rng, canvas):
    """Stride-grid maps of ``n_people`` planted stick people and their
    COCO-order ground truth (the quality gate's side), equal array for
    array to ``tools/cascade_bench.py``'s on the same ``rng``.
    Coordinates are canvas px: the bench runs at ``boxsize == size ==
    canvas``, so detections come back in the same space."""
    import dataclasses

    from ..data.heatmapper import Heatmapper

    sk = dataclasses.replace(skeleton, width=canvas, height=canvas)
    joints = np.zeros((n_people, sk.num_parts, 3), np.float32)
    joints[:, :, 2] = 2
    region = canvas * 0.86
    xs = np.linspace(0.18, 0.82, n_people) * region
    for p in range(n_people):
        cx = xs[p] + rng.uniform(-4, 4)
        scale = rng.uniform(0.42, 0.52) * region
        y0 = rng.uniform(0.02, 0.12) * region
        for name, dx, dy in STICK_LAYOUT:
            joints[p, sk.parts_dict[name]] = [cx + dx * scale,
                                              y0 + dy * scale, 1]
    maps = Heatmapper(sk).create_heatmaps(
        joints, np.ones(sk.grid_shape, np.float32)).astype(np.float32)

    gts = []
    for p in range(n_people):
        kp = np.zeros((17, 3), np.float64)
        for di, gi in skeleton.dt_gt_mapping.items():
            if gi is None:
                continue
            kp[gi] = [joints[p, di, 0], joints[p, di, 1], 2.0]
        xs_v, ys_v = kp[kp[:, 2] > 0, 0], kp[kp[:, 2] > 0, 1]
        area = float((xs_v.max() - xs_v.min()) * (ys_v.max() - ys_v.min()))
        gts.append({"keypoints": kp, "area": max(area, 1.0)})
    return maps, gts


def make_images(size, n_each, rng):
    """(easy images, hard images): dark and bright BGR uint8 frames, the
    stream's difficulty carrier (``tools/cascade_bench.py``'s, equal on
    the same ``rng``)."""
    easy = [rng.integers(0, 50, (size, size, 3)).astype(np.uint8)
            for _ in range(n_each)]
    hard = [rng.integers(205, 255, (size, size, 3)).astype(np.uint8)
            for _ in range(n_each)]
    return easy, hard


class TieredPlantedModel(torch.nn.Module):
    """Wraps the real network: each lane's output is the easy or the hard
    planted maps, chosen by the mean brightness of the lane's input on
    the device, plus 1e-3 x the network's last-stack output, so the
    whole forward still runs while the maps hold decodable people, and
    the hard frames carry a crowd the escalation policy fires on.

    The predictor's lanes are [image..., mirror...]; the mirror lanes get
    the width-flipped, channel-permuted maps, so the flip merge gives
    back the planted people at full amplitude.  The input is the
    predictor's (N, H, W, 3) image in [0, 1], as the JAX package's
    predictor feeds its model, so ``bright_thresh`` picks the same lanes
    in both packages (a flip keeps the mean, so lane i and its mirror
    N + i agree)."""

    def __init__(self, model, easy_maps, hard_maps, skeleton,
                 bright_thresh: float = 0.5):
        super().__init__()
        self.model = model
        self.bright_thresh = bright_thresh
        self.num_layers = skeleton.num_layers
        self.perm = (list(skeleton.flip_paf_ord)
                     + [skeleton.heat_start + i
                        for i in skeleton.flip_heat_ord])
        dev = next(model.parameters()).device
        self.register_buffer("easy", torch.from_numpy(easy_maps).to(dev))
        self.register_buffer("hard", torch.from_numpy(hard_maps).to(dev))

    def planted(self, imgs: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(2N, h, w, C): each lane's planted maps, as :meth:`forward`
        adds them to the network's output."""
        if self.easy.shape[0] < h or self.easy.shape[1] < w:
            raise ValueError("planted canvas smaller than the model grid; "
                             "raise the canvas")
        e = self.easy[:h, :w, :self.num_layers]
        hd = self.hard[:h, :w, :self.num_layers]
        em, hm = e.flip(1)[..., self.perm], hd.flip(1)[..., self.perm]
        bright = (imgs.mean(dim=(1, 2, 3)) > self.bright_thresh
                  )[:, None, None, None]
        n = imgs.shape[0] // 2
        return torch.cat([torch.where(bright[:n], hd[None], e[None]),
                          torch.where(bright[n:], hm[None], em[None])],
                         dim=0)

    def forward(self, imgs):
        out = self.model(imgs)[-1][0].float()
        return [[self.planted(imgs, out.shape[1], out.shape[2])
                 + 1e-3 * out]]


def stream_layout(hard_frac: float, n_stream: int = N_STREAM) -> list:
    """Which of the stream's frames are hard: ``round(hard_frac x
    n_stream)`` of them (at least 1), spread evenly (a Bresenham
    interleave, so every client's closed loop sees the mix)."""
    n_hard = max(1, round(hard_frac * n_stream))
    return [(i + 1) * n_hard // n_stream > i * n_hard // n_stream
            for i in range(n_stream)]


def slice_indices(n_clients: int, requests: int, n_stream: int) -> list:
    """The stream indices one closed-loop slice submits: client ``c``'s
    ``i``-th request takes frame ``(c + i * n_clients) % n_stream``."""
    return [(c + i * n_clients) % n_stream
            for c in range(n_clients) for i in range(requests)]


def run_clients(n_clients, requests, work_fn):
    """``n_clients`` threads each calling ``work_fn(client, i)``
    ``requests`` times; (wall s, every request's latency s).  A client's
    error is raised after all threads joined."""
    latencies = [[] for _ in range(n_clients)]
    errors = []

    def client(cid):
        try:
            for i in range(requests):
                t0 = time.perf_counter()
                work_fn(cid, i)
                latencies[cid].append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, [v for lat in latencies for v in lat]


def run_slice(submit, stream, n_clients, requests):
    """One closed-loop slice: ``submit(image) -> Future``; sheds retry
    through ``serve.policy.submit_with_retry`` and are reported, not
    failed."""
    from ..serve import submit_with_retry

    retries = [0]
    lock = threading.Lock()

    def work(cid, i):
        img = stream[(cid + i * n_clients) % len(stream)]
        fut, n = submit_with_retry(submit, img, base_s=0.002, max_s=0.05)
        if n:
            with lock:
                retries[0] += n
        fut.result()

    wall, lats = run_clients(n_clients, requests, work)
    total = n_clients * requests
    lats.sort()
    return {"imgs_per_sec": round(total / wall, 3),
            "p95_ms": round(lats[int(0.95 * (len(lats) - 1))] * 1e3, 2),
            "shed_retries": retries[0]}


def tiered_predictor(cfg, easy_maps, hard_maps, size, device):
    """A ``Predictor`` of ``cfg``'s model from the seeded init, behind
    :class:`TieredPlantedModel`, at ``boxsize == size``."""
    from ..config import InferenceModelParams
    from ..infer import Predictor
    from ..models import build_model

    model = build_model(cfg, device=device, seed=0)
    planted = TieredPlantedModel(model, easy_maps, hard_maps, cfg.skeleton)
    return Predictor(planted, cfg.skeleton,
                     model_params=InferenceModelParams(boxsize=size,
                                                       max_downsample=64),
                     bucket=64, device=device)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--student-config", default="synth_deep_student",
                    help="the fast tier (the default pairs the 2-stack "
                         "quarter-width student with the 4-stack synth_deep "
                         "teacher; tiny_student / tiny is the seconds-scale "
                         "pair, canonical_student / canonical the published "
                         "width)")
    ap.add_argument("--teacher-config", default="synth_deep")
    ap.add_argument("--size", type=int, default=256,
                    help="frame H = W; also the planted canvas and the "
                         "boxsize, so GT and detections share one "
                         "coordinate space")
    ap.add_argument("--hard-frac", type=float, default=0.25,
                    help="share of the stream that is hard (bright -> a "
                         "crowd above the escalation threshold)")
    ap.add_argument("--easy-people", type=int, default=2)
    ap.add_argument("--hard-people", type=int, default=6)
    ap.add_argument("--max-people", type=int, default=4,
                    help="EscalationPolicy.max_people, the threshold "
                         "between the planted easy and hard crowds")
    ap.add_argument("--score-floor", type=float, default=0.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8,
                    help="closed-loop requests per client per slice")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=30.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--ap-tol", type=float, default=0.03,
                    help="largest relative AP deficit of the cascade "
                         "against teacher-only")
    ap.add_argument("--target-ratio", type=float, default=1.3,
                    help="the imgs/s claim: the median cascade / "
                         "teacher-only round ratio the artifact tests")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="cascade_bench_torch.json")
    return ap


def main(argv=None) -> dict:
    """Run the bench and write the artifact; returns its document."""
    args = _parser().parse_args(argv)

    from . import card_stamp, refuse_artifact

    refuse_artifact(args.out, JAX_ARTIFACTS)
    from .. import resolve_device
    from ..config import get_config
    from ..infer import evaluate_oks
    from ..obs import Registry, RunTelemetry
    from ..obs.events import strict_dump, strict_dumps
    from ..serve import (
        CascadeEngine,
        DynamicBatcher,
        EscalationPolicy,
        ServeMetrics,
    )

    device = resolve_device(args.device)
    print(f"platform={device.type}", flush=True)
    s_cfg = get_config(args.student_config)
    t_cfg = get_config(args.teacher_config)
    if s_cfg.skeleton != t_cfg.skeleton:
        raise SystemExit("the cascade's tiers must share the skeleton")
    sk = s_cfg.skeleton
    rng = np.random.default_rng(0)
    size = args.size

    easy_maps, easy_gt = plant_people(sk, args.easy_people, rng, size)
    hard_maps, hard_gt = plant_people(sk, args.hard_people, rng, size)
    student = tiered_predictor(s_cfg, easy_maps, hard_maps, size, device)
    teacher = tiered_predictor(t_cfg, easy_maps, hard_maps, size, device)

    easy_imgs, hard_imgs = make_images(size, 4, rng)
    stream, e_i, h_i = [], 0, 0
    for is_hard in stream_layout(args.hard_frac):
        if is_hard:
            stream.append(hard_imgs[h_i % len(hard_imgs)])
            h_i += 1
        else:
            stream.append(easy_imgs[e_i % len(easy_imgs)])
            e_i += 1

    telemetry = RunTelemetry(
        None, registry=Registry(), device=device,
        run_meta={"tool": "cascade_bench", "platform": device.type})
    policy = EscalationPolicy(max_people=args.max_people,
                              score_floor=args.score_floor)
    batcher_kw = dict(max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue)
    sizes = [(size, size)]

    report = {
        "platform": device.type,
        "student_config": args.student_config,
        "teacher_config": args.teacher_config,
        "size": size, "hard_frac_requested": args.hard_frac,
        "hard_frac_stream": round(h_i / len(stream), 3),
        "easy_people": args.easy_people, "hard_people": args.hard_people,
        "policy": {"max_people": args.max_people,
                   "score_floor": args.score_floor,
                   "escalate_on_overflow": True},
        "clients": args.clients,
        "requests_per_slice": args.clients * args.requests,
        "rounds": args.rounds,
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
        **card_stamp(device),
        "note": "Interleaved rounds, median per-round ratio. Both tiers "
                "run their real forwards behind a flip-aware planted-maps "
                "shim whose per-lane brightness select makes hard frames "
                "decode to a crowd above max_people; both tiers plant the "
                "same maps, so the AP gate holds the serving layer "
                "(escalation loses nobody), not the student's quality. "
                "The two tiers share one card and one host.",
    }

    def flush():
        with open(args.out, "w") as f:
            strict_dump(report, f, indent=2)

    cascade = CascadeEngine.build(student, teacher, policy=policy,
                                  registry=telemetry.registry, **batcher_kw)
    teacher_only = DynamicBatcher(teacher,
                                  metrics=ServeMetrics(model="teacher_only"),
                                  registry=telemetry.registry,
                                  device_decode=True, **batcher_kw)
    try:
        with cascade, teacher_only:
            warm = cascade.warmup(sizes)
            warm_t = teacher_only.warmup(sizes)
            telemetry.mark_warm("cascade + teacher-only warmup")
            report["warmup"] = {
                "student_newly_compiled": warm["student"]["newly_compiled"],
                "teacher_newly_compiled": warm["teacher"]["newly_compiled"],
                "teacher_only_newly_compiled": warm_t["newly_compiled"]}

            # interleaved throughput rounds
            cas_rounds, tea_rounds = [], []
            for r in range(args.rounds):
                cas = run_slice(cascade.submit, stream, args.clients,
                                args.requests)
                tea = run_slice(teacher_only.submit, stream, args.clients,
                                args.requests)
                cas_rounds.append(cas)
                tea_rounds.append(tea)
                print(f"round {r}: cascade {cas['imgs_per_sec']} vs "
                      f"teacher-only {tea['imgs_per_sec']} imgs/s",
                      flush=True)
            # the routing snapshot before the quality pass: the escalation
            # rate describes the served stream, not the half-easy /
            # half-hard set of unique images the AP gate decodes
            snap = cascade.metrics.snapshot()
            tiers = {"student": cascade.student.metrics.snapshot(),
                     "teacher": cascade.teacher.metrics.snapshot(),
                     "teacher_only": teacher_only.metrics.snapshot()}
            report["hops_ms"] = {k: v["hops_ms"] for k, v in tiers.items()}
            report["hop_conservation_frac"] = {
                k: tiers[k]["hop_conservation_frac"]
                for k in ("student", "teacher_only")}

            # the quality gate: each unique image decoded by both arms
            gts, det_cascade, det_teacher = {}, {}, {}
            for img_id, im in enumerate(easy_imgs + hard_imgs):
                gts[img_id] = hard_gt if im.mean() > 127 else easy_gt
                det_cascade[img_id] = cascade.submit(im).result(timeout=120)
                det_teacher[img_id] = teacher_only.submit(im).result(
                    timeout=120)
            ap_c = evaluate_oks(gts, det_cascade)["AP"]
            ap_t = evaluate_oks(gts, det_teacher)["AP"]
            rel = abs(ap_c - ap_t) / max(ap_t, 1e-9)
            report["quality"] = {
                "cascade_synthetic_ap": round(ap_c, 4),
                "teacher_only_synthetic_ap": round(ap_t, 4),
                "rel_diff": round(rel, 4), "tolerance": args.ap_tol,
                "within_tolerance": bool(rel <= args.ap_tol)}
            flush()
            print(f"quality: cascade AP {ap_c:.4f} vs teacher-only "
                  f"{ap_t:.4f} (rel {rel:.4f})", flush=True)

        ratios = sorted(c["imgs_per_sec"] / t["imgs_per_sec"]
                        for c, t in zip(cas_rounds, tea_rounds))
        median_ratio = ratios[len(ratios) // 2]
        report.update({
            "cascade_imgs_per_sec": [r["imgs_per_sec"] for r in cas_rounds],
            "teacher_only_imgs_per_sec": [r["imgs_per_sec"]
                                          for r in tea_rounds],
            "cascade_p95_ms": cas_rounds[-1]["p95_ms"],
            "teacher_only_p95_ms": tea_rounds[-1]["p95_ms"],
            "shed_retries_total": sum(r["shed_retries"]
                                      for r in cas_rounds + tea_rounds),
            "per_round_ratio": [round(r, 3) for r in ratios],
            "median_round_ratio": round(median_ratio, 3),
            "target_ratio": args.target_ratio,
            "cascade_beats_target": bool(median_ratio >= args.target_ratio),
            "cascade_routing": snap,
            # submitted == answered_student + escalated_teacher +
            # degraded_student_answer + failed + depth, at this instant
            "cascade_conservation": cascade.metrics.conservation(),
            "escalation_rate": snap["escalation_rate"],
            "recompiles_post_warmup": int(
                telemetry.compile_watch.recompiles.value),
        })
    finally:
        telemetry.close()
    flush()
    print(strict_dumps({
        "median_round_ratio": report["median_round_ratio"],
        "cascade_beats_target": report["cascade_beats_target"],
        "escalation_rate": report["escalation_rate"],
        "ap_within_tolerance": report["quality"]["within_tolerance"],
        "cascade_conservation_exact":
            report["cascade_conservation"]["exact"],
        "recompiles_post_warmup": report["recompiles_post_warmup"]}))
    return report


if __name__ == "__main__":
    main()
