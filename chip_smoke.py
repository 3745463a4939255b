#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: the serve lane, training, the
learn->AP loop and the accuracy tiers of inference.

    python3 chip_smoke.py

Run from the root of a checkout.  The phases print in this order, and any
failed phase ends the run with a non-zero exit code:

1. card: ``nvidia-smi`` name and power limit, the device name, and a check
   that the card is Hopper (compute capability 9.0);
2. build: ``nvcc`` builds every kernel of ``improved_body_parts_torch/csrc``
   for sm_90a (set-up time);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card.  The decode kernels at the serve lane's shapes (batch 8,
   640x896 maps, 18 keypoint channels, K=64, 30 limbs, M=128) with planted
   sparse peaks, and on dense noise that takes topk_peaks' rare paths (a
   band that keeps more than K, a channel that keeps more than the select
   block's buffer) and gives limb_pair_stats segments of all 20 samples,
   and at the sizes the lane does not compile for (17 channels, radius 1,
   12 samples): integer outputs exactly, topk_peaks' and limb_pair_stats'
   floats bit for bit.  All three decode kernels again, bit for bit, at
   the batcher's other shapes on planted people: batch 1 of 640x896 and
   of 640x512 (its singleton flushes of either bucket) and batch 8 of
   640x512.  The fused greedy assembly on the lane's planted
   peaks and candidates and on random dense records (K=64, M=128, 30
   limbs), at p_max 32, 1 (a full table) and 64 and with remove_recon 1:
   every field bit for bit, with the longest chain's walk steps and
   connections.  The focal-loss kernels at the canonical training shapes
   (4 stacks, batch 4, the 5 scales 128^2..8^2, 50 channels) on sparse GT
   and on a case planted on the kink: the forward within rel 1e-5 and the
   same bits in two runs, the backward bit for bit.  Median times of
   kernel (CUDA events around the wrapper call) and plain version, and
   each kernel's device time apart from its wrapper (torch.profiler over
   20 calls; topk_peaks by pass, beside what reading its maps' slices
   alone takes; focal_fwd by scale);
4. planted serve: a stub network that returns planted people's maps, a few
   requests of different sizes through ``Predictor.predict_decoded_batch``
   and ``decode_device``; every planted person decodes, keypoints within
   1 px, and the fused assembly kernel launched;
5. full width: the ``canonical`` IMHN (4 stacks, 128,998,760 parameters)
   from a seeded init in bf16 autocast, ``predict_decoded_batch`` on 8
   images of 480x640 (the 640x896 bucket).  The decode kernels' launch
   counters are set to 0 just before this run and read just after; every
   decode kernel must have launched.  Then ``predict_decoded_batch_async``
   must return with its device work still queued (an event recorded as
   it returns has not completed): no read back to the host before
   ``resolve()``;

Between phases 5 and 6, the batcher (``serve.DynamicBatcher``, the
entry point users serve through): on phase 4's planted maps, 12
requests from 3 client threads over two buckets through the fused lane
(every planted person within 1 px, ``decode_fused`` 12, every decode
kernel launched), then each fallback level forced: a 2-person table
under 3 people (host ``decode_compact`` of the compact records, with the
native decoder) and top-K 2 (``predict_fast``'s full maps); then at full
width on phase 5's ``canonical`` model: warmup of the 640x896 and
640x512 buckets, 64 requests from 4 threads (max_batch 8, max_wait_ms
25, max_queue 64) with the decode kernels' counters set to 0 just before
and read just after (each must have launched), 0 failed or rejected,
a request record (``obs.reqtrace``, every request sampled) with the five
hops for each request, and the hops of all requests summing to their
e2e latencies within 1 us; it prints imgs/s, p50/p99 e2e, mean
occupancy, each hop's p50 and the dispatcher's host ms per batch; then
8 requests through the host-pool lane (``device_decode=False``).  What
the batcher's threads left on the card (their cuBLAS workspaces) is
released before phase 6, so phase 6's peak memory is its own;

6. training at full width: ``canonical`` in train mode from a seeded init,
   bf16 autocast, SGD; drawn synthetic people through the port's
   ``Transformer`` + ``Heatmapper`` (augmented, 512x512, batch 4, uint8
   wire) into ``make_train_step`` + ``train_epoch``: 2 warm-up steps, then
   10 timed steps with the focal kernels' counters set to 0 just before
   and read just after (5 launches a step each).  Losses finite, params
   and BN running stats moved, every step counted;
7. learn->AP at full width: the protocol of ``cli.synth_ap`` at
   ``CANONICAL_TRAIN.json``'s settings (``synth_canonical``: the flagship
   IMHN, 128,998,760 parameters, remat on, bf16 autocast; 32 drawn
   training images on a 288x384 canvas at a 192x192 input, batch 2, 18
   epochs, seed 0; 12 held-out val images, seed 12345), in this process
   and through the CLIs' own functions: the card machine has no h5py, so
   the training records stay in memory (``data.fixture.fixture_records`` +
   ``data.MemoryDataset``, the records ``build_fixture`` would write) and
   the CLIs' HDF5 path is tested on the CPU only.  ``cli.train.train``
   trains with the async ``CheckpointManager``; the checkpoint of epoch
   16, which had epoch 17's in-place steps run during its write, must
   hold the state_dict and momentum SHA-256 taken as its save returned;
   the last committed checkpoint, restored by
   ``cli.evaluate.load_predictor``, must have the trained model's
   state_dict SHA-256 and the same fused-lane payload on one val image;
   ``validation_oks`` scores it on the fused lane and on the compact lane,
   and the untrained init (``cli.synth_ap.save_fresh_checkpoint``) on the
   fused lane.  Then, after the counts are read, each kernel is held to
   its plain version at this phase's own shapes, with phase 3's
   tolerances: the focal kernels on the five calls of the first training
   step, as the loss made them, and the decode kernels on the first val
   image's ensembled maps, as the fused lane decoded them.  It prints
   train imgs/s, the median step, each save's blocked and writer ms, the
   loss curve, the APs, the device and the five kernels' launches, and
   fails unless the trained AP is at least 0.5, the untrained AP at most
   0.05, last/first loss at most 0.2, the two lanes' APs within 0.01 and
   every kernel launched;
8. accuracy tiers, on phase 7's last committed checkpoint and val set:
   (a) the scale x rotation grids single-scale, scale_search (0.8, 1.0,
   1.2), rotation_search (0, 30, -30) and their product, on the trained
   ``synth_canonical`` built by ``serve.artifacts.checkpoint_predictor``:
   for each grid, the fused and looped grid dispatches on every val
   image in the compact and decode modes (``cli.tta_bench.ab_report``),
   payloads equal bit for bit, 1 dispatch an image fused and entries + 1
   looped, ms an image of each; the OKS AP of each grid on the compact
   lane, and of the multi-scale grid on the fused decode lane with the
   decode kernels' counters set to 0 just before and read just after
   (each must have launched); the host full-map protocol
   (``process_image`` with neither flag) on the multi-scale grid, its AP
   and ``Predictor.predict``'s ms an image; how often each overflow
   fallback was taken.  Gates: multi-scale AP >= 0.5, host protocol AP >=
   0.5.  (b) the three decode kernels bit for bit against their plain
   versions on the first val image's multi-scale mean maps, as the lane
   decoded them, and on planted people at (1, 768, 1151, 50), the mean
   grid of a 427x640 image at that scale grid and boxsize 640, whose
   width is no multiple of 32 (valid = the whole map), each timed as in
   phase 3.  (c) ``canonical`` (seeded init, boxsize 640) on one 427x640
   image through the fused multi-scale grid and ``Predictor.predict``:
   ms an image and peak device memory; ``predict_decoded_async`` with
   the grid makes no synchronizing call (torch's sync debug mode set to
   error around it: no read back to the host before ``resolve()``).  (d) the dtype matrix: the
   trained checkpoint at fp32, bf16 and int8, the fused-lane AP on phase
   7's 12 val images and on 48 of the same seed (the 12 and 36 more), the
   stored bytes of each, and ``canonical``'s ``predict_decoded_batch``
   imgs/s at batch 8 of 480x640 at each dtype.  Gates: the fp32 AP on the
   12 equal to phase 7's, |AP(int8) - AP(bf16)| <= 0.01 on the 48 (on 24
   people one OKS match moves AP by ~0.004), int8 bytes <= 0.35 x fp32.  A ``[8 accuracy tiers]`` summary line closes the phase.
9. the rest of training at full width.  (a) variants: each of
   ``imhn_independent``, ``imhn_light``, ``imhn_wide`` (3 stacks), ``ae``
   and ``imhn_final`` (``final_384``) at published width from a seeded
   init in bf16 autocast, its parameter count checked; one
   ``predict_decoded_batch`` at batch 2 of 480x640 (every decode kernel
   must launch); 2 warm-up and 3 timed train steps at its config's input
   (``final_384`` 384^2 batch 8, the others 512^2 batch 4) on phase 6's
   drawn people, the focal counters set to 0 before the timed steps and
   equal to scales x steps after; ms a step, imgs/s and peak memory; the
   focal kernels held to their plain versions on the first timed step's
   calls at ``ae``'s single scale and ``final_384``'s five (forward rel
   1e-5, backward bit for bit), and their device ms a step at those
   shapes, the inputs rotated over copies 3x the L2 so each call reads
   HBM, beside the bound of those shapes' own bytes.  (b) GT made on the
   device, through the ring: on phase 6's people at 512^2 batch 4, the
   card's labels against the host ``Heatmapper``'s (max abs <= 1e-4);
   then ``cli.train.train`` (``canonical``, one epoch of 12 steps on
   phase 6's records, ``pipeline="shm"``, 4 spawn workers over
   ``MemoryDataset`` records, ``device_gt`` 16, a validation set so the
   eval ring runs, under a ``RunSupervisor`` so the rings are the
   supervised ones): its ``device_prefetch`` feeds the steps; the focal
   counts, the step ms, the data wait ms a step and imgs/s come from its
   report, beside the bytes a batch on the wire and phase 6's sync
   figures.  (c) distillation: ``cli.train.train(teacher=...)`` of
   ``canonical_student`` at 512^2 batch 4 (one epoch of 12 steps, a
   validation set) from a seeded ``canonical`` teacher (eval): 10 focal
   launches a step each way (and 5 forward an eval batch), the
   checkpoint's losses finite, the teacher's ``state_dict`` SHA-256 unchanged.  (d) SWA: 2 epochs of
   ``cli.train.train(swa=True, swa_freq=2)`` resumed from phase 7's last
   checkpoint: BN running stats bit for bit the checkpoint's,
   ``swa_count`` 2, the SWA fields equal after a save and restore, and
   the averaged weights' OKS AP on phase 7's 12 val images (fused lane)
   beside phase 7's, gated at >= 0.5.  (e) supervisor: a supervised
   ``cli.train.train`` (``synth_canonical``, 2 epochs, 16 of phase 7's
   records) asked to stop inside epoch 1, then a second segment that
   resumes from the committed epoch 0 and reaches the target: 2 segments
   in ``RUN.json``, the step count that of an unstopped run; and the
   card's own out-of-memory error (a 64 TiB allocation) classified
   transient.

Then one JSON line with every kernel's numbers (``launches`` are phase
7's learn->AP run: the focal kernels in its training, the decode kernels
in the fused-lane evaluation of its checkpoint; the other paths' counts
stand beside them in ``launches_by_path``, phase 8's multi-scale grid as
``grid``, phase 9's paths as ``variants``, ``device_gt``, ``distill``
and ``swa``; the focal kernels' device ms a step at ``ae``'s and
``final_384``'s shapes as ``ae_shape_device_ms`` and
``final_384_shape_device_ms`` (inputs rotated past the L2), with
``*_same_inputs_ms``, ``*_bound_ms`` and ``*_bound_by`` beside them; the decode kernels' times at phase 8's grid shape as
``grid_shape_ms`` and ``grid_shape_device_ms``), the time every phase took,
the ``nvidia-smi`` line again, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, the script exits non-zero and prints
no result.  Every number it prints is measured on the card in this run.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, HEIGHT, WIDTH = 8, 640, 896          # the serve lane's bucket
TOPK, RADIUS, SAMPLES = 64, 2, 20
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                      # H100 SXM, outside tensor cores
FLOAT_TOL = 1e-5
# the __global__ kernels each wrapper launches, by source, for device_ms
PEAKS_PASSES = ("peaks_nms_kernel", "peaks_select_kernel")
LIMBS_PASSES = ("limb_pair_stats_kernel",)
ASSEMBLY_PASSES = ("greedy_assemble_kernel",)
P_MAX = 32                                  # the lane's person table
# the batcher's other decode shapes: (batch, bucket height, bucket width,
# valid width of a 480x640 or a 640x480 image) -- singleton flushes of
# either bucket and a full batch of the narrow one
BUCKET_SHAPES = ((1, HEIGHT, WIDTH, 853), (1, HEIGHT, 512, 480),
                 (BATCH, HEIGHT, 512, 480))
# phase 7: CANONICAL_TRAIN.json's learn->AP protocol
SYNTH_AP = dict(config="synth_canonical", train_images=32, val_images=12,
                canvas=(288, 384), epochs=18, seed=0, val_seed=12345)
# phase 8: the grids of the accuracy tiers, the mean grid of a 427x640
# image at scale_search (0.8, 1.0, 1.2) and boxsize 640, and that image
PHASE8_GRIDS = (("single_scale", {}),
                ("multi_scale", {"scale_search": (0.8, 1.0, 1.2)}),
                ("rotation_pm30", {"rotation_search": (0.0, 30.0, -30.0)}),
                ("ms_rot_pm30", {"scale_search": (0.8, 1.0, 1.2),
                                 "rotation_search": (0.0, 30.0, -30.0)}))
GRID_SHAPE = (768, 1151)
SERVE_IMAGE = (427, 640)
DTYPE_VAL_IMAGES = 48     # the dtype matrix's gate: phase 7's val seed
FOCAL_FWD_PASSES = ("focal_fwd",)
FOCAL_BWD_PASSES = ("focal_bwd",)

# internal part order of the canonical skeleton, unit-box positions of a
# standing person (x across, y down, facing the camera)
UNIT_POSE = {
    "nose": (0.50, 0.10), "neck": (0.50, 0.25),
    "Rsho": (0.35, 0.25), "Relb": (0.30, 0.42), "Rwri": (0.28, 0.58),
    "Lsho": (0.65, 0.25), "Lelb": (0.70, 0.42), "Lwri": (0.72, 0.58),
    "Rhip": (0.40, 0.55), "Rkne": (0.40, 0.75), "Rank": (0.40, 0.95),
    "Lhip": (0.60, 0.55), "Lkne": (0.60, 0.75), "Lank": (0.60, 0.95),
    "Reye": (0.45, 0.07), "Leye": (0.55, 0.07),
    "Rear": (0.40, 0.09), "Lear": (0.60, 0.09),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each
    call; a call that reads back to the host is timed to its end)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernels, launches_a_call: int = 1, calls: int = 20,
              windows: int = 3, required: bool = True):
    """Device time of ``fn()`` apart from the host work around it:
    ``torch.profiler`` over ``calls`` back-to-back calls, the CUDA time of
    each kernel named in ``kernels`` (the ``__global__`` names of one
    source) over the launches recorded, times ``launches_a_call``.
    Returns {kernel: ms a call}.  The profiler can drop the first kernel
    of its window, so a marker kernel runs first; now and then it records
    no device activity at all in a window, so a window that misses a
    kernel is profiled again, up to ``windows`` times, and the
    measurement fails only when every window missed it -- or, with
    ``required=False`` (a time the kernels line does not carry), gives
    None for that kernel: not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pats = {k: re.compile(rf"(^|\W){k}($|\W)") for k in kernels}
    for window in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(kernels, 0.0)
        seen = dict.fromkeys(kernels, 0)
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for k, pat in pats.items():
                if pat.search(e.name):
                    us[k] += e.time_range.elapsed_us()
                    seen[k] += 1
        missed = [k for k in kernels if seen[k] == 0]
        if not missed:
            return {k: us[k] / seen[k] * launches_a_call / 1e3
                    for k in kernels}
        print(f"[device_ms] profiler window {window} of {windows} recorded "
              f"no launch of {', '.join(missed)} in {calls} calls",
              flush=True)
    if required:
        fail(f"device_ms: the profiler recorded no launch of "
             f"{', '.join(missed)} in {windows} windows of {calls} calls")
    print(f"[device_ms] {', '.join(missed)}: not measured", flush=True)
    return {k: None if k in missed else us[k] / seen[k] * launches_a_call
            / 1e3 for k in kernels}


def person_joints(sk, x0: float, y0: float, height: float) -> np.ndarray:
    """(num_parts, 2) image coordinates of one planted person."""
    width = 0.5 * height
    return np.array([[x0 + UNIT_POSE[p][0] * width,
                      y0 + UNIT_POSE[p][1] * height] for p in sk.parts],
                    np.float32)


def planted_grid_maps(sk, people, h4: int, w4: int, device):
    """Stride-4 (h4, w4, num_layers) maps of ``people`` (a list of
    (num_parts, 2) image-pixel joints): a Gaussian per keypoint, a
    Gaussian ridge along each limb.  Grid cell (i, j) sits at image pixel
    (4j + 1.5, 4i + 1.5), where the x4 cubic upsample puts it."""
    import torch

    stride = sk.stride
    ys = torch.arange(h4, device=device, dtype=torch.float32)
    xs = torch.arange(w4, device=device, dtype=torch.float32)
    gy = (ys * stride + (stride - 1) / 2)[:, None]            # (h4, 1)
    gx = (xs * stride + (stride - 1) / 2)[None, :]            # (1, w4)
    maps = torch.zeros((h4, w4, sk.num_layers), device=device)
    sig_kp, sig_limb = 7.0, 5.0
    for joints in people:
        j = torch.as_tensor(joints, device=device)
        for c in range(sk.num_parts):
            d2 = (gx - j[c, 0]) ** 2 + (gy - j[c, 1]) ** 2
            ch = sk.heat_start + c
            maps[..., ch] = torch.maximum(
                maps[..., ch], torch.exp(-d2 / (2 * sig_kp ** 2)))
        for li, (a, b) in enumerate(sk.limbs_conn):
            ax, ay = j[a]
            vx, vy = j[b, 0] - ax, j[b, 1] - ay
            t = (((gx - ax) * vx + (gy - ay) * vy)
                 / (vx * vx + vy * vy)).clamp(0, 1)
            d2 = (gx - ax - t * vx) ** 2 + (gy - ay - t * vy) ** 2
            maps[..., li] = torch.maximum(
                maps[..., li], torch.exp(-d2 / (2 * sig_limb ** 2)))
    return maps


class MirrorStub:
    """Stands in for the network: returns fixed stride-4 maps cropped to
    the input size on the image lanes and their exact mirror (width flip +
    channel permutation) on the mirror lanes, so the flip merge returns
    the planted maps unchanged."""

    def __init__(self, sk, maps):
        self.maps = maps
        self.perm = (list(sk.flip_paf_ord)
                     + [sk.paf_layers + i for i in sk.flip_heat_ord])

    def __call__(self, imgs):
        import torch

        n, h, w, _ = imgs.shape
        m = self.maps[:h // 4, :w // 4]
        mirror = m.flip(1)[..., self.perm]
        half = n // 2
        return [[torch.stack([m] * half + [mirror] * half)]]


def planted_error(sk, people, planted, label: str) -> float:
    """Largest keypoint error in px of the decoded ``people`` (a list of
    (COCO keypoints, score)) against the ``planted`` joints, each planted
    person matched to its nearest decoded one; fails unless every person
    decodes, each keypoint within 1 px."""
    check(len(people) == len(planted), f"{label}: decoded {len(people)} "
          f"people, planted {len(planted)}")
    worst = 0.0
    for joints in planted:
        want = {gt: joints[dt] for dt, gt in sk.dt_gt_mapping.items()
                if gt is not None}
        errs = [max(np.hypot(kps[gt][0] - xy[0], kps[gt][1] - xy[1])
                    for gt, xy in want.items())
                for kps, _ in people]
        worst = max(worst, min(errs))
    check(worst <= 1.0, f"{label}: planted keypoints off by {worst:.3f} px")
    return worst


def compare(name, got, want, int_fields, tol=FLOAT_TOL):
    """Max abs error of ``got`` vs ``want`` (equal-length tuples); integer
    and bool fields must match exactly, floats within ``tol`` (0: bit for
    bit)."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{name}: output {i} shape "
              f"{tuple(g.shape)} != {tuple(w.shape)}")
        if i in int_fields:
            check(torch.equal(g.to(w.dtype), w),
                  f"{name}: integer output {i} differs from the plain "
                  f"version in {int((g.to(w.dtype) != w).sum())} places")
        else:
            err = float((g - w).abs().max()) if g.numel() else 0.0
            check(np.isfinite(err) and err <= tol
                  and (tol > 0 or torch.equal(g, w)),
                  f"{name}: float output {i} off by {err}")
            worst = max(worst, err)
    return worst


def read_floor_ms(kp) -> float:
    """Device time of ``peaks_read_probe`` (``csrc/peaks.cu``) over the
    keypoint slice ``kp``: every pixel's channel slice read once, coalesced,
    nothing computed -- what the NMS pass's reads alone cost on this card
    for this layout (profiler, 20 launches)."""
    import ctypes

    import torch

    from improved_body_parts_torch.ops import _build

    n, h, w, c = kp.shape
    check(kp.stride(3) == 1 and kp.stride(1) == w * kp.stride(2)
          and kp.stride(0) == h * kp.stride(1),
          "read probe: the keypoint slice's pixels are not evenly strided")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("peaks", "ibp_peaks_read_probe", (p, i, i, i, p, p))
    sink = torch.zeros(1, device=kp.device)

    def run():
        _build.check(fn(kp.data_ptr(), n * h * w, kp.stride(2), c,
                        sink.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "peaks_read_probe")

    return device_ms(run, ("peaks_read_probe",))["peaks_read_probe"]


def dense_cases(sk, dev, gen, valid_h, valid_w, kw_pk, kw_st):
    """Phase 3's rare paths at the lane's shapes: keypoint maps of uniform
    noise keep about a ninth of their pixels, so every NMS band keeps more
    than K (the in-band sort) and every channel more than the select
    block's buffer (the merge in rounds); limb endpoints spread over the
    whole map make almost every segment take all S samples.  Each kernel
    is held to its plain version: integers exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_peaks

    noise = torch.rand((BATCH, HEIGHT, WIDTH, sk.num_layers), device=dev,
                       generator=gen)
    kp = noise[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = noise[..., :sk.paf_layers]
    got = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    want = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    compare("topk_peaks (dense)", got, want, {0, 1, 5, 6}, tol=0.0)
    least, most = int(want[6].min()), int(want[6].max())
    check(least > 4096, f"topk_peaks (dense): a channel keeps only {least} "
          "peaks, too few for the merge in rounds")
    shape = (BATCH, sk.num_parts, TOPK)
    x_ref = torch.rand(shape, device=dev, generator=gen) * (WIDTH - 1)
    y_ref = torch.rand(shape, device=dev, generator=gen) * (HEIGHT - 1)
    got = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref, **kw_st)
    want = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw_st)
    torch.cuda.synchronize()
    compare("limb_pair_stats (dense)", got, want, {1, 2}, tol=0.0)
    full = float((want[2] == SAMPLES).float().mean())
    check(full > 0.99, f"limb_pair_stats (dense): only {full:.2%} of the "
          f"pairs take all {SAMPLES} samples")
    print(f"[3 kernels] dense noise: topk_peaks keeps {least}..{most} peaks "
          f"a channel (in-band sort, merge in rounds), limb_pair_stats takes "
          f"{SAMPLES} samples in {full:.2%} of {want[2].numel()} pairs; "
          "both equal to their plain versions bit for bit")


def generic_cases(kp, paf, x_ref, y_ref, valid_h, valid_w, kw_pk, kw_st):
    """The instantiations the serve lane does not take, on its maps: 17
    keypoint channels (the generic NMS copy path, an odd channel count)
    with radius 1 (the generic refinement), and 12 limb samples (the
    generic sample loop).  Each is held to its plain version: integers
    exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_peaks

    kw = dict(kw_pk, radius=1)
    sub = kp[..., :17]
    got = cuda_peaks.topk_peaks_kernel(sub, valid_h, valid_w, **kw)
    want = cuda_peaks.topk_peaks_plain(sub, valid_h, valid_w, **kw)
    kw = dict(kw_st, num_samples=12)
    got_st = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref, **kw)
    want_st = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw)
    torch.cuda.synchronize()
    compare("topk_peaks (C=17, r=1)", got, want, {0, 1, 5, 6}, tol=0.0)
    compare("limb_pair_stats (S=12)", got_st, want_st, {1, 2}, tol=0.0)
    print("[3 kernels] generic instantiations: topk_peaks at C=17, r=1 and "
          "limb_pair_stats at S=12 equal to their plain versions bit for bit")


def random_records(sk, dev, rng, limbs_from, limbs_to):
    """Batch-8 peak and candidate records at the lane's sizes (K = 64,
    M = 128, 30 limbs), drawn as ``tests/test_assembly.py``
    ``_rand_records`` draws them: candidates point only at valid peaks, in
    rank-descending prior order, validity a prefix; dense, so every channel
    keeps 40..64 peaks and about half the limbs fill all M slots."""
    import torch

    from improved_body_parts_torch.ops.peaks import LimbCandidates, TopKPeaks

    c, k, m, n_limbs = sk.num_parts, TOPK, 2 * TOPK, len(limbs_from)
    counts = rng.integers(40, k + 1, (BATCH, c)).astype(np.int32)
    valid = np.zeros((BATCH, c, k), bool)
    score = rng.uniform(0.1, 1.0, (BATCH, c, k)).astype(np.float32)
    x_ref = rng.uniform(0, WIDTH - 1, (BATCH, c, k)).astype(np.float32)
    y_ref = rng.uniform(0, HEIGHT - 1, (BATCH, c, k)).astype(np.float32)
    shape = (BATCH, n_limbs, m)
    slot_a, slot_b = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    prior, norm = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    cvalid = np.zeros(shape, bool)
    ccount = np.zeros(shape[:2], np.int32)
    for i in range(BATCH):
        for ch in range(c):
            valid[i, ch, rng.permutation(k)[:counts[i, ch]]] = True
        for li, (ia, ib) in enumerate(zip(limbs_from, limbs_to)):
            a, b = np.nonzero(valid[i, ia])[0], np.nonzero(valid[i, ib])[0]
            pairs = np.stack(np.meshgrid(a, b, indexing="ij"), -1)
            pairs = rng.permutation(pairs.reshape(-1, 2))
            n = m if rng.uniform() < 0.5 else int(rng.integers(0, m + 1))
            sa, sb = pairs[:n, 0], pairs[:n, 1]
            slot_a[i, li, :n], slot_b[i, li, :n] = sa, sb
            prior[i, li, :n] = np.sort(rng.uniform(0.05, 2.0, n))[::-1]
            norm[i, li, :n] = np.hypot(x_ref[i, ia, sa] - x_ref[i, ib, sb],
                                       y_ref[i, ia, sa] - y_ref[i, ib, sb])
            cvalid[i, li, :n] = True
            ccount[i, li] = len(pairs)

    def on(a):
        return torch.from_numpy(a).to(dev)

    xs, ys = np.rint(x_ref).astype(np.int32), np.rint(y_ref).astype(np.int32)
    peaks = TopKPeaks(on(xs), on(ys), on(x_ref), on(y_ref), on(score),
                      on(valid), on(counts))
    cands = LimbCandidates(on(slot_a), on(slot_b), on(prior), on(norm),
                           on(cvalid), on(ccount))
    return peaks, cands


def chain_length(peaks, cands, limbs_from, limbs_to):
    """(walk steps, connections) of the longest image's chain, then of the
    whole batch: per limb the candidates the walk examines (to the first
    invalid one, or to the connection that reaches the limit) and the
    connections it takes."""
    import torch

    from improved_body_parts_torch.ops.cuda_assembly import (
        candidate_walk_plain,
    )

    k = peaks.valid.shape[-1]
    n_peaks = torch.clamp(peaks.count, max=k).long()
    limit = torch.minimum(n_peaks[:, list(limbs_from)],
                          n_peaks[:, list(limbs_to)])
    sel = candidate_walk_plain(cands.slot_a, cands.slot_b, cands.valid,
                               limit, k).long()
    m_cap = sel.shape[-1]
    taken = sel.sum(-1)
    last = (sel * torch.arange(1, m_cap + 1, device=sel.device)).amax(-1)
    prefix = torch.cumprod(cands.valid.long(), -1).sum(-1)
    steps = torch.where(limit == 0, 0,
                        torch.where(taken >= limit, last, prefix))
    steps, taken = steps.sum(-1), taken.sum(-1)
    i = int(torch.argmax(steps + taken))
    return int(steps[i]), int(taken[i]), int(steps.sum()), int(taken.sum())


def assembly_args(sk, params) -> dict:
    """The serve lane's keyword arguments of ``greedy_assemble``."""
    return dict(limbs_from=tuple(a for a, _ in sk.limbs_conn),
                limbs_to=tuple(b for _, b in sk.limbs_conn),
                num_parts=sk.num_parts, p_max=P_MAX,
                len_rate=params.len_rate,
                connection_tole=params.connection_tole,
                remove_recon=params.remove_recon,
                min_parts=params.min_parts,
                min_mean_score=params.min_mean_score)


def hold_decode(sk, maps, valid_h, valid_w, kw_pk, kw_st, kw_asm,
                connect_ration, label, smi, tag="[3 kernels]"):
    """The three decode kernels on one batch of ensembled maps, as the
    lane calls them: ``topk_peaks`` and ``limb_pair_stats`` against their
    plain versions, then ``greedy_assemble`` on the candidates ranked from
    those records; integers exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    pk = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    got = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    compare(f"topk_peaks ({label})", got, pk, {0, 1, 5, 6}, tol=0.0)
    st = cuda_peaks.limb_pair_stats_plain(paf, pk[2], pk[3], **kw_st)
    got = cuda_peaks.limb_pair_stats_kernel(paf, pk[2], pk[3], **kw_st)
    torch.cuda.synchronize()
    compare(f"limb_pair_stats ({label})", got, st, {1, 2}, tol=0.0)
    peaks = TopKPeaks(*pk)
    cands = limb_topk_from_stats(
        PairStats(*st), peaks, valid_h, limbs_from=kw_asm["limbs_from"],
        limbs_to=kw_asm["limbs_to"], connect_ration=connect_ration,
        m_cap=2 * kw_pk["k"])
    want = cuda_assembly.greedy_assemble_plain(peaks, cands, **kw_asm)
    got = cuda_assembly.greedy_assemble_kernel(peaks, cands, **kw_asm)
    torch.cuda.synchronize()
    compare(f"greedy_assemble ({label})", got, want, {1, 2, 3, 4, 5},
            tol=0.0)
    people = int(want[2].sum())
    check(people > 0, f"greedy_assemble ({label}): no person assembled")
    print(f"{tag} {label}: "
          f"{int(torch.clamp(pk[6], max=kw_pk['k']).sum())} kept peaks, "
          f"{int(st[2].sum())} limb samples, "
          f"{int(cands.valid.sum())} accepted candidates, {people} "
          "people; topk_peaks, limb_pair_stats and greedy_assemble "
          f"equal to their plain versions bit for bit [{smi}]")


def lane_kwargs(sk, thre1, spec):
    """``topk_peaks``', ``limb_pair_stats``' and ``greedy_assemble``'s
    keyword arguments, and connect_ration, of a fused-lane spec."""
    (thre2, mid_num, radius, topk, connect_ration), asm = spec
    limbs = dict(limbs_from=tuple(a for a, _ in sk.limbs_conn),
                 limbs_to=tuple(b for _, b in sk.limbs_conn))
    return (dict(thre=thre1, k=topk, radius=radius),
            dict(limbs, num_samples=mid_num, thre2=thre2),
            dict(limbs, num_parts=sk.num_parts,
                 **dict(zip(("p_max", "len_rate", "connection_tole",
                             "remove_recon", "min_parts", "min_mean_score"),
                            asm))),
            connect_ration)


def hold_lane_call(sk, call, label, smi, tag):
    """:func:`hold_decode` on one captured ``Predictor.decode_maps`` call
    (maps, valid_h, valid_w, thre1, spec), as the lane made it."""
    maps, valid_h, valid_w, thre1, spec = call
    hold_decode(sk, maps, valid_h, valid_w, *lane_kwargs(sk, thre1, spec),
                f"{label} {tuple(maps.shape)}, valid "
                f"{int(valid_h[0])}x{int(valid_w[0])}", smi, tag=tag)


def bucket_cases(sk, dev, params, kw_pk, kw_st, smi):
    """Phase 3's decode kernels at the batcher's other shapes
    (``BUCKET_SHAPES``), each on planted people plus noise as at the
    lane's batch of 8 (seeded apart, so the later phases draw as
    before), through :func:`hold_decode`."""
    import torch

    from improved_body_parts_torch.infer.resize import upsample_cubic

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    kw_asm = assembly_args(sk, params)
    for n, h, w, valid in BUCKET_SHAPES:
        grid = torch.stack([planted_grid_maps(
            sk, [person_joints(sk, x0, rng.uniform(20, 120),
                               rng.uniform(260, 480))
                 for x0 in rng.uniform(0, valid - 260, 3)],
            h // 4, w // 4, dev) for _ in range(n)])
        grid = grid + 0.01 * torch.randn(grid.shape, device=dev,
                                         generator=gen)
        hold_decode(sk, upsample_cubic(grid, sk.stride),
                    torch.full((n,), h, dtype=torch.int32, device=dev),
                    torch.full((n,), valid, dtype=torch.int32, device=dev),
                    kw_pk, kw_st, kw_asm, params.connect_ration,
                    f"batcher shape batch {n}, {h}x{w}, valid width {valid}",
                    smi)


def assembly_cases(sk, dev, params, peaks, cands, rng, smi):
    """Phase 3 for the fused assembly: ``greedy_assemble_kernel`` against
    ``greedy_assemble_plain`` on the card, every ``AssemblyResult`` field
    bit for bit (-0.0 equal to 0.0), on (a) the lane's own planted peaks
    and candidates at p_max 32, (b) random dense records at p_max 32, at
    p_max 1 (which fills the table: person_overflow) and at remove_recon 1
    (the compete rule), and (c) p_max 64.  Each case times the wrapper
    call (events), the kernel on the device (profiler) and the plain
    version (events, one call); the planted case's numbers are the
    kernel's row in the JSON line."""
    import torch

    from improved_body_parts_torch.ops import cuda_assembly

    base = assembly_args(sk, params)
    limbs_from, limbs_to = base["limbs_from"], base["limbs_to"]
    rand = random_records(sk, dev, rng, limbs_from, limbs_to)
    cases = [("planted", peaks, cands, {}),
             ("random dense", *rand, {}),
             ("random dense", *rand, dict(p_max=1)),
             ("random dense", *rand, dict(remove_recon=1)),
             ("planted", peaks, cands, dict(p_max=64)),
             ("random dense", *rand, dict(p_max=64))]
    row = None
    for label, pk, cd, kw in cases:
        kw = dict(base, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cuda_assembly.greedy_assemble_plain(pk, cd, **kw)
        end.record()
        got = cuda_assembly.greedy_assemble_kernel(pk, cd, **kw)
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        label = (f"{label}, p_max {kw['p_max']}, remove_recon "
                 f"{kw['remove_recon']}")
        compare(f"greedy_assemble ({label})", got, want, {1, 2, 3, 4, 5},
                tol=0.0)
        people, full = int(want[2].sum()), int(want[5].sum())
        if kw["p_max"] == 1:
            check(full > 0, f"greedy_assemble ({label}): no image filled "
                  "its one-person table")
        run = lambda: cuda_assembly.greedy_assemble_kernel(  # noqa: E731
            pk, cd, **kw)
        ms = cuda_ms(run, 20)
        dev_ms = sum(device_ms(run, ASSEMBLY_PASSES).values())
        steps, conns, all_steps, all_conns = chain_length(
            pk, cd, limbs_from, limbs_to)
        print(f"[3 kernels] greedy_assemble ({label}): equal to the plain "
              f"version bit for bit; {people} people, {full} images with a "
              f"full table; kernel {ms:.4f} ms (wrapper call, events), "
              f"{dev_ms:.4f} ms on the device, plain {plain_ms:.2f} ms; "
              f"longest chain {steps} walk steps and {conns} connections, "
              f"{1e3 * dev_ms / max(steps, 1):.3f} us a walk step [{smi}]")
        if row is None:
            n, c, k = pk.score.shape
            lm = cd.valid[0].numel()
            per_image = (c * k + c) * 4 + lm * 17 + cd.count.shape[1] * 4
            out = (kw["p_max"] * (sk.num_parts + 2) * 2 * 4 + kw["p_max"]
                   + 4 + 3)
            row = dict(err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bytes=n * (per_image + out) + 8 * len(limbs_from),
                       ops=all_steps * 8 + all_conns * 40)
    return row


def hold_focal(calls, ct, label, tag="[3 kernels]"):
    """The focal kernels on each ``(pred, gt, mask, chan)`` call of
    ``calls`` against their plain versions: the forward within rel 1e-5,
    the backward (cotangent ``ct``) bit for bit.  Returns the forward's
    max abs error and the backward's nonzero count."""
    import torch

    from improved_body_parts_torch.ops import cuda_focal

    fwd_err = fwd_rel = 0.0
    nonzero = 0
    for pred, gt, mask, chan in calls:
        got = cuda_focal.focal_fwd_kernel(pred, gt, mask, chan)
        want = cuda_focal.focal_fwd_plain(pred, gt, mask, chan)
        dgot = cuda_focal.focal_bwd_kernel(pred, gt, mask, chan, ct)
        dwant = cuda_focal.focal_bwd_plain(pred, gt, mask, chan, ct)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        shape = f"{tuple(pred.shape)} {str(pred.dtype)[6:]}"
        check(np.isfinite(err) and rel <= 1e-5,
              f"focal_fwd ({label}, {shape}): rel error {rel:.3g} against "
              "the plain version")
        check(torch.equal(dgot, dwant),
              f"focal_bwd ({label}, {shape}): differs from the plain "
              f"version in {int((dgot != dwant).sum())} places")
        fwd_err, fwd_rel = max(fwd_err, err), max(fwd_rel, rel)
        nonzero += int((dwant != 0).sum())
    shapes = ", ".join(f"{tuple(p.shape)} {str(p.dtype)[6:]}"
                       for p, _, _, _ in calls)
    print(f"{tag} focal ({label}): forward within rel {fwd_rel:.3g} "
          f"of the plain version, backward equal bit for bit, at {shapes}")
    return fwd_err, nonzero


def focal_kernels(cfg, dev):
    """Phase 3 for the focal-loss kernels: forward and backward against
    their plain versions at the canonical training shapes, on sparse GT
    (as ``pallas_focal.parity_benchmark`` builds it) and on a case planted
    on the kink; one step's 5 launches timed together."""
    import torch

    from improved_body_parts_torch.ops import cuda_focal
    from improved_body_parts_torch.ops.losses import _chan_scale

    sk, tr = cfg.skeleton, cfg.train
    stacks, batch = cfg.model.nstack, tr.batch_size_per_device
    c = sk.num_layers
    chan = _chan_scale(c, sk.heat_start, sk.bkg_start, tr.multi_task_weight,
                       tr.keypoint_task_weight, device=dev)
    ct = torch.tensor(tr.nstack_weight, device=dev) * 0.25  # a cotangent
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    scales = []
    for hw in (sk.height // sk.stride >> s for s in range(5)):
        pred = uniform(stacks, batch, hw, hw, c) * 1.4 - 0.2
        gt = uniform(batch, hw, hw, c) * (uniform(batch, hw, hw, c) > 0.7)
        mask = (uniform(batch, hw, hw, 1) > 0.1).float()
        scales.append((pred, gt, mask))
    kink = [(torch.where(gt >= cuda_focal.FG_THRE, 1.0, 0.0).expand_as(pred)
             .contiguous(), gt, mask) for pred, gt, mask in scales]
    fwd_err, on_kink = 0.0, 0
    for label, case in (("sparse", scales), ("kink", kink)):
        err, nonzero = hold_focal([(p, g, m, chan) for p, g, m in case], ct,
                                  label)
        fwd_err = max(fwd_err, err)
        if label == "kink":
            on_kink += nonzero
    check(on_kink > 0, "focal: the kink case has no gradient")

    def one_step(fn, *extra):
        return lambda: [fn(p, g, m, chan, *extra) for p, g, m in scales]

    in_bytes = sum(p.numel() + g.numel() + m.numel() + c
                   for p, g, m in scales) * 4
    pred_elems = sum(p.numel() for p, _, _ in scales)
    fwd_step = one_step(cuda_focal.focal_fwd_kernel)
    bwd_step = one_step(cuda_focal.focal_bwd_kernel, ct)
    first, again = fwd_step(), fwd_step()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "focal_fwd: two runs on the same inputs give different bits")
    split = []
    for pred, gt, mask in scales:
        by_pass = device_ms(lambda: cuda_focal.focal_fwd_kernel(
            pred, gt, mask, chan), FOCAL_FWD_PASSES)
        split.append(f"{pred.shape[2]}^2: " + " + ".join(
            f"{k} {v:.4f}" for k, v in by_pass.items()))
    print("[3 kernels] focal_fwd device ms a call by scale and pass "
          f"(profiler, 20 calls; same bits in two runs): {'; '.join(split)}")
    return {
        "focal_fwd": dict(
            err=fwd_err,
            ms=cuda_ms(fwd_step, 20),
            device_ms=sum(device_ms(fwd_step, FOCAL_FWD_PASSES,
                                    len(scales)).values()),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_fwd_plain), 5),
            bytes=in_bytes + 5 * stacks * 4,
            ops=pred_elems * 10),  # compare, select, 2 sub, abs, 4 mul, add
        "focal_bwd": dict(
            err=0.0,
            ms=cuda_ms(bwd_step, 20),
            device_ms=sum(device_ms(bwd_step, FOCAL_BWD_PASSES,
                                    len(scales)).values()),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_bwd_plain, ct), 5),
            bytes=in_bytes + 5 * stacks * 4 + pred_elems * 4,
            ops=pred_elems * 16),
    }


def train_full_width(cfg, dev, smi):
    """Phase 6: ``canonical`` trains at full width on drawn synthetic
    people; returns the focal kernels' launches in the 10 timed steps and
    what phase 9 reuses: the drawn records and the sync pipeline's step
    ms, host data ms a batch, imgs/s and bytes a batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from improved_body_parts_torch.data import MemoryDataset, batches
    from improved_body_parts_torch.data.fixture import _synth_image
    from improved_body_parts_torch.data.hdf5_corpus import (
        build_masks,
        iter_records,
    )
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import cuda_focal
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
        train_epoch,
    )
    from improved_body_parts_torch.train.step import to_device

    sk, tr = cfg.skeleton, cfg.train
    bs, warm_steps, steps = tr.batch_size_per_device, 2, 10
    rng = np.random.default_rng(6)
    records = []
    while len(records) < bs * (warm_steps + steps):
        img, persons, _ = _synth_image(rng, 480, 640, 2, sk.width,
                                       drawn=True)
        person_masks = []
        for p in persons:
            m = np.zeros(img.shape[:2], np.uint8)
            x0, y0, bw, bh = [int(v) for v in p["bbox"]]
            m[max(y0, 0): y0 + bh, max(x0, 0): x0 + bw] = 1
            person_masks.append(m)
        mask_miss, mask_all = build_masks(
            img.shape[:2], person_masks, [p["num_keypoints"] for p in persons])
        for rec in iter_records({"width": 640, "height": 480}, 0, 0, persons,
                                "SYNTH", is_validation=False):
            records.append((img, mask_miss, mask_all,
                            np.asarray(rec["joints"]),
                            tuple(rec["objpos"][0]),
                            float(rec["scale_provided"][0])))
    warm_set = MemoryDataset(records[:bs * warm_steps], cfg)
    timed_set = MemoryDataset(records[bs * warm_steps:
                                      bs * (warm_steps + steps)], cfg)

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        tr, steps_per_epoch=warm_steps + steps))
    state = create_train_state(model, cfg, opt)
    step = make_train_step(model, cfg, opt)
    losses, events = [], []

    def timed_step(state, *batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        events.append((start, end))
        return state, loss

    data_s = [0.0]

    def timed_batches(dataset, epoch):
        it = batches(dataset, bs, epoch, pipeline="sync", wire="uint8")
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            data_s[0] += time.perf_counter() - t
            if batch is None:
                return
            check(batch[0].dtype == np.uint8
                  and batch[0].shape == (bs, sk.height, sk.width, 3),
                  f"training batch images {batch[0].shape}")
            yield batch

    log = []
    state, _ = train_epoch(state, timed_step, timed_batches(warm_set, 0),
                           cfg, 0, print_freq=5, log_fn=log.append)
    torch.cuda.synchronize()
    print(f"[6 training] canonical imhn in train mode, bf16 autocast, "
          f"{warm_steps} warm-up steps at batch {bs} x {sk.height}x"
          f"{sk.width} in {time.perf_counter() - t0:.1f} s (build, "
          "first steps)")

    watch = {n: t.detach().clone() for n, t in model.state_dict().items()
             if n.startswith("backbone.stem.")}
    for fn in (cuda_focal.focal_fwd_kernel, cuda_focal.focal_bwd_kernel):
        fn.launches = 0
    losses.clear()
    events.clear()
    data_s[0] = 0.0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, mean_loss = train_epoch(state, timed_step,
                                   timed_batches(timed_set, 1), cfg, 1,
                                   print_freq=5, log_fn=log.append)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"focal_fwd": cuda_focal.focal_fwd_kernel.launches,
                "focal_bwd": cuda_focal.focal_bwd_kernel.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    for line in log:
        print(f"[6 training] {line}")
    print(f"[6 training] focal kernel launches in {steps} timed steps: "
          f"{launches}")
    for kname, n in launches.items():
        check(n == 5 * steps, f"{kname}: {n} launches in {steps} steps, "
              f"expected {5 * steps}")
    check(len(losses) == steps and bool(torch.isfinite(
        torch.stack(losses)).all()) and np.isfinite(mean_loss),
        "training: a loss is not finite")
    check(state.step == warm_steps + steps,
          f"training: step {state.step} after {warm_steps + steps} steps")
    check(int(opt.count) == warm_steps + steps,
          "training: a step's update was dropped")
    after = model.state_dict()
    for n, before in watch.items():
        if n.endswith(("weight", "bias", "running_mean", "running_var")):
            check(not torch.equal(after[n], before),
                  f"training: {n} did not move")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    print(f"[6 training] {steps} steps: median step {step_ms:.2f} ms (CUDA "
          f"events around each step), host data "
          f"{1e3 * data_s[0] / steps:.2f} ms per batch of {bs} (sync "
          f"pipeline), {steps * bs / wall_s:.2f} imgs/s "
          f"({1e3 * wall_s / steps:.2f} ms a step, host clock), mean loss "
          f"{mean_loss:.4f}, peak device memory {peak_mem / 2**30:.2f} GiB "
          f"[{smi}]")

    # the step alone, on one batch already on the card: back to back
    # (CUDA events), then its kernels by group (torch.profiler)
    dev_batch = to_device(next(batches(timed_set, bs, 2, wire="uint8")),
                          dev)
    b2b_ms = cuda_ms(lambda: step(state, *dev_batch), 3)
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            step(state, *dev_batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    groups = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(groups.values()) / 1e3 / prof_steps
    print(f"[6 training] one step on a device batch, back to back: "
          f"{b2b_ms:.2f} ms (CUDA events) [{smi}]")
    if not groups:
        print("[6 training] device busy time: not measured (the profiler "
              "recorded no kernel)")
    else:
        split = ", ".join(f"{g} {t / 1e3 / prof_steps:.2f}"
                          for g, t in sorted(groups.items(),
                                             key=lambda kv: -kv[1]))
        print(f"[6 training] profiled {prof_steps} steps: kernels "
              f"{busy_ms:.2f} ms a step of {1e3 * prof_s / prof_steps:.2f} "
              f"ms wall (device busy {busy_ms * prof_steps / 1e3 / prof_s:.1%}"
              f"); by group, ms a step: {split} [{smi}]")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("[6 training] host, self CPU ms a step under the profiler (calls "
          "a step): " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3 / prof_steps:.2f} "
              f"({e.count // prof_steps})" for e in host[:10]))
    gh, gw = sk.grid_shape
    wire_bytes = bs * (sk.height * sk.width * 3 + gh * gw * 4
                       + gh * gw * sk.num_layers * 4)
    return launches, dict(records=records, step_ms=step_ms,
                          data_ms=1e3 * data_s[0] / steps,
                          imgs_s=steps * bs / wall_s, batch_bytes=wire_bytes)


def same_payload(a, b) -> bool:
    """Field-for-field equality of two fused-lane payloads
    (``DeviceDecoded``, nested named tuples of arrays and numbers)."""
    if isinstance(a, tuple):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_payload(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def first_calls(fn, n: int, store: list):
    """``fn`` wrapped to keep clones of the arguments of its first ``n``
    calls in ``store``."""
    import torch

    def wrapper(*args):
        if len(store) < n:
            store.append(tuple(a.detach().clone()
                               if isinstance(a, torch.Tensor) else a
                               for a in args))
        return fn(*args)
    return wrapper


def learn_to_ap(dev, smi, work):
    """Phase 7: the learn->AP protocol of ``cli.synth_ap`` at
    ``CANONICAL_TRAIN.json``'s settings, in this process (the card
    machine has no h5py, so the drawn records stay in memory:
    ``fixture_records`` + ``MemoryDataset``; the held-out val set is
    written to disk as the CLIs read it), through the CLIs' own code:
    ``cli.train.train`` trains ``synth_canonical`` (the flagship IMHN at
    full width, remat on, bf16 autocast) for 18 epochs with the async
    checkpoint, then the last committed checkpoint, restored by
    ``cli.evaluate.load_predictor``, is scored with ``validation_oks`` on
    the fused lane and on the compact lane, beside the untrained init of
    ``cli.synth_ap.save_fresh_checkpoint``.  The focal kernels are then
    held to their plain versions on the first training step's own
    inputs, and the decode kernels on the first val image's maps.
    Everything is written under ``work``, which the caller removes.
    Returns the five kernels' launches in the training run and the
    fused-lane evaluation, and what phase 8 reuses: the last committed
    checkpoint, the val set and the network's input size."""
    import dataclasses

    import cv2
    import torch

    from improved_body_parts_torch.cli import kernel_launches
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.cli.synth_ap import (
        epoch_losses,
        save_fresh_checkpoint,
    )
    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import (
        InferenceModelParams,
        get_config,
    )
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.data.fixture import (
        build_val_set,
        fixture_records,
    )
    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.ops import (
        cuda_assembly,
        cuda_focal,
        cuda_peaks,
        losses,
    )
    from improved_body_parts_torch.train import (
        CheckpointManager,
        latest_checkpoint,
        restore_checkpoint,
    )

    wrappers = (cuda_peaks.topk_peaks_kernel,
                cuda_peaks.limb_pair_stats_kernel,
                cuda_assembly.greedy_assemble_kernel,
                cuda_focal.focal_fwd_kernel, cuda_focal.focal_bwd_kernel)

    def reset():
        for fn in wrappers:
            fn.launches = 0

    def digests(state):
        """SHA-256 of the state's model state_dict and of its momentum."""
        opt = state.optimizer
        names = {p: n for n, p in state.model.named_parameters()}
        return (state_digest(state.model.state_dict()),
                state_digest({names[p]: b for p, b in zip(opt.params,
                                                          opt.momentum)}))

    t_phase = time.perf_counter()
    epochs = SYNTH_AP["epochs"]
    ckpt_dir = os.path.join(work, "ckpt")
    cfg = get_config(SYNTH_AP["config"])
    # cli.synth_ap's train flags: --print-freq 20; the last two epochs
    # and the best stay on disk, not all 18 GB
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=20, keep_last_n=2))
    sk, tr = cfg.skeleton, cfg.train
    net = sk.height
    # the save of epoch 16 has all of epoch 17's in-place steps after it
    held_epoch, held = epochs - 2, {}
    focal_calls, lane_calls = [], []
    manager_save, focal_l2_fused = CheckpointManager.save, \
        losses.focal_l2_fused

    def save_and_digest(self, state, epoch, *args):
        path = manager_save(self, state, epoch, *args)
        if epoch == held_epoch:  # before the next step can run
            held[epoch] = digests(state)
        return path

    records = fixture_records(
        num_images=SYNTH_AP["train_images"],
        img_size=SYNTH_AP["canvas"], people_per_image=2,
        image_size=net, seed=SYNTH_AP["seed"], drawn=True)
    train_set = MemoryDataset(records, cfg, augment=True,
                              seed=SYNTH_AP["seed"])
    val_dir = os.path.join(work, "val")
    anno = os.path.join(work, "person_keypoints_synth.json")
    n_val = build_val_set(val_dir, anno,
                          num_images=SYNTH_AP["val_images"],
                          img_size=SYNTH_AP["canvas"], people_per_image=2,
                          image_size=net, seed=SYNTH_AP["val_seed"],
                          drawn=True)
    bs = tr.batch_size_per_device
    spe = max(len(train_set) // bs, 1)
    print(f"[7 learn->AP] {SYNTH_AP['config']}: {len(records)} drawn "
          f"training records of {SYNTH_AP['train_images']} images "
          f"{SYNTH_AP['canvas'][0]}x{SYNTH_AP['canvas'][1]}, "
          f"{SYNTH_AP['val_images']} held-out val images "
          f"({n_val} persons), batch {bs} at {net}x{sk.width}, "
          f"{spe} steps an epoch x {epochs} epochs; set up "
          f"in {time.perf_counter() - t_phase:.1f} s")
    log = []
    reset()
    CheckpointManager.save = save_and_digest
    # one training step's five focal calls, as the loss makes them
    losses.focal_l2_fused = first_calls(focal_l2_fused, 5, focal_calls)
    t0 = time.perf_counter()
    try:
        state, report = train(cfg, train_set, epochs, device=dev,
                              seed=SYNTH_AP["seed"], log_fn=log.append)
    finally:
        CheckpointManager.save = manager_save
        losses.focal_l2_fused = focal_l2_fused
    fit_s = time.perf_counter() - t0
    train_launches = kernel_launches()
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 128_998_760 and model.remat,
          f"synth_canonical: {n_params} parameters, remat "
          f"{model.remat}")
    curve = epoch_losses(ckpt_dir)
    steps = report["steps"]
    check(steps == spe * epochs and state.step == steps,
          f"learn->AP: {steps} steps, state step {state.step}")
    check(len(curve) == epochs and all(np.isfinite(curve)),
          f"learn->AP: losses {curve}")
    ratio = curve[-1] / curve[0]
    blocked, written = report["save_blocked_ms"], report["save_write_ms"]
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(model.state_dict().values())
                 + state.optimizer.momentum)
    print(f"[7 learn->AP] {n_params} parameters (remat, bf16 autocast); "
          f"{steps} steps: median step {report['step_ms_median']:.2f} ms "
          f"(CUDA events around each step), "
          f"{report['train_imgs_per_s']:.2f} train imgs/s (host clock "
          f"over the epochs' batch loops), train {fit_s:.1f} s wall "
          f"[{smi}]")
    print(f"[7 learn->AP] CheckpointManager.save, {len(blocked)} saves "
          f"of a {nbytes / 1e9:.3f} GB state (fp32 parameters, BN stats "
          f"and momentum): blocked median {statistics.median(blocked):.2f}"
          f" ms (max {max(blocked):.2f}; the snapshot into pinned host "
          f"buffers, the first save allocates them), writer median "
          f"{statistics.median(written):.2f} ms (max {max(written):.2f}; "
          f"torch.save + commit, on its thread); "
          f"{sum(n.startswith('epoch_') for n in os.listdir(ckpt_dir))}"
          f" checkpoints retained "
          f"(keep_last_n 2 + the best) [{smi}]")
    print(f"[7 learn->AP] train loss first {curve[0]:.4f} -> last "
          f"{curve[-1]:.4f} (ratio {ratio:.4f}); curve "
          + ", ".join(f"{x:.3f}" for x in curve))

    # the save that had a whole epoch of in-place steps after it: its
    # checkpoint holds the state as it was when save() returned
    path = os.path.join(ckpt_dir, f"epoch_{held_epoch}")
    payload = restore_checkpoint(path)
    check(held_epoch in held and (
        state_digest(payload["model"]),
        state_digest(payload["optimizer"]["momentum"]))
        == held[held_epoch],
        f"learn->AP: {path} differs from the state as it was when its "
        f"save returned, before epoch {held_epoch + 1}'s {spe} in-place "
        "steps (the snapshot did not own its copy)")
    del payload
    print(f"[7 learn->AP] epoch_{held_epoch}: its state_dict and momentum "
          f"have the SHA-256 they had when CheckpointManager.save "
          f"returned, after epoch {held_epoch + 1}'s {spe} in-place "
          "steps ran during its write")

    # the last committed checkpoint in a fresh model, as the evaluate
    # CLI loads it; the trained run's own model beside it
    latest = latest_checkpoint(ckpt_dir)
    check(latest is not None and latest.endswith(f"epoch_{epochs - 1}"),
          f"learn->AP: latest committed checkpoint {latest}")
    restored = load_predictor(SYNTH_AP["config"], latest, device=dev,
                              boxsize=net, params_dtype="fp32")
    check(state_digest(restored.model.state_dict())
          == state_digest(model.state_dict()),
          "learn->AP: the restored state_dict differs from the "
          "trained run's")
    model.eval()
    own = Predictor(model, sk,
                    model_params=InferenceModelParams(boxsize=net),
                    device=dev)
    image = cv2.imread(os.path.join(val_dir, "000000000001.jpg"))
    mine, theirs = (own.predict_decoded(image),
                    restored.predict_decoded(image))
    check(same_payload(mine, theirs), "learn->AP: the restored "
          "checkpoint's fused-lane payload on val image 1 differs from "
          "the trained run's own")
    print(f"[7 learn->AP] {latest}: restored into a fresh model, its "
          f"state_dict has the trained run's SHA-256 and its fused-lane "
          f"payload on val image 1 equals the trained run's field for "
          f"field ({mine.n_people} people, ok {mine.ok})")
    del own

    kw = dict(use_native=True, results_dir=os.path.join(work, "results"))
    reset()
    # the first val image's ensembled maps, as the lane decodes them
    restored.decode_maps = first_calls(restored.decode_maps, 1,
                                       lane_calls)
    t0 = time.perf_counter()
    ap_device = validation_oks(restored, anno, val_dir,
                               device_decode=True,
                               dump_name="synth_trained", **kw)
    eval_s = time.perf_counter() - t0
    eval_launches = kernel_launches()
    del restored.decode_maps
    ap_compact = validation_oks(restored, anno, val_dir, compact=True,
                                dump_name="synth_trained_compact", **kw)
    fresh = load_predictor(
        SYNTH_AP["config"],
        save_fresh_checkpoint(SYNTH_AP["config"],
                              os.path.join(work, "ckpt_fresh"),
                              SYNTH_AP["seed"]),
        device=dev, boxsize=net, params_dtype="fp32")
    ap_fresh = validation_oks(fresh, anno, val_dir, device_decode=True,
                              dump_name="synth_fresh", **kw)
    print(f"[7 learn->AP] OKS AP on the held-out val set: trained "
          f"{ap_device['AP']:.4f} on the fused lane (AP50 "
          f"{ap_device['AP50']:.4f}, AR {ap_device['AR']:.4f}; "
          f"{SYNTH_AP['val_images']} images in {eval_s:.2f} s), "
          f"{ap_compact['AP']:.4f} on the compact lane; untrained "
          f"{ap_fresh['AP']:.4f} [{smi}]")
    launches = {**{k: train_launches[k] for k in ("focal_fwd",
                                                   "focal_bwd")},
                **{k: eval_launches[k] for k in DECODE_KERNELS}}
    print(f"[7 learn->AP] device {torch.cuda.get_device_name(dev)} "
          f"({dev.type}); kernel launches: training {train_launches}, "
          f"the trained checkpoint's fused-lane evaluation "
          f"{eval_launches}")

    # every kernel against its plain version at this phase's shapes,
    # after the counts were read
    check(len(focal_calls) == 5 and len(lane_calls) == 1,
          f"learn->AP: captured {len(focal_calls)} focal calls and "
          f"{len(lane_calls)} lane decodes")
    hold_focal(focal_calls,
               torch.tensor(tr.nstack_weight, device=dev) * 0.25,
               "the first training step's inputs", tag="[7 learn->AP]")
    hold_lane_call(sk, lane_calls[0], "the first val image's maps", smi,
                   tag="[7 learn->AP]")

    for kname, n in launches.items():
        check(n > 0, f"learn->AP: {kname} never launched")
    check(ap_device["AP"] >= 0.5,
          f"learn->AP: trained AP {ap_device['AP']:.4f} < 0.5")
    check(ap_fresh["AP"] <= 0.05,
          f"learn->AP: untrained AP {ap_fresh['AP']:.4f} > 0.05")
    check(ratio <= 0.2, f"learn->AP: last/first loss {ratio:.4f} > 0.2")
    check(abs(ap_compact["AP"] - ap_device["AP"]) <= 0.01,
          f"learn->AP: compact AP {ap_compact['AP']:.4f} and fused AP "
          f"{ap_device['AP']:.4f} differ by more than 0.01")
    print(f"[7 learn->AP] phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, dict(checkpoint=latest, anno=anno, val_dir=val_dir,
                          net=net, ap_fused=ap_device["AP"],
                          records=records)


def time_decode(sk, maps, valid_h, valid_w, kw_pk, kw_st, kw_asm,
                connect_ration):
    """Wrapper-call ms (events, median of 20) and device ms (profiler)
    of the three decode kernels on one batch of maps, as phase 3 times
    them: {kernel: (ms, device_ms)}; a device time the profiler did not
    record in any window is None (not measured)."""
    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    pk = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    st = cuda_peaks.limb_pair_stats_plain(paf, pk[2], pk[3], **kw_st)
    peaks = TopKPeaks(*pk)
    cands = limb_topk_from_stats(
        PairStats(*st), peaks, valid_h, limbs_from=kw_asm["limbs_from"],
        limbs_to=kw_asm["limbs_to"], connect_ration=connect_ration,
        m_cap=2 * kw_pk["k"])
    runs = {"topk_peaks": (lambda: cuda_peaks.topk_peaks_kernel(
                kp, valid_h, valid_w, **kw_pk), PEAKS_PASSES),
            "limb_pair_stats": (lambda: cuda_peaks.limb_pair_stats_kernel(
                paf, pk[2], pk[3], **kw_st), LIMBS_PASSES),
            "greedy_assemble": (lambda: cuda_assembly.greedy_assemble_kernel(
                peaks, cands, **kw_asm), ASSEMBLY_PASSES)}
    out = {}
    for k, (fn, passes) in runs.items():
        dev = device_ms(fn, passes, required=False)
        out[k] = (cuda_ms(fn, 20), None if None in dev.values()
                  else sum(dev.values()))
    return out


def count_calls(counts, key, fn):
    """``fn`` wrapped to add one to ``counts[key]`` at each call."""
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def host_ms(fn, calls: int = 3) -> float:
    """Median host-clock ms of ``fn()``, a call that ends in its fetch."""
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def accuracy_tiers(dev, smi, ctx):
    """Phase 8: the accuracy tiers of inference on the card, after phase
    7 and on its trained checkpoint and val set (``ctx``).

    (a) the scale x rotation grid (:data:`PHASE8_GRIDS`) on the trained
    ``synth_canonical``, built by ``serve.artifacts.checkpoint_predictor``
    at fp32: per grid, ``cli.tta_bench.ab_report`` runs the fused and the
    looped grid on every val image in the compact and the decode mode
    (payloads equal bit for bit, 1 dispatch an image fused, entries + 1
    looped; one timed round of the compact mode), and ``validation_oks``
    scores the grid on
    the compact lane; the multi-scale grid also on the fused decode lane,
    with the decode kernels' counters set to 0 just before and read just
    after (the ``grid`` launches of the kernels line), its first image's
    mean maps captured; and the host full-map protocol (neither flag) on
    the multi-scale grid.  The compact lanes' overflow fallbacks
    (``predict_fast`` for one scale, ``Predictor.predict`` for a grid)
    are counted.  Gates: multi-scale AP >= 0.5, host protocol AP >= 0.5.
    (b) the decode kernels against their plain versions, bit for bit, on
    the captured mean maps and on planted people at (1, 768, 1151, 50)
    (:data:`GRID_SHAPE`, valid = the whole map), timed as in phase 3.
    (c) ``canonical`` (seeded init, boxsize 640) on one 427x640 image:
    the fused multi-scale grid (a 768x1151 mean grid) and
    ``Predictor.predict``, ms an image and peak memory;
    ``predict_decoded_async`` with the grid must make no synchronizing
    call (torch's sync debug mode set to error around it).
    (d) the dtype matrix: the trained checkpoint through
    ``checkpoint_predictor`` at fp32, bf16 and int8, the fused-lane AP
    of each, the stored bytes of each model's parameters and buffers,
    and ``canonical``'s ``predict_decoded_batch`` imgs/s at batch 8 of
    480x640 at each dtype; the APs on phase 7's 12 val images and on
    :data:`DTYPE_VAL_IMAGES` images of the same seed (the first 12 are
    phase 7's).  Gates: fp32 AP on the 12 equal to phase 7's,
    |AP(int8) - AP(bf16)| <= 0.01 on the 48, int8 bytes <= 0.35 x fp32.
    Returns the decode kernels' launches on the multi-scale grid."""
    import dataclasses

    import cv2
    import torch

    from improved_body_parts_torch.cli.tta_bench import ab_report
    from improved_body_parts_torch.config import (
        default_inference_params,
        get_config,
    )
    from improved_body_parts_torch.data.fixture import build_val_set
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.infer.resize import upsample_cubic
    from improved_body_parts_torch.serve.artifacts import (
        checkpoint_predictor,
    )
    from improved_body_parts_torch.utils.precision import storage_bytes

    t_phase = time.perf_counter()
    tag = "[8 accuracy tiers]"
    base, _ = default_inference_params()
    grids = {name: dataclasses.replace(base, **over)
             for name, over in PHASE8_GRIDS}
    ms = grids["multi_scale"]
    name_cfg, ckpt, net = SYNTH_AP["config"], ctx["checkpoint"], ctx["net"]
    sk = get_config(name_cfg).skeleton
    val_dir, anno = ctx["val_dir"], ctx["anno"]
    images = [cv2.imread(os.path.join(val_dir, f))
              for f in sorted(os.listdir(val_dir))]
    kw = dict(use_native=True,
              results_dir=os.path.join(os.path.dirname(val_dir), "results"))

    # ------------------------------------- (a) the grid, trained model
    pred = checkpoint_predictor(name_cfg, ckpt, "fp32", boxsize=net,
                                device=dev)
    fallbacks = {"predict_fast": 0, "predict": 0}
    pred.predict_fast = count_calls(fallbacks, "predict_fast",
                                    pred.predict_fast)
    pred.predict = count_calls(fallbacks, "predict", pred.predict)
    aps, lane_ms = {}, {}
    for name, prm in grids.items():
        n_entries = len(prm.scale_search) * len(prm.rotation_search)
        # one timed round of the compact mode; the decode mode's ms are
        # its parity pass's (the compact rounds warmed the forwards)
        for mode, rounds in (("compact", 1), ("decode", 0)):
            rep = ab_report(pred, images, prm, rounds=rounds, mode=mode)
            bad = [i for i, ok in enumerate(rep["payload_equal_per_image"])
                   if not ok]
            check(not bad, f"grid {name} ({mode}): the fused and looped "
                  f"payloads differ on val images {bad}")
            check(rep["ok"], f"grid {name} ({mode}): dispatches an image "
                  f"fused {rep['fused_dispatches_per_image']}, looped "
                  f"{rep['looped_dispatches_per_image']} (want 1 and "
                  f"{n_entries + 1})")
            lane_ms[name, mode] = (rep["fused_ms_per_image"],
                                   rep["looped_ms_per_image"])
        aps[name] = validation_oks(pred, anno, val_dir, params=prm,
                                   compact=True, dump_name=f"grid_{name}",
                                   **kw)["AP"]
        print(f"{tag} grid {name} ({n_entries} entries): fused = looped "
              f"bit for bit on {len(images)} val images in the compact and "
              f"decode modes, 1 and {n_entries + 1} dispatches an image; "
              f"ms an image (host clock, row fetched) fused/looped: "
              f"compact {lane_ms[name, 'compact'][0]:.2f}/"
              f"{lane_ms[name, 'compact'][1]:.2f}, decode (its parity pass) "
              f"{lane_ms[name, 'decode'][0]:.2f}/"
              f"{lane_ms[name, 'decode'][1]:.2f}; OKS AP on the compact "
              f"lane {aps[name]:.4f} [{smi}]")
    taken = dict(fallbacks)

    lane_calls = []
    decode_maps = pred.decode_maps
    pred.decode_maps = first_calls(decode_maps, 1, lane_calls)
    reset_launches()
    ap_ms_decode = validation_oks(pred, anno, val_dir, params=ms,
                                  device_decode=True,
                                  dump_name="grid_ms_decode", **kw)["AP"]
    grid_launches = read_launches()
    pred.decode_maps = decode_maps
    del pred.predict_fast, pred.predict
    print(f"{tag} multi-scale grid on the fused decode lane: AP "
          f"{ap_ms_decode:.4f}; kernel launches {grid_launches}; overflow "
          f"fallbacks taken by the compact lanes over the 4 grids: full "
          f"maps (predict_fast) {taken['predict_fast']}, host protocol "
          f"(Predictor.predict) {taken['predict']}")
    for kname, n in grid_launches.items():
        check(n > 0, f"grid: {kname} never launched on the multi-scale "
              "grid's fused decode lane")

    t0 = time.perf_counter()
    ap_host = validation_oks(pred, anno, val_dir, params=ms,
                             dump_name="grid_host", **kw)["AP"]
    predict_ms = 1e3 * (time.perf_counter() - t0) / len(images)
    print(f"{tag} host full-map protocol (process_image, neither flag) on "
          f"the multi-scale grid: AP {ap_host:.4f}, {predict_ms:.2f} ms an "
          f"image (host clock, validation_oks over {len(images)} images: "
          f"Predictor.predict, host decode, scoring) [{smi}]")
    check(aps["multi_scale"] >= 0.5, f"grid: multi-scale AP "
          f"{aps['multi_scale']:.4f} < 0.5")
    check(ap_host >= 0.5, f"grid: host protocol AP {ap_host:.4f} < 0.5")

    # ------------------------------- (b) the decode kernels, grid shapes
    check(len(lane_calls) == 1, f"grid: captured {len(lane_calls)} lane "
          "decodes")
    hold_lane_call(sk, lane_calls[0], "the first val image's multi-scale "
                   "mean maps", smi, tag)
    call = lane_calls.pop()
    del lane_calls
    gh, gw = GRID_SHAPE
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev).manual_seed(8)
    people = [person_joints(sk, x0, rng.uniform(40, 200),
                            rng.uniform(300, 520))
              for x0 in (60.0, 420.0, 780.0)]
    small = planted_grid_maps(sk, people, gh // 4, -(-gw // 4), dev)[None]
    small = small + 0.01 * torch.randn(small.shape, device=dev,
                                       generator=gen)
    maps = upsample_cubic(small, sk.stride)[:, :, :gw].contiguous()
    vh = torch.full((1,), gh, dtype=torch.int32, device=dev)
    vw = torch.full((1,), gw, dtype=torch.int32, device=dev)
    kws = lane_kwargs(sk, call[3], call[4])
    hold_decode(sk, maps, vh, vw, *kws,
                f"planted people at the grid shape {tuple(maps.shape)}, "
                f"valid {gh}x{gw}", smi, tag=tag)
    timed = time_decode(sk, maps, vh, vw, *kws)
    print(f"{tag} at {tuple(maps.shape)}: " + ", ".join(
        f"{k} {a:.4f} ms (wrapper call, events), "
        + ("not measured" if b is None else f"{b:.4f} ms")
        + " on the device" for k, (a, b) in timed.items()) + f" [{smi}]")
    del maps, small, call

    # -------------------------------- (c) full width at serve size
    big = checkpoint_predictor("canonical", None, "fp32", device=dev)
    image = rng.integers(0, 256, (*SERVE_IMAGE, 3), dtype=np.uint8)
    shapes = []
    big.compact_maps = first_calls(big.compact_maps, 1, shapes)
    big.predict_compact_ms(image, params=ms)              # warm-up
    del big.compact_maps
    grid_shape = tuple(shapes[0][0].shape)
    check(grid_shape == (1, gh, gw, sk.num_layers),
          f"serve-size grid: mean maps {grid_shape}, want "
          f"{(1, gh, gw, sk.num_layers)}")
    del shapes
    torch.cuda.reset_peak_memory_stats()
    fused_ms = host_ms(lambda: big.predict_compact_ms(image, params=ms))
    fused_peak = torch.cuda.max_memory_allocated()
    # the grid only enqueues: no call in predict_decoded_async may wait
    # for the card (torch's sync debug mode raises at a synchronizing
    # call: a read back to the host, a blocking copy); resolve() is the
    # one read back.  An event recorded as it returns can still be done,
    # since the host-bound eager grid leaves the card idle, and a sleep
    # kernel ahead of it fills the launch queue, which blocks the host
    big.predict_decoded(image, params=ms)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        resolve = big.predict_decoded_async(image, params=ms)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
    except RuntimeError as err:
        fail(f"serve-size grid: predict_decoded_async waited for the card "
             f"before resolve(): {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    decoded = resolve()
    check(decoded.subset.shape == (big.assembly_pmax, sk.num_parts + 2, 2)
          and np.isfinite(decoded.subset).all(),
          "serve-size grid: malformed decode result")
    big.predict(image, ms)                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    full_ms = host_ms(lambda: big.predict(image, ms), calls=2)
    full_peak = torch.cuda.max_memory_allocated()
    print(f"{tag} canonical (seeded init) on one {SERVE_IMAGE[0]}x"
          f"{SERVE_IMAGE[1]} image, multi-scale grid (mean grid "
          f"{gh}x{gw}): fused grid {fused_ms:.2f} ms an image, peak "
          f"device memory {fused_peak / 2**30:.2f} GiB; "
          f"predict_decoded_async enqueued in {enqueue_ms:.2f} ms with no "
          f"synchronizing call; Predictor.predict "
          f"{full_ms:.2f} ms, peak {full_peak / 2**30:.2f} GiB [{smi}]")
    del big

    # --------------------------------------------- (d) the dtype matrix
    # phase 7's val set, and its extension to DTYPE_VAL_IMAGES images of
    # the same seed (its first 12 are phase 7's), on which the gate is
    # taken: on 12 images (24 people) one (person, OKS threshold) match
    # moves AP by ~0.004, the size of the 0.01 bound's own steps
    val_more = os.path.join(os.path.dirname(val_dir), "val_dtype")
    anno_more = os.path.join(os.path.dirname(val_dir),
                             "person_keypoints_dtype.json")
    build_val_set(val_more, anno_more, num_images=DTYPE_VAL_IMAGES,
                  img_size=SYNTH_AP["canvas"], people_per_image=2,
                  image_size=net, seed=SYNTH_AP["val_seed"], drawn=True)
    check(all(np.array_equal(im, cv2.imread(os.path.join(val_more, f)))
              for im, f in zip(images, sorted(os.listdir(val_dir)))),
          "dtype matrix: the extended val set does not start with phase "
          "7's val images")
    dtype_ap, dtype_ap_more, dtype_bytes = {}, {}, {}
    serve_rate, serve_bytes = {}, {}
    batch = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
             for _ in range(BATCH)]
    for dtype in ("fp32", "bf16", "int8"):
        p = pred if dtype == "fp32" else checkpoint_predictor(
            name_cfg, ckpt, dtype, boxsize=net, device=dev)
        dtype_ap[dtype] = validation_oks(
            p, anno, val_dir, device_decode=True,
            dump_name=f"dtype_{dtype}", **kw)["AP"]
        dtype_ap_more[dtype] = validation_oks(
            p, anno_more, val_more, device_decode=True,
            dump_name=f"dtype_{dtype}_more", **kw)["AP"]
        dtype_bytes[dtype] = storage_bytes(p.model)
        del p
        serve = checkpoint_predictor("canonical", None, dtype, device=dev)
        serve_bytes[dtype] = storage_bytes(serve.model)
        serve.predict_decoded_batch(batch)                # warm-up
        serve_rate[dtype] = BATCH * 1e3 / host_ms(
            lambda: serve.predict_decoded_batch(batch))
        del serve
    del pred
    delta = abs(dtype_ap_more["int8"] - dtype_ap_more["bf16"])
    print(f"{tag} dtype matrix, the trained {name_cfg} checkpoint on the "
          f"fused lane, AP on phase 7's {len(images)} val images / on "
          f"{DTYPE_VAL_IMAGES} of the same seed: " + ", ".join(
              f"{d} {dtype_ap[d]:.4f} / {dtype_ap_more[d]:.4f} "
              f"({dtype_bytes[d]} B stored)" for d in dtype_ap)
          + f"; |AP(int8) - AP(bf16)| "
          f"{abs(dtype_ap['int8'] - dtype_ap['bf16']):.4f} / {delta:.4f}; "
          f"canonical predict_decoded_batch at batch {BATCH} of 480x640: "
          + ", ".join(f"{d} {serve_rate[d]:.2f} imgs/s ({serve_bytes[d]} B)"
                      for d in serve_rate) + f" [{smi}]")
    check(dtype_ap["fp32"] == ctx["ap_fused"],
          f"dtype matrix: fp32 AP {dtype_ap['fp32']:.4f} differs from "
          f"phase 7's fused-lane AP {ctx['ap_fused']:.4f}")
    check(delta <= 0.01, f"dtype matrix: |AP(int8) - AP(bf16)| = "
          f"{delta:.4f} > 0.01 on {DTYPE_VAL_IMAGES} val images")
    check(dtype_bytes["int8"] <= 0.35 * dtype_bytes["fp32"],
          f"dtype matrix: int8 stores {dtype_bytes['int8']} B, more than "
          f"0.35 x fp32's {dtype_bytes['fp32']} B")

    print(f"{tag} " + ", ".join(f"{k} AP {v:.4f}" for k, v in aps.items())
          + f", multi-scale fused decode AP {ap_ms_decode:.4f}, host "
          f"protocol AP {ap_host:.4f}; fused/looped ms an image (compact) "
          + ", ".join(f"{k} {lane_ms[k, 'compact'][0]:.2f}/"
                      f"{lane_ms[k, 'compact'][1]:.2f}" for k in grids)
          + f"; fallbacks predict_fast {taken['predict_fast']}, predict "
          f"{taken['predict']}; int8/bf16/fp32 AP on "
          f"{DTYPE_VAL_IMAGES} val images {dtype_ap_more['int8']:.4f}/"
          f"{dtype_ap_more['bf16']:.4f}/{dtype_ap_more['fp32']:.4f}, "
          f"int8 bytes "
          f"{dtype_bytes['int8'] / dtype_bytes['fp32']:.3f} x fp32; phase "
          f"took {time.perf_counter() - t_phase:.1f} s")
    return grid_launches, {k: v for k, v in timed.items()}


def kernel_group(name: str) -> str:
    """The group of a CUDA kernel, by its name, for the step's breakdown."""
    n = name.lower()
    for key, group in (("focal", "focal kernels"), ("sgd", "optimizer"),
                       ("conv", "convolution"), ("xmma", "convolution"),
                       ("cudnn", "convolution"), ("gemm", "matmul"),
                       ("batch_norm", "batch norm"), ("welford", "batch norm"),
                       ("bn_", "batch norm"), ("reduce", "reductions"),
                       ("elementwise", "elementwise"), ("copy", "copies"),
                       ("memcpy", "copies"), ("memset", "copies")):
        if key in n:
            return group
    return "other"


DECODE_KERNELS = ("topk_peaks", "limb_pair_stats", "greedy_assemble")


def decode_kernel_wrappers():
    """{name: wrapper} of the serve lane's three decode kernels."""
    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks

    return {"topk_peaks": cuda_peaks.topk_peaks_kernel,
            "limb_pair_stats": cuda_peaks.limb_pair_stats_kernel,
            "greedy_assemble": cuda_assembly.greedy_assemble_kernel}


def reset_launches() -> None:
    for fn in decode_kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in decode_kernel_wrappers().items()}


class TimedDispatch:
    """Stands in for a predictor in front of a ``DynamicBatcher``'s fused
    lane: every call is the predictor's own, and the host time of each
    dispatch (what the dispatcher thread spends on a batch: preprocessing,
    upload and the launches) is kept in ``ms``, its (bucket, size) in
    ``batches``; ``fast`` counts full-map fallbacks."""

    def __init__(self, inner):
        self._inner = inner
        self.ms = []
        self.batches = []       # (bucket shape, batch size) of each dispatch
        self.fast = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _timed(self, dispatch, images):
        t0 = time.perf_counter()
        out = dispatch()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.batches.append((self._inner.compact_lane_shape(images[0]),
                             len(images)))
        return out

    def predict_decoded_async(self, image, **kw):
        return self._timed(
            lambda: self._inner.predict_decoded_async(image, **kw), [image])

    def predict_decoded_batch_async(self, images, **kw):
        return self._timed(
            lambda: self._inner.predict_decoded_batch_async(images, **kw),
            images)

    def predict_fast_async(self, *a, **kw):
        self.fast += 1
        return self._inner.predict_fast_async(*a, **kw)


def drive(server, images, clients: int):
    """Send ``images`` from ``clients`` threads (image i from thread
    i % clients, each thread submitting its share back to back) and wait
    for every result; returns the results in image order."""
    import threading

    futures = [None] * len(images)
    errors = []

    def client(c):
        try:
            for i in range(c, len(images), clients):
                futures[i] = server.submit(images[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "batcher: a client thread hung")
    check(not errors, f"batcher: submit raised {errors[:1]}")
    return [f.result(timeout=600) for f in futures]


def check_conservation(metrics, rec, label: str) -> float:
    """The hop waterfall of a run: the request recorder ``rec`` (an
    ``obs.reqtrace.ReqTrace`` installed for the run, every request
    sampled) holds a record of each completed request with the five hops
    in order, none negative, and the hops of all requests sum to their
    e2e latencies (``metrics``' exact sums) within 1 us; returns that
    gap in us."""
    from improved_body_parts_torch.serve import HOPS

    records = rec.records()
    check(len(records) == metrics.completed,
          f"{label}: {len(records)} request records for "
          f"{metrics.completed} completed requests")
    for r in records:
        hops = r["nodes"][0]["hops_ms"]
        check(tuple(hops) == HOPS and min(hops.values()) >= 0,
              f"{label}: malformed hops {hops}")
    gap = abs(sum(m.sum for m in metrics.hops.values())
              - metrics.latency.sum) * 1e6
    check(gap <= 1.0, f"{label}: the hops miss e2e by {gap:.3f} us")
    return gap


def planted_batcher(sk, stub_maps, planted, smi):
    """The batcher phase on phase 4's planted maps: 12 requests from 3
    client threads over two buckets through the fused lane, then each
    fallback level forced: a 2-person table under 3 people (the host
    decode of the compact records, native), and top-K 2 under 3 people
    (the full maps of ``predict_fast``)."""
    from improved_body_parts_torch.config import InferenceModelParams
    from improved_body_parts_torch.infer import Predictor, native
    from improved_body_parts_torch.serve import DynamicBatcher

    check(native.native_available(), "batcher: the native decoder did not "
          "build (g++ on native/decoder.cpp)")
    requests = [np.zeros((HEIGHT, w, 3), np.uint8)
                for w in (WIDTH, 640) * 6]
    cases = (("fused", {}, 12, 3),
             ("host compact decode", dict(assembly_pmax=2), 4, 2),
             ("full maps", dict(compact_topk=2), 4, 2))
    for label, kw, n, clients in cases:
        pred = TimedDispatch(Predictor(
            MirrorStub(sk, stub_maps), sk,
            model_params=InferenceModelParams(boxsize=HEIGHT),
            device=stub_maps.device, **kw))
        with DynamicBatcher(pred, max_batch=4, max_wait_ms=25,
                            max_queue=64) as server:
            server.warmup([(HEIGHT, WIDTH), (HEIGHT, 640)])
            pred.fast = 0
            reset_launches()
            results = drive(server, requests[:n], clients)
            launches = read_launches()
            snap = server.metrics.snapshot()
        worst = max(planted_error(sk, people, planted,
                                  f"batcher {label}, request {i}")
                    for i, people in enumerate(results))
        check(snap["completed"] == n and snap["failed"] == 0
              and snap["rejected"] == 0,
              f"batcher {label}: {snap['completed']} of {n} completed, "
              f"{snap['failed']} failed, {snap['rejected']} rejected")
        fused = snap["decode_fused"]
        fallback = snap["decode_host_fallback"]
        if label == "fused":
            check(fused == n and fallback == 0 and pred.fast == 0,
                  f"batcher fused: decode_fused {fused}, fallback "
                  f"{fallback}, full-map runs {pred.fast}")
            for k, v in launches.items():
                check(v > 0, f"batcher fused: {k} never launched")
        else:
            full_maps = label == "full maps"
            check(fused == 0 and fallback == n
                  and pred.fast == (n if full_maps else 0),
                  f"batcher {label}: decode_fused {fused}, fallback "
                  f"{fallback}, full-map runs {pred.fast}")
        print(f"[batcher planted] {label}: {n} requests from {clients} "
              f"threads over buckets {snap['occupancy_histogram']} "
              f"(occupancy histogram), decode_fused {fused}, "
              f"decode_host_fallback {fallback}, full-map runs {pred.fast}, "
              f"{len(planted)} people each within {worst:.3f} px; "
              f"launches {launches} [{smi}]")


def full_width_batcher(pred, rng, smi):
    """The batcher phase at full width on phase 5's ``canonical``
    predictor: warm two buckets, then 64 requests from 4 client threads
    (max_batch 8, max_wait_ms 25, max_queue 64) through the fused lane,
    with the decode kernels' counters set to 0 just before and read just
    after, and a request recorder installed; then 8 requests through the
    host-pool lane.  Returns the counters."""
    from improved_body_parts_torch.obs import reqtrace
    from improved_body_parts_torch.serve import HOPS, DynamicBatcher

    sizes = [(480, 640), (640, 480)]
    images = [rng.integers(0, 256, (*sizes[i % 2], 3), dtype=np.uint8)
              for i in range(64)]
    timed = TimedDispatch(pred)
    rec = reqtrace.ReqTrace(sample=1, emit_to_sink=False)
    with DynamicBatcher(timed, max_batch=8, max_wait_ms=25,
                        max_queue=64) as server:
        t0 = time.perf_counter()
        info = server.warmup(sizes)
        print(f"[batcher full width] warmup of buckets "
              f"{info['bucket_shapes']} at batch sizes "
              f"{info['batch_sizes']}: {info['newly_compiled']} newly "
              f"warmed, {time.perf_counter() - t0:.2f} s")
        timed.ms.clear()
        timed.batches.clear()
        prev = reqtrace.set_reqtrace(rec)
        try:
            reset_launches()
            t0 = time.perf_counter()
            results = drive(server, images, clients=4)
            wall_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            reqtrace.set_reqtrace(prev)
        snap = server.metrics.snapshot()
        gap = check_conservation(server.metrics, rec, "batcher full width")
    check(len(results) == 64 and all(isinstance(r, list) for r in results),
          "batcher full width: malformed results")
    check(snap["completed"] == 64 and snap["failed"] == 0
          and snap["rejected"] == 0,
          f"batcher full width: {snap['completed']} of 64 completed, "
          f"{snap['failed']} failed, {snap['rejected']} rejected")
    for k, v in launches.items():
        check(v > 0, f"batcher full width: {k} never launched")
    host = sorted(timed.ms)
    lat, hops = snap["latency_ms"], snap["hops_ms"]
    print(f"[batcher full width] 64 requests from 4 threads: "
          f"{snap['imgs_per_sec']:.2f} imgs/s (first submit to last "
          f"completion), {64 / wall_s:.2f} imgs/s (host clock around the "
          f"run), e2e p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms, "
          f"mean occupancy {snap['mean_batch_occupancy']:.3f} "
          f"{snap['occupancy_histogram']}, decode_fused "
          f"{snap['decode_fused']}, fallback "
          f"{snap['decode_host_fallback']} [{smi}]")
    print("[batcher full width] hop p50 ms: " + ", ".join(
        f"{h} {hops[h]['p50']:.2f}" for h in HOPS) + "; hop p99 ms: "
        + ", ".join(f"{h} {hops[h]['p99']:.2f}" for h in HOPS)
        + f"; a request record with the five hops for each of the "
        f"{snap['completed']} requests, and their hops sum to their e2e "
        f"latencies within {gap:.4f} us")
    by_size = {}
    for key, ms in zip(timed.batches, timed.ms):
        by_size.setdefault(key, []).append(ms)
    print(f"[batcher full width] dispatcher host ms per batch (the dispatch "
          f"call, host clock): median {statistics.median(host):.2f}, min "
          f"{host[0]:.2f}, max {host[-1]:.2f} over {len(host)} batches; by "
          "bucket and batch, median (batches): " + "; ".join(
              f"{sh[0]}x{sh[1]} batch {n} {statistics.median(v):.2f} "
              f"({len(v)})" for (sh, n), v in sorted(by_size.items()))
          + f"; dispatcher busy {sum(host) / 1e3 / wall_s:.1%} of the run; "
          f"decode kernel launches {launches} [{smi}]")

    with DynamicBatcher(pred, max_batch=8, max_wait_ms=25, max_queue=64,
                        device_decode=False) as server:
        server.warmup(sizes[:1])
        t0 = time.perf_counter()
        results = drive(server, images[:16:2], clients=2)
        pool_s = time.perf_counter() - t0
        snap = server.metrics.snapshot()
    check(len(results) == 8 and snap["completed"] == 8
          and snap["failed"] == 0 and snap["decode_host_fallback"] == 8,
          f"batcher host-pool lane: {snap['completed']} of 8 completed, "
          f"{snap['failed']} failed, {snap['decode_host_fallback']} host "
          "decodes")
    print(f"[batcher full width] host-pool lane (device_decode=False): 8 "
          f"requests completed in {pool_s:.2f} s, decode_host_fallback 8, "
          f"e2e p50 {snap['latency_ms']['p50']:.2f} ms [{smi}]")
    return launches


# ------------------------------------------------ 9. the rest of training
# (variant, base config, stacks) -> published parameter count
VARIANT_COUNTS = {
    ("imhn_independent", "canonical", 4): 128_998_760,
    ("imhn_light", "canonical", 4): 149_504_936,
    ("imhn_wide", "canonical", 3): 152_156_430,
    ("ae", "ae", 4): 138_861_512,
    ("imhn_final", "final_384", 4): 227_066_536,
}
FOCAL_KERNELS = ("focal_fwd", "focal_bwd")
RING_WORKERS, MAX_PEOPLE = 4, 16


def focal_counts() -> dict:
    from improved_body_parts_torch.ops import cuda_focal

    return {"focal_fwd": cuda_focal.focal_fwd_kernel.launches,
            "focal_bwd": cuda_focal.focal_bwd_kernel.launches}


def reset_focal() -> None:
    from improved_body_parts_torch.ops import cuda_focal

    cuda_focal.focal_fwd_kernel.launches = 0
    cuda_focal.focal_bwd_kernel.launches = 0


def variant_config(variant, base, nstack):
    import dataclasses

    from improved_body_parts_torch.config import get_config

    cfg = get_config(base)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, variant=variant, nstack=nstack),
        train=dataclasses.replace(cfg.train,
                                  nstack_weight=(1.0,) * nstack))


def host_batches(cfg, records, n, batch, **kw):
    """``n`` batches of ``batch`` of ``records`` rendered by the port's
    host pipeline at ``cfg``'s input (epoch 0, uint8 wire)."""
    from improved_body_parts_torch.data import MemoryDataset, batches

    ds = MemoryDataset(records[:n * batch], cfg, seed=0)
    out = list(batches(ds, batch, 0, pipeline="sync", wire="uint8", **kw))
    check(len(out) == n, f"host batches: {len(out)} of {n}")
    return out


def timed_steps(step, state, device_batches, label):
    """Run ``step`` on each batch; CUDA events around each.  Returns
    (state, losses, ms a step (median), wall s)."""
    import torch

    from improved_body_parts_torch.train.step import to_device

    dev = next(state.model.parameters()).device
    losses, events = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in device_batches:
        batch = to_device(batch, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          f"{label}: a loss is not finite")
    return (state, losses,
            statistics.median(s.elapsed_time(e) for s, e in events), wall)


def focal_at_shape(calls, ct, shape, smi):
    """The focal kernels' device ms a step on ``calls`` (one step's
    ``(pred, gt, mask, chan)``), beside the bound of these shapes' own
    bytes and operations.  The step's inputs are rotated over copies that
    together hold 3x the L2, so each call finds its inputs evicted from
    L2 and reads them from HBM; the same inputs called again each time
    are timed too (what the L2 saves).  Returns {kernel: {device_ms, same_inputs_ms,
    bound_ms, bound_by, bytes}}."""
    import math

    import torch

    from improved_body_parts_torch.ops import cuda_focal

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    step_bytes = sum(t.numel() * t.element_size()
                     for call in calls for t in call[:3])
    n = max(2, math.ceil(3 * l2 / step_bytes))
    copies = [calls] + [[(p.clone(), g.clone(), m.clone(), c)
                         for p, g, m, c in calls] for _ in range(n - 1)]
    turn = [0]

    def rotated(kernel, *extra):
        def run():
            step = copies[turn[0] % n]
            turn[0] += 1
            return [kernel(p, g, m, c, *extra) for p, g, m, c in step]
        return run

    pred_elems = sum(p.numel() for p, _, _, _ in calls)
    in_bytes = sum((p.numel() + g.numel() + m.numel() + c.numel()) * 4
                   for p, g, m, c in calls)
    out_fwd = sum(p.shape[0] * 4 for p, _, _, _ in calls)
    work = {"focal_fwd": (cuda_focal.focal_fwd_kernel, (), FOCAL_FWD_PASSES,
                          in_bytes + out_fwd, pred_elems * 10),
            "focal_bwd": (cuda_focal.focal_bwd_kernel, (ct,),
                          FOCAL_BWD_PASSES,
                          in_bytes + ct.numel() * 4 + pred_elems * 4,
                          pred_elems * 16)}
    out = {}
    for k, (kernel, extra, passes, nbytes, ops) in work.items():
        # one launch a call: the profiler missed the first window of each
        # such measurement in one run, so it gets more windows
        hbm = sum(device_ms(rotated(kernel, *extra), passes, len(calls),
                            windows=5).values())
        same = sum(device_ms(lambda: [kernel(*c, *extra) for c in calls],
                             passes, len(calls), windows=5).values())
        by_bytes = nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
        out[k] = dict(device_ms=hbm, same_inputs_ms=same, bound_ms=bound,
                      bound_by="bytes" if by_bytes else "operations",
                      bytes=nbytes)
        print(f"[9a variants] {k} device ms a step at {shape}'s shapes "
              f"({', '.join(str(tuple(c[0].shape)) for c in calls)}): "
              f"{hbm:.4f} with the inputs rotated over {n} copies "
              f"({n * step_bytes} B; L2 {l2} B), {same:.4f} on the same "
              f"inputs each call (profiler); bound {bound:.4f} "
              f"({out[k]['bound_by']}: {nbytes} B) [{smi}]")
        check(hbm >= 0.9 * bound, f"{k} at {shape}'s shapes: {hbm:.4f} ms "
              f"with the inputs rotated is below 0.9 x its bound "
              f"{bound:.4f} ms: the timing does not read HBM")
    del copies
    return out


def variants_at_full_width(dev, smi, records):
    """Phase 9 (a)."""
    import torch

    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import cuda_focal, losses
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )

    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(2)]
    decode, focal = dict.fromkeys(DECODE_KERNELS, 0), \
        dict.fromkeys(FOCAL_KERNELS, 0)
    focal_ms = {}
    for (variant, base, nstack), want in VARIANT_COUNTS.items():
        t0 = time.perf_counter()
        cfg = variant_config(variant, base, nstack)
        sk, tr = cfg.skeleton, cfg.train
        model = build_model(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == want, f"{variant}: {n_params} parameters, "
              f"published {want}")
        pred = Predictor(model, sk)
        reset_launches()
        out = pred.predict_decoded_batch(images)
        torch.cuda.synchronize()
        got = read_launches()
        check(len(out) == 2 and all(np.isfinite(d.subset).all()
                                    for d in out),
              f"{variant}: malformed decode results")
        for k, n in got.items():
            check(n > 0, f"{variant}: {k} never launched serving")
            decode[k] += n
        del pred

        bs, nscale = tr.batch_size_per_device, len(tr.scale_weight)
        data = host_batches(cfg, records, 5, bs)
        model.train()
        opt = make_optimizer(model, cfg, step_decay_schedule(tr, 5))
        state = create_train_state(model, cfg, opt)
        step = make_train_step(model, cfg, opt)
        state, _, _, _ = timed_steps(step, state, data[:2], variant)
        calls, fused = [], losses.focal_l2_fused
        losses.focal_l2_fused = first_calls(fused, nscale, calls)
        reset_focal()
        torch.cuda.reset_peak_memory_stats()
        try:
            state, _, step_ms, wall = timed_steps(step, state, data[2:],
                                                  variant)
        finally:
            losses.focal_l2_fused = fused
        counts = focal_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, n in counts.items():
            check(n == nscale * 3, f"{variant}: {k} launched {n} times in "
                  f"3 steps, expected {nscale * 3}")
            focal[k] += n
        print(f"[9a variants] {variant} ({cfg.name}, {nstack} stacks): "
              f"{n_params} parameters; predict_decoded_batch of 2 480x640 "
              f"launched {got}; train at {sk.height}x{sk.width} batch {bs}: "
              f"{step_ms:.2f} ms a step (median of 3, CUDA events), "
              f"{3 * bs / wall:.2f} imgs/s, peak device memory "
              f"{peak / 2**30:.2f} GiB, focal launches {counts} "
              f"({time.perf_counter() - t0:.1f} s) [{smi}]")
        if variant in ("ae", "imhn_final"):
            shape = "ae" if variant == "ae" else "final_384"
            ct = torch.tensor(tr.nstack_weight, device=dev) * 0.25
            hold_focal(calls, ct, f"{shape}'s first timed step",
                       tag="[9a variants]")
            focal_ms[shape] = focal_at_shape(calls, ct, shape, smi)
        del model, state, opt, step, data, calls
        torch.cuda.empty_cache()
    return {**decode, **focal}, focal_ms


def train_report_counts(label, run, train_steps, eval_batches, fwd_a_step,
                        bwd_a_step):
    """Check the focal counts of one ``cli.train.train`` run: the train
    steps launch ``fwd_a_step`` / ``bwd_a_step`` each, an eval batch 5
    forwards (one a scale)."""
    counts = focal_counts()
    want = {"focal_fwd": fwd_a_step * train_steps + 5 * eval_batches,
            "focal_bwd": bwd_a_step * train_steps}
    check(run["steps"] == train_steps, f"{label}: {run['steps']} train "
          f"steps, expected {train_steps}")
    check(counts == want, f"{label}: focal launches {counts}, expected "
          f"{want} ({train_steps} steps, {eval_batches} eval batches)")
    return counts


def committed_losses(label, ckpt_dir):
    """The last committed checkpoint's train and validation losses,
    checked finite."""
    from improved_body_parts_torch.train import latest_checkpoint
    from improved_body_parts_torch.train.checkpoint import read_commit_meta

    meta = read_commit_meta(latest_checkpoint(ckpt_dir)) or {}
    losses_ = [meta.get("train_loss"), meta.get("metric_value")]
    check(meta.get("metric") == "val_loss"
          and all(isinstance(v, float) and np.isfinite(v) for v in losses_),
          f"{label}: the committed train and val losses {losses_} (metric "
          f"{meta.get('metric')}) are not finite")
    return losses_


def device_gt_through_ring(dev, smi, records, sync, work):
    """Phase 9 (b)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset, batch_wire_format
    from improved_body_parts_torch.ops.gt_device import make_gt_synthesizer
    from improved_body_parts_torch.train import RunSupervisor

    ckpt_dir = os.path.join(work, "ring")
    cfg = get_config("canonical")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, keep_last_n=1))
    sk, tr = cfg.skeleton, cfg.train
    bs = tr.batch_size_per_device
    host = host_batches(cfg, records, 1, bs)[0]
    raw = host_batches(cfg, records, 1, bs, raw_gt=MAX_PEOPLE)[0]
    synth = make_gt_synthesizer(sk)
    labels = synth(torch.from_numpy(raw[2]).to(dev),
                   torch.from_numpy(raw[3]).to(dev))
    err = float((labels.cpu() - torch.from_numpy(host[2])).abs().max())
    check(err <= 1e-4, f"device GT: max abs {err:.3g} from the host "
          "Heatmapper's labels")
    gt_ms = cuda_ms(lambda: synth(torch.from_numpy(raw[2]).to(dev),
                                  torch.from_numpy(raw[3]).to(dev)), 10)
    print(f"[9b device GT] the card's labels of a batch of {bs} within "
          f"{err:.3g} (max abs) of the host Heatmapper's; synthesis "
          f"{gt_ms:.3f} ms a batch of {bs} x {MAX_PEOPLE} people (CUDA "
          f"events, copy of the joints included) [{smi}]")

    names, shapes, dtypes = batch_wire_format(cfg, bs, raw_gt=MAX_PEOPLE,
                                              wire="uint8")
    wire_bytes = sum(int(np.prod(s)) * np.dtype(d).itemsize
                     for s, d in zip(shapes, dtypes))
    ds = MemoryDataset(records, cfg, seed=0)
    val = MemoryDataset(records[:2 * bs], cfg, augment=False, seed=1)
    sup = RunSupervisor(ckpt_dir, log_fn=lambda s: None)
    sup.open_segment({"argv": ["phase 9b"]})
    reset_focal()
    t0 = time.perf_counter()
    state, run = train(cfg, ds, 1, device=dev, seed=0, val_dataset=val,
                       workers=RING_WORKERS, pipeline="shm", wire="uint8",
                       device_gt=MAX_PEOPLE, supervisor=sup,
                       log_fn=lambda s: None)
    wall = time.perf_counter() - t0
    steps = len(ds) // bs
    counts = train_report_counts("device GT", run, steps, len(val) // bs,
                                 5, 5)
    losses_ = committed_losses("device GT", ckpt_dir)
    with open(os.path.join(ckpt_dir, "RUN.json")) as f:
        status = json.load(f)["segments"][-1]["status"]
    check(status == "completed", f"device GT: the supervised segment "
          f"ended {status}")
    print(f"[9b device GT] cli.train.train of canonical, one epoch of "
          f"{steps} steps, supervised, pipeline shm ({RING_WORKERS} spawn "
          f"workers over MemoryDataset records, train and eval rings) "
          f"through its device_prefetch, device_gt {MAX_PEOPLE}: median "
          f"step {run['step_ms_median']:.2f} ms (CUDA events), data wait "
          f"{run['data_wait_ms_per_step']:.2f} ms a step, "
          f"{run['train_imgs_per_s']:.2f} imgs/s (its report), "
          f"{wire_bytes} bytes a batch on the wire ({names}); train loss "
          f"{losses_[0]:.4f}, val {losses_[1]:.4f}; focal launches "
          f"{counts}; {wall:.1f} s with the rings' start and the save; "
          f"phase 6 in this run (sync pipeline, host labels): step "
          f"{sync['step_ms']:.2f} ms, host data {sync['data_ms']:.2f} ms a "
          f"batch, {sync['imgs_s']:.2f} imgs/s, {sync['batch_bytes']} bytes "
          f"a batch [{smi}]")
    del state
    torch.cuda.empty_cache()
    return counts


def distill_at_full_width(dev, smi, records, work):
    """Phase 9 (c)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.models import build_model

    ckpt_dir = os.path.join(work, "distill")
    cfg = get_config("canonical_student")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size_per_device=4, checkpoint_dir=ckpt_dir,
        keep_last_n=1))
    bs = 4
    teacher = build_model(get_config("canonical"), device=dev, seed=1)
    sha = state_digest(teacher.state_dict())
    ds = MemoryDataset(records, cfg, seed=0)
    val = MemoryDataset(records[:2 * bs], cfg, augment=False, seed=1)
    reset_focal()
    state, run = train(cfg, ds, 1, device=dev, seed=0, val_dataset=val,
                       teacher=teacher, log_fn=lambda s: None)
    steps = len(ds) // bs
    counts = train_report_counts("distill", run, steps, len(val) // bs,
                                 10, 10)
    losses_ = committed_losses("distill", ckpt_dir)
    check(state_digest(teacher.state_dict()) == sha,
          "distill: the teacher's state_dict changed")
    print(f"[9c distill] cli.train.train of canonical_student "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)"
          f" from a canonical teacher (seeded, eval) at 512x512 batch {bs}, "
          f"one epoch of {steps} steps (sync pipeline): median step "
          f"{run['step_ms_median']:.2f} ms (CUDA events), "
          f"{run['train_imgs_per_s']:.2f} imgs/s, host data wait "
          f"{run['data_wait_ms_per_step']:.2f} ms a step (its report); "
          f"train loss {losses_[0]:.4f}, val {losses_[1]:.4f}; focal "
          f"launches {counts}; the teacher's SHA-256 unchanged [{smi}]")
    del teacher, state
    torch.cuda.empty_cache()
    return counts


def swa_on_phase7(dev, smi, ctx, work):
    """Phase 9 (d)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli import kernel_launches
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.train import (
        latest_checkpoint,
        restore_checkpoint,
    )

    ckpt_dir = os.path.join(work, "swa")
    cfg = get_config(SYNTH_AP["config"])
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=20))
    base = restore_checkpoint(ctx["checkpoint"])["model"]
    stats = {k: v for k, v in base.items()
             if k.endswith(("running_mean", "running_var"))}
    ds = MemoryDataset(ctx["records"], cfg, augment=True,
                       seed=SYNTH_AP["seed"])
    before = kernel_launches()
    t0 = time.perf_counter()
    state, report = train(cfg, ds, 2, device=dev, seed=SYNTH_AP["seed"],
                          resume=ctx["checkpoint"], swa=True, swa_freq=2,
                          log_fn=lambda s: None)
    train_s = time.perf_counter() - t0
    sd = state.model.state_dict()
    moved = [k for k, v in stats.items() if not torch.equal(sd[k].cpu(), v)]
    check(not moved, f"SWA: BN running stats moved: {moved[:3]}")
    check(state.swa_count == 2, f"SWA: swa_count {state.swa_count}, the "
          "schedule says 2 (start + the cycle's end)")
    latest = latest_checkpoint(ckpt_dir)
    saved = restore_checkpoint(latest)
    names = dict(state.model.named_parameters())
    check(saved["swa_count"] == 2
          and saved["swa_start_step"] == state.swa_start_step
          and state_digest(saved["swa_params"]) == state_digest(names)
          and state_digest({k: saved["model"][k] for k in names})
          == state_digest(state.swa_params),
          "SWA: the checkpoint's SWA fields differ from the state's")
    pred = load_predictor(SYNTH_AP["config"], latest, device=dev,
                          boxsize=ctx["net"], params_dtype="fp32")
    ap = validation_oks(pred, ctx["anno"], ctx["val_dir"],
                        device_decode=True, use_native=True,
                        results_dir=os.path.join(work, "results"),
                        dump_name="synth_swa")["AP"]
    after = kernel_launches()
    counts = {k: after[k] - before[k] for k in after}
    for k, n in counts.items():
        check(n > 0, f"SWA: {k} never launched")
    check(ap >= 0.5, f"SWA: averaged weights' AP {ap:.4f} < 0.5")
    print(f"[9d SWA] {SYNTH_AP['config']}, 2 epochs (swa_freq 2, cyclic "
          f"1e-5 -> 1e-6, BN frozen) from {ctx['checkpoint']}: "
          f"{report['steps']} steps in {train_s:.1f} s, median step "
          f"{report['step_ms_median']:.2f} ms; BN running stats bit for bit "
          f"the checkpoint's; swa_count 2; the SWA fields equal after save "
          f"and restore; OKS AP of the averaged weights {ap:.4f} (fused "
          f"lane, {SYNTH_AP['val_images']} val images) beside phase 7's "
          f"{ctx['ap_fused']:.4f}; launches {counts} [{smi}]")
    del state, pred
    torch.cuda.empty_cache()
    return counts


def supervised_segments(dev, smi, ctx, work):
    """Phase 9 (e)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.train import RunSupervisor
    from improved_body_parts_torch.train.supervisor import classify_error

    # the card's own out-of-memory error is a transient failure, as XLA's
    # RESOURCE_EXHAUSTED is to the JAX supervisor
    try:
        torch.empty(1 << 46, dtype=torch.uint8, device=dev)  # 64 TiB
        oom = None
    except torch.cuda.OutOfMemoryError as e:
        oom = f"{type(e).__name__}: {e}"
    check(oom is not None and classify_error(oom) == "transient",
          f"supervisor: the card's out-of-memory error {oom!r} is not "
          "classified transient")
    print(f"[9e supervisor] {oom.splitlines()[0][:160]!r} classified "
          "transient")

    ckpt_dir = os.path.join(work, "supervised")
    cfg = get_config(SYNTH_AP["config"])
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=2, keep_last_n=1))
    records = ctx["records"][:16]
    spe = len(records) // cfg.train.batch_size_per_device
    sup = RunSupervisor(ckpt_dir, log_fn=lambda s: None)

    class StopInEpoch1(MemoryDataset):
        def sample(self, index, epoch=0, **kw):
            if epoch == 1:
                sup.request_stop()
            return super().sample(index, epoch, **kw)

    t0 = time.perf_counter()
    sup.open_segment({"argv": ["phase 9e", "segment 0"]})
    state, first = train(cfg, StopInEpoch1(records, cfg, seed=0), 2,
                         device=dev, seed=0, supervisor=sup,
                         log_fn=lambda s: None)
    sup2 = RunSupervisor(ckpt_dir, log_fn=lambda s: None)
    rec = sup2.open_segment({"argv": ["phase 9e", "segment 1"]})
    state, second = train(cfg, MemoryDataset(records, cfg, seed=0), 2,
                          device=dev, seed=0, supervisor=sup2,
                          log_fn=lambda s: None)
    with open(os.path.join(ckpt_dir, "RUN.json")) as f:
        run = json.load(f)
    statuses = [s["status"] for s in run["segments"]]
    check(statuses == ["preempted", "completed"]
          and rec["previous_end"] == "preemption",
          f"supervisor: segments {statuses}, previous end "
          f"{rec['previous_end']}")
    check(run["segments"][1].get("resumed_epoch") == 0,
          "supervisor: the second segment did not resume from epoch 0")
    check(state.step == 2 * spe, f"supervisor: step {state.step}, an "
          f"unstopped run takes {2 * spe}")
    print(f"[9e supervisor] {SYNTH_AP['config']}, 2 epochs of {spe} steps: "
          f"segment 0 stopped in epoch 1 after {first['steps']} steps "
          f"(epoch 0 committed), segment 1 resumed from epoch 0 and ran "
          f"{second['steps']} steps to the target; RUN.json segments "
          f"{statuses}; final step {state.step} = an unstopped run's; "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del state
    torch.cuda.empty_cache()


def rest_of_training(dev, smi, sync, ctx, work):
    """Phase 9: (a)-(e).  Returns the launches by path and the focal
    kernels' device ms at ``ae``'s and ``final_384``'s shapes."""
    t0 = time.perf_counter()
    variants, focal_ms = variants_at_full_width(dev, smi, sync["records"])
    launches = {"variants": variants,
                "device_gt": device_gt_through_ring(
                    dev, smi, sync["records"], sync, work),
                "distill": distill_at_full_width(dev, smi, sync["records"],
                                                 work),
                "swa": swa_on_phase7(dev, smi, ctx, work)}
    supervised_segments(dev, smi, ctx, work)
    print(f"[9 rest of training] phase took {time.perf_counter() - t0:.1f}"
          " s")
    return {"launches": launches, "focal_device_ms": focal_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an H100", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from improved_body_parts_torch.config import (
        InferenceModelParams,
        default_inference_params,
        get_config,
    )
    from improved_body_parts_torch.infer import Predictor, decode_device
    from improved_body_parts_torch.infer.resize import upsample_cubic
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import _build, cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("canonical")
    sk = cfg.skeleton
    params, _ = default_inference_params()
    limbs_from = tuple(a for a, _ in sk.limbs_conn)
    limbs_to = tuple(b for _, b in sk.limbs_conn)

    # ---------------------------------------------------------- 1. card
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 card] {smi}")
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device 0: {name}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2 build] {sorted(libs)} built and loaded in {build_s:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for stem, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "entry func")):
                print(f"[2 build] {stem}.cu: {line.strip()}")

    # ------------------------------------------------------- 3. kernels
    rng = np.random.default_rng(0)
    grid = []
    for _ in range(BATCH):
        people = [person_joints(sk, x0, rng.uniform(20, 120),
                                rng.uniform(260, 480))
                  for x0 in rng.uniform(0, WIDTH - 260, 4)]
        grid.append(planted_grid_maps(sk, people, HEIGHT // 4, WIDTH // 4,
                                      dev))
    grid = torch.stack(grid)
    gen = torch.Generator(device=dev).manual_seed(0)
    grid = grid + 0.01 * torch.randn(grid.shape, device=dev, generator=gen)
    maps = upsample_cubic(grid, sk.stride)                # (8, 640, 896, 50)
    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    valid_h = torch.full((BATCH,), HEIGHT, dtype=torch.int32, device=dev)
    valid_w = torch.tensor([WIDTH, 853] * (BATCH // 2), dtype=torch.int32,
                           device=dev)
    kw_pk = dict(thre=params.thre1, k=TOPK, radius=RADIUS)
    kw_st = dict(limbs_from=limbs_from, limbs_to=limbs_to,
                 num_samples=SAMPLES, thre2=params.thre2)

    results = {}
    pk_plain = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    pk_kernel = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    err = compare("topk_peaks", pk_kernel, pk_plain, {0, 1, 5, 6}, tol=0.0)
    n_kept = int(torch.clamp(pk_plain[6], max=TOPK).sum())
    check(n_kept > 0, "topk_peaks: the planted maps hold no peaks")
    out_bytes = BATCH * sk.num_parts * (TOPK * 6 * 4 + 4)
    run_pk = lambda: cuda_peaks.topk_peaks_kernel(  # noqa: E731
        kp, valid_h, valid_w, **kw_pk)
    pk_passes = device_ms(run_pk, PEAKS_PASSES)
    results["topk_peaks"] = dict(
        err=err,
        ms=cuda_ms(run_pk, 20),
        device_ms=sum(pk_passes.values()),
        plain_ms=cuda_ms(lambda: cuda_peaks.topk_peaks_plain(
            kp, valid_h, valid_w, **kw_pk), 5),
        bytes=kp.numel() * 4 + out_bytes + 2 * BATCH * 4,
        ops=kp.numel() * 10)  # 9-tap max + threshold per pixel
    floor_ms = read_floor_ms(kp)
    print("[3 kernels] topk_peaks device time by pass (profiler, 20 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in pk_passes.items())
          + f"; reading each pixel's {sk.num_parts}-channel slice once and "
          f"nothing else (peaks_read_probe) takes {floor_ms:.4f} ms [{smi}]")

    x_ref, y_ref = pk_plain[2], pk_plain[3]
    st_plain = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw_st)
    st_kernel = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref,
                                                  **kw_st)
    torch.cuda.synchronize()
    err = compare("limb_pair_stats", st_kernel, st_plain, {1, 2}, tol=0.0)
    samples = int(st_plain[2].sum())  # this run's gathered samples
    pairs = st_plain[0].numel()
    run_st = lambda: cuda_peaks.limb_pair_stats_kernel(  # noqa: E731
        paf, x_ref, y_ref, **kw_st)
    results["limb_pair_stats"] = dict(
        err=err,
        ms=cuda_ms(run_st, 20),
        device_ms=sum(device_ms(run_st, LIMBS_PASSES).values()),
        plain_ms=cuda_ms(lambda: cuda_peaks.limb_pair_stats_plain(
            paf, x_ref, y_ref, **kw_st), 5),
        bytes=samples * 4 + 2 * x_ref.numel() * 4 + pairs * 4 * 4,
        ops=samples * 8 + pairs * 12)
    dense_cases(sk, dev, gen, valid_h, valid_w, kw_pk, kw_st)
    bucket_cases(sk, dev, params, kw_pk, kw_st, smi)
    generic_cases(kp, paf, x_ref, y_ref, valid_h, valid_w, kw_pk, kw_st)

    peaks = TopKPeaks(*pk_plain)
    cands = limb_topk_from_stats(PairStats(*st_plain), peaks, valid_h,
                                 limbs_from=limbs_from, limbs_to=limbs_to,
                                 connect_ration=params.connect_ration,
                                 m_cap=2 * TOPK)
    check(bool(cands.valid.any()), "greedy_assemble: the planted maps give "
          "no accepted limb candidates")
    results["greedy_assemble"] = assembly_cases(sk, dev, params, peaks,
                                                cands, rng, smi)
    results.update(focal_kernels(cfg, dev))
    for kname, r in results.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / FP32_OPS_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / FP32_OPS_PER_S else "operations")
        print(f"[3 kernels] {kname}: kernel {r['ms']:.4f} ms (wrapper call, "
              f"events), {r['device_ms']:.4f} ms on the device (profiler), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} B), max abs err "
              f"{r['err']:.3g}; library_ms: none (no single PyTorch call "
              f"computes this function) [{smi}]")
    print(f"[3 kernels] {n_kept} kept peaks, {samples} limb samples, "
          f"{int(cands.valid.sum())} accepted candidates at batch {BATCH} "
          f"x {HEIGHT}x{WIDTH}")
    print("[3 kernels] launch counters after the comparisons: "
          f"topk_peaks {cuda_peaks.topk_peaks_kernel.launches}, "
          f"limb_pair_stats {cuda_peaks.limb_pair_stats_kernel.launches}, "
          f"greedy_assemble {cuda_assembly.greedy_assemble_kernel.launches}")
    del maps, kp, paf, grid, st_plain, st_kernel

    # -------------------------------------------------- 4. planted serve
    planted = [person_joints(sk, x0, 120, 360) for x0 in (30, 230, 430)]
    stub_maps = planted_grid_maps(sk, planted, HEIGHT // 4, WIDTH // 4, dev)
    stub_maps += 1e-3 * torch.rand(stub_maps.shape, device=dev,
                                   generator=gen)
    pred = Predictor(MirrorStub(sk, stub_maps), sk,
                     model_params=InferenceModelParams(boxsize=HEIGHT))
    requests = [np.zeros((HEIGHT, w, 3), np.uint8)
                for w in (WIDTH, 640, 768, WIDTH)]
    cuda_assembly.greedy_assemble_kernel.launches = 0
    decoded = pred.predict_decoded_batch(requests)
    asm_launches = cuda_assembly.greedy_assemble_kernel.launches
    check(asm_launches > 0, "planted serve: greedy_assemble never launched")
    worst = 0.0
    for i, dec in enumerate(decoded):
        check(dec.ok, f"planted request {i}: an overflow flag is set")
        worst = max(worst, planted_error(sk, decode_device(dec, sk),
                                         planted, f"planted request {i}"))
    print(f"[4 planted] {len(requests)} requests of widths "
          f"{[r.shape[1] for r in requests]}: {len(planted)} people each, "
          f"ok, max keypoint error {worst:.3f} px; greedy_assemble launched "
          f"{asm_launches} times")

    # --------------------------------------------------- 5. full width
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 128_998_760, f"canonical has {n_params} parameters")
    pred = Predictor(model, sk)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    pred.predict_decoded_batch(images)                  # warm-up
    torch.cuda.synchronize()
    print(f"[5 full width] canonical imhn, {n_params} parameters, bf16 "
          f"autocast, built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pred.predict_decoded_batch(images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"[5 full width] kernel launches in one predict_decoded_batch "
          f"of {BATCH}: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"{kname}: no launch on the full-width path")
    check(len(out) == BATCH and all(
        d.subset.shape == (pred.assembly_pmax, sk.num_parts + 2, 2)
        and np.isfinite(d.subset).all() for d in out),
        "full width: malformed decode results")

    t0 = time.perf_counter()  # host preprocessing: cubic resize + pad
    host = np.stack([pred._prepare_input(im, HEIGHT / 480)[0]
                     for im in images])
    prep_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    bucket = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    h2d_ms = 1e3 * (time.perf_counter() - t0)
    vh = torch.full((BATCH,), HEIGHT, dtype=torch.int32, device=dev)
    vw = torch.full((BATCH,), 853, dtype=torch.int32, device=dev)
    spec = pred._decode_spec(params)
    fwd_ms = cuda_ms(lambda: pred.ensemble_maps(bucket), 3)
    lane_maps = pred.ensemble_maps(bucket)
    check(tuple(lane_maps.shape) == (BATCH, HEIGHT, WIDTH, sk.num_layers)
          and bool(torch.isfinite(lane_maps).all()),
          "full width: ensembled maps malformed or not finite")
    dec_ms = cuda_ms(lambda: pred.decode_maps(lane_maps, vh, vw,
                                              params.thre1, spec), 3)
    calls = []
    for _ in range(3):  # host clock: the call ends in its one fetch
        t0 = time.perf_counter()
        pred.predict_decoded_batch(images)
        calls.append(1e3 * (time.perf_counter() - t0))
    total_ms = statistics.median(calls)

    # the lane only enqueues: an event recorded as the async call returns
    # is still pending behind the ~100 ms forward, and resolve() is the
    # one read back to the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resolve = pred.predict_decoded_batch_async(images)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    returned = torch.cuda.Event()
    returned.record()
    pending = not returned.query()
    again = resolve()
    resolve_ms = 1e3 * (time.perf_counter() - t0)
    check(pending, "full width: the device work was done when "
          "predict_decoded_batch_async returned, so the lane read back to "
          "the host before resolve()")
    check(len(again) == BATCH and all(
        d.subset.shape == (pred.assembly_pmax, sk.num_parts + 2, 2)
        and np.isfinite(d.subset).all() for d in again),
        "full width: malformed results from the async call")
    print(f"[5 full width] predict_decoded_batch_async returned after "
          f"{enqueue_ms:.2f} ms (host clock) with the device work still "
          f"queued; resolve() returned at {resolve_ms:.2f} ms")
    print(f"[5 full width] host preprocessing {prep_ms:.2f} ms, "
          f"host-to-device copy {h2d_ms:.2f} ms, "
          f"forward+merge+upsample {fwd_ms:.2f} ms, "
          f"extraction+assembly {dec_ms:.2f} ms, predict_decoded_batch "
          f"{total_ms:.2f} ms ({BATCH * 1e3 / total_ms:.2f} imgs/s; first "
          f"timed call {wall_s * 1e3:.2f} ms), peak device memory "
          f"{peak_mem / 2**30:.2f} GiB [{smi}]")

    # -------------------------------------------- batcher (5 to 6)
    planted_batcher(sk, stub_maps, planted, smi)
    batcher_launches = full_width_batcher(pred, rng, smi)

    del model, pred, bucket, lane_maps, out, resolve, again
    # the batcher's dispatcher, fetcher and pool threads each left a
    # cuBLAS workspace on the card; release them so phase 6's peak is its
    # own (its thread makes its workspace anew)
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    print(f"[batcher] device memory allocated after the serve phases "
          f"{held / 2**20:.1f} MiB, {torch.cuda.memory_allocated() / 2**20:.1f}"
          f" MiB once the cuBLAS workspaces are released")

    # ---------------------------------------- 6. training at full width
    train_launches, sync_train = train_full_width(cfg, dev, smi)
    launches.update(train_launches)

    # ------------------------------ 7. learn -> AP, 8. accuracy tiers
    work = tempfile.mkdtemp(prefix="chip_smoke_synth_ap_")
    try:
        ap_launches, trained = learn_to_ap(dev, smi, work)
        grid_launches, grid_times = accuracy_tiers(dev, smi, trained)
        # --------------------------------- 9. the rest of training
        rest = rest_of_training(dev, smi, sync_train, trained, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ------------------------------------------------------- the result
    src = {"topk_peaks": ("improved_body_parts_torch/csrc/peaks.cu",
                          "improved_body_parts_tpu/ops/pallas_peaks.py:150"),
           "limb_pair_stats": (
               "improved_body_parts_torch/csrc/limbs.cu",
               "improved_body_parts_tpu/ops/pallas_peaks.py:224"),
           "greedy_assemble": (
               "improved_body_parts_torch/csrc/assembly.cu",
               "improved_body_parts_tpu/ops/pallas_assembly.py:75"),
           "focal_fwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:98"),
           "focal_bwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:120")}
    # ``launches`` are phase 7's learn->AP run (training, then the fused
    # lane's evaluation of the trained checkpoint); the other paths'
    # counts stand beside them
    by_path = {k: {"predict_decoded_batch": launches[k],
                   "batcher": batcher_launches[k]} for k in DECODE_KERNELS}
    by_path.update({k: {"train_epoch": launches[k]}
                    for k in ("focal_fwd", "focal_bwd")})
    for k, n in ap_launches.items():
        by_path[k]["learn_to_ap"] = n
    for k, n in grid_launches.items():
        by_path[k]["grid"] = n
    for path, counts in rest["launches"].items():
        for k, n in counts.items():
            by_path[k][path] = n
    launches = ap_launches
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k],
                    launches_by_path=by_path[k],
                    max_abs_err=r["err"], ms=r["ms"],
                    device_ms=r["device_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None)
               for k, r in results.items()]
    for row in kernels:
        for shape, times in rest["focal_device_ms"].items():
            if row["name"] in times:
                t = times[row["name"]]
                row[f"{shape}_shape_device_ms"] = t["device_ms"]
                row[f"{shape}_shape_same_inputs_ms"] = t["same_inputs_ms"]
                row[f"{shape}_shape_bound_ms"] = t["bound_ms"]
                row[f"{shape}_shape_bound_by"] = t["bound_by"]
        if row["name"] in grid_times:
            row["grid_shape_ms"], row["grid_shape_device_ms"] = \
                grid_times[row["name"]]
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(f"[chip_smoke] every phase passed in "
          f"{time.perf_counter() - T_START:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
