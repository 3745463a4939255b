#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: the serve lane and training.

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
   sparse peaks: integer outputs exactly, float outputs within 1e-5.  The
   focal-loss kernels at the canonical training shapes (4 stacks, batch 4,
   the 5 scales 128^2..8^2, 50 channels) on sparse GT and on a case
   planted on the kink: the forward within rel 1e-5, the backward bit for
   bit.  Median times of kernel and plain version;
4. planted serve: a stub network that returns planted people's maps, a few
   requests of different sizes through ``Predictor.predict_decoded_batch``
   and ``decode_device``; every planted person decodes, keypoints within
   1 px;
5. full width: the ``canonical`` IMHN (4 stacks, 128,998,760 parameters)
   from a seeded init in bf16 autocast, ``predict_decoded_batch`` on 8
   images of 480x640 (the 640x896 bucket).  The decode kernels' launch
   counters are set to 0 just before this run and read just after; every
   decode kernel must have launched;
6. training at full width: ``canonical`` in train mode from a seeded init,
   bf16 autocast, SGD; drawn synthetic people through the port's
   ``Transformer`` + ``Heatmapper`` (augmented, 512x512, batch 4, uint8
   wire) into ``make_train_step`` + ``train_epoch``: 2 warm-up steps, then
   10 timed steps with the focal kernels' counters set to 0 just before
   and read just after (5 launches a step each).  Losses finite, params
   and BN running stats moved, every step counted.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` line
again, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, the script exits non-zero and prints
no result.  Every number it prints is measured on the card in this run.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, HEIGHT, WIDTH = 8, 640, 896          # the serve lane's bucket
TOPK, RADIUS, SAMPLES = 64, 2, 20
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                      # H100 SXM, outside tensor cores
FLOAT_TOL = 1e-5

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


def compare(name, got, want, int_fields):
    """Max abs error of ``got`` vs ``want`` (equal-length tuples); integer
    and bool fields must match exactly, floats within FLOAT_TOL."""
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
            check(np.isfinite(err) and err <= FLOAT_TOL,
                  f"{name}: float output {i} off by {err}")
            worst = max(worst, err)
    return worst


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
    on_kink = 0
    fwd_err = fwd_rel = 0.0
    for label, case in (("sparse", scales), ("kink", kink)):
        for pred, gt, mask in case:
            got = cuda_focal.focal_fwd_kernel(pred, gt, mask, chan)
            want = cuda_focal.focal_fwd_plain(pred, gt, mask, chan)
            dgot = cuda_focal.focal_bwd_kernel(pred, gt, mask, chan, ct)
            dwant = cuda_focal.focal_bwd_plain(pred, gt, mask, chan, ct)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            check(np.isfinite(err) and rel <= 1e-5,
                  f"focal_fwd ({label}, {tuple(pred.shape)}): rel error "
                  f"{rel:.3g} against the plain version")
            check(torch.equal(dgot, dwant),
                  f"focal_bwd ({label}, {tuple(pred.shape)}): differs from "
                  f"the plain version in {int((dgot != dwant).sum())} "
                  "places")
            fwd_err, fwd_rel = max(fwd_err, err), max(fwd_rel, rel)
            if label == "kink":
                on_kink += int((dwant != 0).sum())
        print(f"[3 kernels] focal ({label}): forward within rel "
              f"{fwd_rel:.3g} of the plain version, backward equal bit "
              "for bit at all 5 scales")
    check(on_kink > 0, "focal: the kink case has no gradient")

    def one_step(fn, *extra):
        return lambda: [fn(p, g, m, chan, *extra) for p, g, m in scales]

    in_bytes = sum(p.numel() + g.numel() + m.numel() + c
                   for p, g, m in scales) * 4
    pred_elems = sum(p.numel() for p, _, _ in scales)
    return {
        "focal_fwd": dict(
            err=fwd_err,
            ms=cuda_ms(one_step(cuda_focal.focal_fwd_kernel), 20),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_fwd_plain), 5),
            bytes=in_bytes + 5 * stacks * 4,
            ops=pred_elems * 10),  # compare, select, 2 sub, abs, 4 mul, add
        "focal_bwd": dict(
            err=0.0,
            ms=cuda_ms(one_step(cuda_focal.focal_bwd_kernel, ct), 20),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_bwd_plain, ct), 5),
            bytes=in_bytes + 5 * stacks * 4 + pred_elems * 4,
            ops=pred_elems * 16),
    }


def train_full_width(cfg, dev, smi):
    """Phase 6: ``canonical`` trains at full width on drawn synthetic
    people; returns the focal kernels' launches in the 10 timed steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from improved_body_parts_torch.data.dataset import (
        CocoPoseDataset,
        batches,
        convert_joints,
    )
    from improved_body_parts_torch.data.fixture import _synth_image
    from improved_body_parts_torch.data.hdf5_corpus import (
        build_masks,
        iter_records,
    )
    from improved_body_parts_torch.data.heatmapper import Heatmapper
    from improved_body_parts_torch.data.transformer import Transformer
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

    class MemoryDataset(CocoPoseDataset):
        """The port's dataset over in-memory drawn records (the h5py corpus
        reader is bypassed; sampling, augmentation and GT are the
        package's)."""

        def __init__(self, config, records, seed=0):
            self.config, self.skeleton = config, config.skeleton
            self.augment, self.seed = True, seed
            self.transformer = Transformer(self.skeleton)
            self.heatmapper = Heatmapper(self.skeleton)
            self.records, self.keys, self._file = records, records, None

        def read_raw(self, index):
            return self.records[index]

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
                            convert_joints(np.asarray(rec["joints"]), sk),
                            tuple(rec["objpos"][0]),
                            float(rec["scale_provided"][0])))
    warm_set = MemoryDataset(cfg, records[:bs * warm_steps])
    timed_set = MemoryDataset(cfg, records[bs * warm_steps:
                                           bs * (warm_steps + steps)])

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
    return launches


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
    from improved_body_parts_torch.ops.assembly import greedy_assemble
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
            if "registers" in line or "spill" in line:
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
    err = compare("topk_peaks", pk_kernel, pk_plain, {0, 1, 5, 6})
    n_kept = int(torch.clamp(pk_plain[6], max=TOPK).sum())
    check(n_kept > 0, "topk_peaks: the planted maps hold no peaks")
    out_bytes = BATCH * sk.num_parts * (TOPK * 6 * 4 + 4)
    results["topk_peaks"] = dict(
        err=err,
        ms=cuda_ms(lambda: cuda_peaks.topk_peaks_kernel(
            kp, valid_h, valid_w, **kw_pk), 20),
        plain_ms=cuda_ms(lambda: cuda_peaks.topk_peaks_plain(
            kp, valid_h, valid_w, **kw_pk), 5),
        bytes=kp.numel() * 4 + out_bytes + 2 * BATCH * 4,
        ops=kp.numel() * 10)  # 9-tap max + threshold per pixel

    x_ref, y_ref = pk_plain[2], pk_plain[3]
    st_plain = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw_st)
    st_kernel = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref,
                                                  **kw_st)
    torch.cuda.synchronize()
    err = compare("limb_pair_stats", st_kernel, st_plain, {1, 2})
    samples = int(st_plain[2].sum())  # this run's gathered samples
    pairs = st_plain[0].numel()
    results["limb_pair_stats"] = dict(
        err=err,
        ms=cuda_ms(lambda: cuda_peaks.limb_pair_stats_kernel(
            paf, x_ref, y_ref, **kw_st), 20),
        plain_ms=cuda_ms(lambda: cuda_peaks.limb_pair_stats_plain(
            paf, x_ref, y_ref, **kw_st), 5),
        bytes=samples * 4 + 2 * x_ref.numel() * 4 + pairs * 4 * 4,
        ops=samples * 8 + pairs * 12)

    # the walk on the lane's own candidates, and on random prefix-valid
    # candidate sets that make it take many steps
    peaks = TopKPeaks(*pk_plain)
    cands = limb_topk_from_stats(PairStats(*st_plain), peaks, valid_h,
                                 limbs_from=limbs_from, limbs_to=limbs_to,
                                 connect_ration=params.connect_ration,
                                 m_cap=2 * TOPK)
    n_peaks = torch.clamp(peaks.count, max=TOPK)
    la = torch.as_tensor(limbs_from, device=dev)
    lb = torch.as_tensor(limbs_to, device=dev)
    limit = torch.minimum(n_peaks[:, la], n_peaks[:, lb])
    walk_in = (cands.slot_a, cands.slot_b, cands.valid, limit)
    check(bool(cands.valid.any()), "walk: the planted maps give no "
          "accepted limb candidates")
    m_cap = 2 * TOPK
    shape = (BATCH, len(limbs_from), m_cap)
    counts = torch.as_tensor(rng.integers(0, m_cap + 1, shape[:2]),
                             device=dev)
    rand_in = (torch.as_tensor(rng.integers(0, TOPK, shape), device=dev),
               torch.as_tensor(rng.integers(0, TOPK, shape), device=dev),
               torch.arange(m_cap, device=dev) < counts[..., None],
               torch.as_tensor(rng.integers(0, TOPK + 1, shape[:2]),
                               device=dev))
    for label, args in (("lane", walk_in), ("random", rand_in)):
        got = cuda_assembly.candidate_walk_kernel(*args, TOPK)
        want = cuda_assembly.candidate_walk_plain(*args, TOPK)
        torch.cuda.synchronize()
        compare(f"candidate_walk ({label})", (got,), (want,), {0})
        print(f"[3 kernels] candidate_walk ({label}): "
              f"{int(want.sum())} of {int(args[2].sum())} valid candidates "
              "taken, equal to the plain version")
    asm_kw = dict(limbs_from=limbs_from, limbs_to=limbs_to,
                  num_parts=sk.num_parts, p_max=32,
                  len_rate=params.len_rate,
                  connection_tole=params.connection_tole,
                  remove_recon=params.remove_recon,
                  min_parts=params.min_parts,
                  min_mean_score=params.min_mean_score)
    found = int(greedy_assemble(peaks, cands, **asm_kw).n_people.sum())
    asm_ms = cuda_ms(lambda: greedy_assemble(peaks, cands, **asm_kw), 5)
    # the table rules run one round per limb and selection rank
    rounds = int(cuda_assembly.candidate_walk_plain(*walk_in, TOPK)
                 .sum(-1).amax(0).sum())
    print(f"[3 kernels] greedy_assemble (walk kernel + table rules) on the "
          f"planted maps: {asm_ms:.3f} ms for {rounds} rounds "
          f"({asm_ms / max(rounds, 1):.3f} ms a round), {found} people in "
          f"{BATCH} images [{smi}]")
    rows = limit.numel()
    results["candidate_walk"] = dict(
        err=0.0,
        ms=cuda_ms(lambda: cuda_assembly.candidate_walk_kernel(
            *walk_in, TOPK), 20),
        plain_ms=cuda_ms(lambda: cuda_assembly.candidate_walk_plain(
            *walk_in, TOPK), 5),
        bytes=rows * m_cap * 4 * 4 + rows * 4,
        ops=rows * m_cap * 6)
    results.update(focal_kernels(cfg, dev))
    for kname, r in results.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / FP32_OPS_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / FP32_OPS_PER_S else "operations")
        print(f"[3 kernels] {kname}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} B), max abs err "
              f"{r['err']:.3g}; library_ms: none (no single PyTorch call "
              f"computes this function) [{smi}]")
    print(f"[3 kernels] {n_kept} kept peaks, {samples} limb samples, "
          f"{int(cands.valid.sum())} accepted candidates at batch {BATCH} "
          f"x {HEIGHT}x{WIDTH}")
    print("[3 kernels] launch counters after the comparisons: "
          f"topk_peaks {cuda_peaks.topk_peaks_kernel.launches}, "
          f"limb_pair_stats {cuda_peaks.limb_pair_stats_kernel.launches}, "
          f"candidate_walk {cuda_assembly.candidate_walk_kernel.launches}")
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
    decoded = pred.predict_decoded_batch(requests)
    mapping = sk.dt_gt_mapping
    worst = 0.0
    for i, dec in enumerate(decoded):
        check(dec.ok, f"planted request {i}: an overflow flag is set")
        people = decode_device(dec, sk)
        check(len(people) == len(planted), f"planted request {i}: decoded "
              f"{len(people)} people, planted {len(planted)}")
        for joints in planted:
            want = {gt: joints[dt] for dt, gt in mapping.items()
                    if gt is not None}
            errs = [max(np.hypot(kps[gt][0] - xy[0], kps[gt][1] - xy[1])
                        for gt, xy in want.items())
                    for kps, _ in people]
            worst = max(worst, min(errs))
    check(worst <= 1.0, f"planted keypoints off by {worst:.3f} px")
    print(f"[4 planted] {len(requests)} requests of widths "
          f"{[r.shape[1] for r in requests]}: {len(planted)} people each, "
          f"ok, max keypoint error {worst:.3f} px")

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

    for fn in (cuda_peaks.topk_peaks_kernel,
               cuda_peaks.limb_pair_stats_kernel,
               cuda_assembly.candidate_walk_kernel):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pred.predict_decoded_batch(images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {
        "topk_peaks": cuda_peaks.topk_peaks_kernel.launches,
        "limb_pair_stats": cuda_peaks.limb_pair_stats_kernel.launches,
        "candidate_walk": cuda_assembly.candidate_walk_kernel.launches}
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
    print(f"[5 full width] host preprocessing {prep_ms:.2f} ms, "
          f"host-to-device copy {h2d_ms:.2f} ms, "
          f"forward+merge+upsample {fwd_ms:.2f} ms, "
          f"extraction+assembly {dec_ms:.2f} ms, predict_decoded_batch "
          f"{total_ms:.2f} ms ({BATCH * 1e3 / total_ms:.2f} imgs/s; first "
          f"timed call {wall_s * 1e3:.2f} ms), peak device memory "
          f"{peak_mem / 2**30:.2f} GiB [{smi}]")

    del model, pred, bucket, lane_maps, out
    torch.cuda.empty_cache()

    # ---------------------------------------- 6. training at full width
    launches.update(train_full_width(cfg, dev, smi))

    # ------------------------------------------------------- the result
    src = {"topk_peaks": ("improved_body_parts_torch/csrc/peaks.cu",
                          "improved_body_parts_tpu/ops/pallas_peaks.py:150"),
           "limb_pair_stats": (
               "improved_body_parts_torch/csrc/limbs.cu",
               "improved_body_parts_tpu/ops/pallas_peaks.py:224"),
           "candidate_walk": (
               "improved_body_parts_torch/csrc/walk.cu",
               "improved_body_parts_tpu/ops/pallas_assembly.py:75"),
           "focal_fwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:98"),
           "focal_bwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:120")}
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k],
                    max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None)
               for k, r in results.items()]
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
