"""Train-step throughput of the port over a batch sweep (the port's
counterpart of ``tools/train_bench.py``)::

    python -m improved_body_parts_torch.cli.train_bench --batches 2 4 8 \\
        --out train_bench_torch.json

Times the real train step (``train.make_train_step``: forward, the
multi-scale focal L2 on the focal kernels, backward, the guarded SGD
update, BN batch stats) at ``--size`` on random images and labels, for
each batch of ``--batches``: one untimed first step (cuDNN's algorithm
choice and the allocator's first blocks, asserted finite), then
``--repeats`` repeats of ``--steps`` steps, each repeat closed by a
device sync.  The reference trains at batch 4 a GPU and publishes no
imgs/s for training (reference: config/config.py:10, README.md:34).

Beside each timing: the FLOPs of one step (forward and backward, by
``torch.utils.flop_counter.FlopCounterMode``), a floor on its bytes
(the model's parameters and buffers and the optimizer's momentum, read
once and written once, and the batch read once), the focal kernels'
launches a step, and from ``torch.profiler`` over two steps the card's
ms a step (its busy share of the step) and the host's kernel-launch
calls a step, ``cudaLaunchKernel``'s apart (``chip_smoke.py`` phase 6's
reading): the layer figures that say whether the step is bound by the
host's dispatch, in which case its ms barely move with the batch.
``--device-gt`` also times the step that makes its labels on the card
(``ops.gt_device``) at the last batch size.

The artifact (``--out``, default ``train_bench_torch.json``; the JAX
tool's ``TRAIN_BENCH.json`` is refused) records the card's name and
``nvidia-smi`` power limit and the TF32 / autocast settings.  It runs on
``--device cuda`` unless asked for ``cpu``, where the device metrics
are not measured (null).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("TRAIN_BENCH.json",)


def optimizer_bytes(opt) -> int:
    """Bytes of the optimizer's state tensors (the momentum buffers)."""
    import torch

    return sum(t.numel() * t.element_size()
               for st in opt.sgd.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device-gt", action="store_true",
                    help="also time the step that makes its labels on the "
                         "device")
    ap.add_argument("--out", default="train_bench_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def _repeats(step, state, batch, args, device):
    """Seconds a step in each of ``--repeats`` repeats of ``--steps``."""
    from . import sync

    reps = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, *batch)
        sync(device)
        reps.append((time.perf_counter() - t0) / args.steps)
    return reps


def main(argv=None) -> dict:
    """Time the sweep and write the artifact; returns its document
    (``batches`` keyed by the batch size)."""
    args = _parser().parse_args(argv)

    import torch

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..obs.events import strict_dump, strict_dumps
    from ..ops import cuda_focal
    from ..train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )
    from . import card_stamp, precision_stamp, refuse_artifact, sync
    from ..utils.profiling import profile_device
    from .perf_audit import counted_flops, implied, state_bytes

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    print(f"platform={device.type}", flush=True)
    cfg = get_config(args.config)
    sk = cfg.skeleton
    label_hw = args.size // sk.stride
    rng = np.random.default_rng(0)
    model = build_model(cfg, device=device, seed=0, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        cfg.train, steps_per_epoch=100))
    state = create_train_state(model, cfg, opt)
    step = make_train_step(model, cfg, opt)
    precision = precision_stamp(model)

    report = {"platform": device.type, "config": args.config,
              "size": args.size, "steps": args.steps,
              "repeats": args.repeats, **card_stamp(device),
              "precision": precision, "batches": {}}

    def flush():
        with open(args.out, "w") as f:
            strict_dump(report, f, indent=2)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    for b in args.batches:
        batch = (tensor(rng.uniform(0, 1, (b, args.size, args.size, 3))),
                 torch.ones((b, label_hw, label_hw, 1), device=device),
                 tensor(rng.uniform(0, 1, (b, label_hw, label_hw,
                                           sk.num_layers))))
        state, loss = step(state, *batch)
        sync(device)
        assert np.isfinite(float(loss)), f"non-finite loss at batch {b}"
        flops = counted_flops(lambda: step(state, *batch))
        gflops = flops / 1e9
        gbytes = (2 * (state_bytes(model) + optimizer_bytes(opt))
                  + sum(t.numel() * t.element_size() for t in batch)) / 1e9

        focal0 = (cuda_focal.focal_fwd_kernel.launches,
                  cuda_focal.focal_bwd_kernel.launches)
        reps = _repeats(step, state, batch, args, device)
        timed = args.repeats * args.steps
        focal = [(k.launches - n0) / timed for k, n0 in zip(
            (cuda_focal.focal_fwd_kernel, cuda_focal.focal_bwd_kernel),
            focal0)]
        med = statistics.median(reps)
        prof = profile_device(lambda: step(state, *batch), device, calls=2)
        tflops, gbps, flags = implied(gflops, gbytes, med, device.type,
                                      precision)
        entry = {
            "step_ms_median": round(med * 1e3, 3),
            "imgs_per_sec": round(b / med, 2),
            "repeat_spread_ms": [round(r * 1e3, 3) for r in sorted(reps)],
            "gflops_per_step": round(gflops, 3),
            "flops_per_step": flops,
            "min_gbytes_per_step": round(gbytes, 4),
            "implied_tflops": round(tflops, 2) if tflops else None,
            "implied_hbm_gbps": round(gbps, 2) if gbps else None,
            "flags": flags,
            "focal_fwd_launches_per_step": focal[0],
            "focal_bwd_launches_per_step": focal[1],
            "device_ms_per_step": prof["device_ms"],
            "device_busy_share": (round(prof["device_ms"] / (med * 1e3), 4)
                                  if prof["device_ms"] is not None
                                  else None),
            "device_kernels_per_step": prof["kernels"],
            "launch_calls_per_step": prof["launch_calls"],
            "cuda_launch_kernel_per_step": prof["cuda_launch_kernel"],
        }
        report["batches"][b] = entry
        flush()
        busy = ("busy not measured" if prof["device_ms"] is None else
                f"device {prof['device_ms']:.1f} ms a step "
                f"({entry['device_busy_share']:.1%} busy), "
                f"{prof['cuda_launch_kernel']:.0f} cudaLaunchKernel a step")
        print(f"batch {b}: {b / med:7.2f} imgs/s  ({med * 1e3:.1f} ms/step, "
              f"{gflops:.0f} GFLOP -> {entry['implied_tflops']} TFLOP/s; "
              f"focal {focal[0]:.0f} + {focal[1]:.0f} launches a step; "
              f"{busy}) {flags}", flush=True)

    grid_h, grid_w = sk.grid_shape
    if args.device_gt and (label_hw, label_hw) != (grid_h, grid_w):
        # the on-device synthesizer makes labels on the config's grid; a
        # mismatched --size would mis-size the loss
        print(f"skipping --device-gt: size {args.size} gives a "
              f"{label_hw}x{label_hw} grid but config '{args.config}' "
              f"synthesizes at {grid_h}x{grid_w}", flush=True)
        report["device_gt"] = {"skipped": f"size {args.size} != config grid"}
        flush()
        args.device_gt = False

    if args.device_gt:
        b = args.batches[-1]
        max_people = 8
        joints = rng.uniform(0, args.size, (b, max_people, sk.num_parts, 3))
        joints[..., 2] = rng.integers(0, 2, joints.shape[:-1])  # visible
        batch = (tensor(rng.uniform(0, 1, (b, args.size, args.size, 3))),
                 torch.ones((b, label_hw, label_hw, 1), device=device),
                 tensor(joints),
                 torch.ones((b, label_hw, label_hw, 1), device=device))
        gt_step = make_train_step(model, cfg, opt, device_gt=True)
        state, loss = gt_step(state, *batch)
        sync(device)
        assert np.isfinite(float(loss)), "non-finite loss, device GT"
        reps = _repeats(gt_step, state, batch, args, device)
        dt = statistics.median(reps)
        report["device_gt"] = {
            "batch": b, "step_ms_median": round(dt * 1e3, 3),
            "imgs_per_sec": round(b / dt, 2),
            "repeat_spread_ms": [round(r * 1e3, 3) for r in sorted(reps)]}
        flush()
        print(f"device-gt batch {b}: {b / dt:.2f} imgs/s", flush=True)

    print(strict_dumps(report))
    return report


if __name__ == "__main__":
    main()
