"""Audited inference timing of the port: every FPS beside the work it
implies (the port's counterpart of ``tools/perf_audit.py``)::

    python -m improved_body_parts_torch.cli.perf_audit --batches 1 2 4 8 \\
        --out perf_audit_torch.json

The quick benchmark (``cli.speed_test``) times a dispatch loop.  This is
the careful version, for each batch size of ``--batches``:

- random finite inputs (not constant-foldable, not all zeros), the
  output asserted finite;
- throughput: ``--repeats`` repeats of ``--iters`` dispatches, one input
  pixel moved by 1e-3 a dispatch so no two dispatches see the same
  input, each repeat closed by a device sync; median, best and spread;
- the chained latency (``utils.profiling.chained_time``: each step's
  input depends on the previous step's output, so the steps serialize),
  the honest claim;
- the FLOPs of one forward at the step's shape from
  ``torch.utils.flop_counter.FlopCounterMode`` (``gflops_per_step``),
  beside the analytic count over every ``nn.Conv2d`` and ``nn.Linear``
  (2 x Cin/groups x Cout x kh x kw x Ho x Wo x N, and 2 x in x out a
  row).  XLA's ``cost_analysis`` has no counterpart here, and its count
  of the JAX forward is not this one's yardstick;
- a floor on the bytes a forward moves (``min_gbytes_per_step``: the
  parameters and buffers in their storage dtype, the input and the
  output, once each), not a measured count;
- the device ms a forward from ``torch.profiler`` over 20 calls
  (``utils.profiling.profile_device``: every kernel and copy on the
  card, user annotations skipped; a window whose kernels fall short of
  the launches it recorded is profiled again, up to 3 times);
- the implied TFLOP/s and GB/s, flagged when above the card's data-sheet
  peak (:data:`PEAK_TFLOPS`, :data:`PEAK_GBPS`) for the path's precision:
  such a number is a measurement fault, never a result.

The batch-8 entry carries ``vs_baseline`` = its chained FPS / 38.5, the
reference's headline (4-stack IMHN, bf16, 512x512, reference:
test_inference_speed.py:90-120, README.md:67).  The artifact (``--out``,
default ``perf_audit_torch.json``; the JAX tool's ``PERF_AUDIT*.json``
are refused) records the card's name and ``nvidia-smi`` power limit and
the TF32 / autocast settings.  It runs on ``--device cuda`` unless asked
for ``cpu``, where the device metrics are not measured (null).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable

import numpy as np

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("PERF_AUDIT*.json",)

#: One H100 SXM, NVIDIA data sheet, dense (no sparsity), at its 700 W
#: limit: TFLOP/s by the path's math (bf16 tensor cores under autocast or
#: bf16 storage; TF32 tensor cores for fp32 convolutions when cuDNN may
#: use TF32; fp32 outside the tensor cores otherwise), and HBM3 GB/s.
#: Used only to flag an implied rate no card reaches, never to scale one.
PEAK_TFLOPS = {"cuda": {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0},
               "cpu": 1.0}
PEAK_GBPS = {"cuda": 3350.0, "cpu": 50.0}

#: the reference's headline, imgs/s (reference: README.md:67)
BASELINE_FPS = 38.5

def peak_tflops(device_type: str, precision: dict) -> float:
    """The data-sheet peak of the path :func:`cli.precision_stamp`
    describes."""
    peak = PEAK_TFLOPS[device_type]
    if not isinstance(peak, dict):
        return peak
    if "bfloat16" in (precision["autocast_dtype"],
                      precision["params_dtype"]):
        return peak["bfloat16"]
    return peak["tf32" if precision["cudnn_allow_tf32"] else "float32"]


def counted_flops(fn: Callable) -> int:
    """The FLOPs of ``fn()`` by ``torch.utils.flop_counter``: every
    convolution (forward and backward), matmul and attention op run."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def analytic_flops(model, fn: Callable) -> int:
    """The forward FLOPs of ``fn()`` over ``model``'s ``nn.Conv2d`` and
    ``nn.Linear`` layers, from the shapes each call saw: a conv 2 x
    Cin/groups x Cout x kh x kw x Ho x Wo x N, a dense layer 2 x in x out
    a row."""
    from torch import nn

    total = [0]

    def conv(m, inputs, out):
        n, cout, ho, wo = out.shape
        kh, kw = m.kernel_size
        total[0] += (2 * n * ho * wo * cout * (m.in_channels // m.groups)
                     * kh * kw)

    def dense(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d)
                                     else dense)
             for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def state_bytes(model) -> int:
    """Bytes of ``model``'s parameters and buffers in their storage
    dtypes."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def implied(gflops: float, gbytes: float, seconds: float, device_type: str,
            precision: dict):
    """(TFLOP/s, GB/s, flags) of a step that took ``seconds``."""
    tflops = gflops / 1e3 / seconds if gflops else None
    gbps = gbytes / seconds if gbytes else None
    flags = []
    if tflops and tflops > peak_tflops(device_type, precision):
        flags.append(f"IMPLIED {tflops:.0f} TFLOP/s EXCEEDS PEAK")
    if gbps and gbps > PEAK_GBPS[device_type]:
        flags.append(f"IMPLIED {gbps:.0f} GB/s EXCEEDS PEAK HBM BW")
    return tflops, gbps, flags


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--out", default="perf_audit_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    """Audit each batch size and write the artifact; returns its
    document (``batches`` keyed by the batch size)."""
    args = _parser().parse_args(argv)

    import torch

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..obs.events import strict_dump, strict_dumps
    from ..utils.precision import bf16_params
    from ..utils.profiling import chained_time, profile_device
    from . import card_stamp, precision_stamp, refuse_artifact, sync

    refuse_artifact(args.out, JAX_ARTIFACTS)
    device = resolve_device(args.device)
    print(f"platform={device.type}", flush=True)
    cfg = get_config(args.config)
    model = build_model(cfg, device=device)
    if args.bf16_params:
        model = bf16_params(model)
    precision = precision_stamp(model)
    rng = np.random.default_rng(0)

    @torch.inference_mode()
    def forward(x):
        return model(x)[-1][0]

    report = {"platform": device.type, "config": args.config,
              "size": args.size, "iters": args.iters,
              "repeats": args.repeats, "bf16_params": args.bf16_params,
              **card_stamp(device), "precision": precision,
              "peak_tflops": peak_tflops(device.type, precision),
              "peak_gbps": PEAK_GBPS[device.type],
              "peaks_source": "NVIDIA H100 SXM data sheet, dense, 700 W"
              if device.type == "cuda" else "a CPU host's order of "
              "magnitude", "batches": {}}

    def flush():
        with open(args.out, "w") as f:
            strict_dump(report, f, indent=2)

    for b in args.batches:
        x = torch.from_numpy(rng.uniform(0, 1, (b, args.size, args.size, 3))
                             .astype(np.float32)).to(device)
        out = forward(x)
        sync(device)
        assert bool(torch.isfinite(out).all()), \
            f"non-finite outputs at batch {b}"
        flops = counted_flops(lambda: forward(x))
        with torch.inference_mode():
            analytic = analytic_flops(model, lambda: model(x))
        gflops = flops / 1e9
        gbytes = (state_bytes(model) + x.numel() * x.element_size()
                  + out.numel() * out.element_size()) / 1e9

        # throughput: each dispatch moves one pixel of every image by
        # 1e-3 more, so no two dispatches see the same input
        xp = x.clone()
        reps = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                xp[:, :1, :1, :] += 1e-3
                forward(xp)
            sync(device)
            reps.append((time.perf_counter() - t0) / args.iters)
        med, best = statistics.median(reps), min(reps)
        # latency: each next input depends on the previous output
        lat = chained_time(lambda _, xx: forward(xx), None, x,
                           iters=args.iters)
        prof = profile_device(lambda: forward(x), device)
        tflops, gbps, flags = implied(gflops, gbytes, med, device.type,
                                      precision)
        entry = {
            "gflops_per_step": round(gflops, 3),
            "flops_per_step": flops,
            "analytic_flops_per_step": analytic,
            "min_gbytes_per_step": round(gbytes, 4),
            "throughput_fps_median": round(b / med, 2),
            "throughput_fps_best": round(b / best, 2),
            "repeat_spread_ms": [round(r * 1e3, 3) for r in sorted(reps)],
            "chained_latency_ms": round(lat * 1e3, 3),
            "chained_fps": round(b / lat, 2),
            "device_ms": prof["device_ms"],
            "device_kernels_per_step": prof["kernels"],
            "launch_calls_per_step": prof["launch_calls"],
            "implied_tflops": round(tflops, 2) if tflops else None,
            "implied_hbm_gbps": round(gbps, 2) if gbps else None,
            "flags": flags,
        }
        if b == 8:
            entry["vs_baseline"] = round(b / lat / BASELINE_FPS, 3)
        report["batches"][b] = entry
        flush()
        dev_ms = ("not measured" if prof["device_ms"] is None
                  else f"{prof['device_ms']:.2f} ms on the device")
        print(f"batch {b}: {b / med:.1f} fps med ({b / best:.1f} best, "
              f"{b / lat:.1f} chained) | {gflops:.1f} GFLOP/step "
              f"(analytic {analytic / 1e9:.1f}) -> {tflops or 0:.1f} "
              f"TFLOP/s, >= {gbytes:.3f} GB/step -> {gbps or 0:.0f} GB/s; "
              f"{dev_ms} {flags}", flush=True)

    print(strict_dumps(report))
    return report


if __name__ == "__main__":
    main()
