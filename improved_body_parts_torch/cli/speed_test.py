"""Network FPS of the port: the eager forward's last-stack output, timed
over ``--iters`` calls (the port's counterpart of
``tools/speed_test.py``; reference: test_inference_speed.py:90-120,
~38.5 imgs/s at 512x512 on a 2080 Ti, README.md:67)::

    python -m improved_body_parts_torch.cli.speed_test --batch 1 \\
        --size 512 --iters 50

One warm-up call and five more run first (cuDNN's algorithm choice and
the allocator's first blocks are paid there), then ``--iters`` calls are
timed on the host clock up to a device sync: a CUDA launch returns before
the work ends, and a loop timed without the sync measures dispatch.  The
config's bf16 autocast is on unless ``--fp32``; the line printed names
the TF32 settings and the autocast dtype beside the card.  It prints
only (no artifact) and runs on ``--device cuda`` unless asked for
``cpu``.
"""
from __future__ import annotations

import argparse
import time


def _parser():
    ap = argparse.ArgumentParser(description="network FPS benchmark")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fp32", action="store_true",
                    help="turn the config's bf16 autocast off")
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32"],
                    help="weight storage (bf16 halves the weights' bytes "
                         "a pass); auto = bf16 on the card, fp32 on the "
                         "CPU, fp32 under --fp32")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    """Time the forward and print one line; returns its numbers."""
    args = _parser().parse_args(argv)

    import torch

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..utils.precision import resolve_params_dtype
    from . import card_stamp, precision_stamp, sync

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    model = build_model(cfg, dtype=torch.float32 if args.fp32 else None,
                        device=device)
    if args.params_dtype == "auto" and args.fp32:
        # --fp32 is the full-precision baseline: auto does not put bf16
        # weights under it (an explicit --params-dtype wins)
        params_dtype = "fp32"
    else:
        params_dtype = args.params_dtype
    model = resolve_params_dtype(params_dtype, model)
    imgs = torch.zeros((args.batch, args.size, args.size, 3),
                       device=device)

    @torch.inference_mode()
    def forward():
        return model(imgs)[-1][0]

    forward()
    sync(device)
    for _ in range(5):
        forward()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        forward()
    sync(device)
    dt = time.perf_counter() - t0
    out = {"imgs_per_sec": args.iters * args.batch / dt,
           "ms_per_iter": dt / args.iters * 1e3, "batch": args.batch,
           "size": args.size, "iters": args.iters,
           **card_stamp(device), "precision": precision_stamp(model)}
    prec = out["precision"]
    print(f"{out['imgs_per_sec']:.2f} imgs/s  ({out['ms_per_iter']:.2f} "
          f"ms/iter, batch {args.batch}, {args.size}x{args.size}, "
          f"{'fp32' if args.fp32 else 'bf16'}; autocast "
          f"{prec['autocast_dtype']}, params {prec['params_dtype']}, "
          f"cudnn tf32 {prec['cudnn_allow_tf32']}, matmul tf32 "
          f"{prec['matmul_allow_tf32']}; {out['device']}, "
          f"{out['power_limit']})", flush=True)
    return out


if __name__ == "__main__":
    main()
