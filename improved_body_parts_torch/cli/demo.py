"""Single-image demo CLI of the port (counterpart of ``tools/demo.py``;
reference: demo_image.py, ``--image/--output``)::

    python -m improved_body_parts_torch.cli.demo \\
        --checkpoint checkpoints/epoch_99 --image person.jpg \\
        --output result.jpg

Runs on ``--device cuda`` unless asked for ``cpu``; prints the people
found, then the ``CLI_REPORT`` line (``cli``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Pose demo")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument("--output", default="result.jpg")
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--device-decode", action="store_true",
                    help="fused decode: the greedy person assembly runs on "
                         "the device; an overflowing crowd falls back to "
                         "the host lane and says so")
    ap.add_argument("--boxsize", type=int, default=0,
                    help="scale the image so its height maps to this "
                         "network input size; 0 keeps the default")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..infer.demo import run_demo
    from . import exit_report
    from .evaluate import load_predictor

    device = resolve_device(args.device)
    predictor = load_predictor(args.config, args.checkpoint, device=device,
                               boxsize=args.boxsize)
    _, (subset, _) = run_demo(predictor, args.image, args.output,
                              use_native=not args.no_native,
                              device_decode=args.device_decode)
    print(f"{len(subset)} people -> {args.output}")
    exit_report("demo", device, config=args.config, people=len(subset))


if __name__ == "__main__":
    main()
