"""COCO keypoint evaluation CLI of the port (counterpart of
``tools/evaluate.py``; reference: evaluate.py __main__, :625-650)::

    python -m improved_body_parts_torch.cli.evaluate \\
        --checkpoint checkpoints/epoch_99 \\
        --anno annotations/person_keypoints_val2017.json --images val2017

Prints ``AP: <x>``, then the ``CLI_REPORT`` line (``cli``).  Without
pycocotools (or with ``--oks-proxy``) it scores with the dependency-free
OKS evaluator (``infer.oks``).  Runs on ``--device cuda`` unless asked for
``cpu``.  Without ``--fast``, ``--compact``, ``--compact-batch`` or
``--device-decode`` it runs the host full-map protocol
(``Predictor.predict``).  ``--params-dtype`` picks the weight storage
(``utils.precision``; ``auto``: bf16 on the card, fp32 on the CPU).
"""
from __future__ import annotations

import argparse


def load_predictor(config_name: str, checkpoint: str, device="cuda",
                   bucket: int = 128, boxsize: int = 0,
                   params_dtype: str = "auto"):
    """A ``Predictor`` over ``config_name``'s model with the weights of
    ``checkpoint`` (a ``train.checkpoint`` epoch directory), on
    ``device``, stored as ``params_dtype`` says
    (``utils.precision.apply_serve_dtype``)."""
    from ..config import InferenceModelParams, get_config
    from ..infer import Predictor
    from ..models import build_model
    from ..train import restore_checkpoint
    from ..utils.precision import apply_serve_dtype

    cfg = get_config(config_name)
    model = build_model(cfg, device=device)
    model.load_state_dict(restore_checkpoint(checkpoint)["model"],
                          strict=True)
    model = apply_serve_dtype(params_dtype, model)
    model_params = InferenceModelParams(boxsize=boxsize) if boxsize else None
    return Predictor(model, cfg.skeleton, bucket=bucket,
                     model_params=model_params, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="COCO keypoint evaluation")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--anno", required=True,
                    help="person_keypoints_val2017.json")
    ap.add_argument("--images", required=True, help="val2017 image dir")
    ap.add_argument("--max-images", type=int, default=500,
                    help="first-N protocol (reference: evaluate.py:597-598)")
    ap.add_argument("--dump-name", default="cuda")
    ap.add_argument("--no-native", action="store_true",
                    help="use the NumPy decoder instead of the C++ one")
    ap.add_argument("--fast", action="store_true",
                    help="single-scale full-map path: NMS on the device, "
                         "decode on the host at network resolution")
    ap.add_argument("--compact", action="store_true",
                    help="single-scale compact path: peak extraction and "
                         "limb pair scoring on the device")
    ap.add_argument("--compact-batch", type=int, default=0,
                    help="throughput mode: N images + mirrors per dispatch, "
                         "shape-bucketed (implies the compact path)")
    ap.add_argument("--device-decode", action="store_true",
                    help="fused decode: the greedy person assembly runs on "
                         "the device too (implies the compact path; "
                         "overflowing crowds fall back to the host)")
    ap.add_argument("--boxsize", type=int, default=0,
                    help="scale val images so their height maps to this "
                         "network input size; 0 keeps the default")
    ap.add_argument("--params-dtype", default="auto",
                    choices=["auto", "bf16", "fp32", "int8"],
                    help="inference weight storage: auto = bf16 on the "
                         "card, fp32 on the CPU; int8 = weight-only "
                         "per-output-channel quantization, dequantized in "
                         "each layer's forward (utils.precision)")
    ap.add_argument("--oks-proxy", action="store_true",
                    help="score with the dependency-free OKS evaluator "
                         "instead of pycocotools")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..infer.evaluate import validation, validation_oks
    from . import exit_report

    device = resolve_device(args.device)
    use_proxy = args.oks_proxy
    if not use_proxy:
        try:
            from pycocotools.cocoeval import COCOeval  # noqa: F401
        except ImportError:
            print("pycocotools not usable — falling back to the OKS "
                  "evaluator (--oks-proxy)")
            use_proxy = True

    predictor = load_predictor(args.config, args.checkpoint, device=device,
                               boxsize=args.boxsize,
                               params_dtype=args.params_dtype)
    kw = dict(max_images=args.max_images, use_native=not args.no_native,
              fast=args.fast, compact=args.compact,
              compact_batch=args.compact_batch,
              device_decode=args.device_decode, dump_name=args.dump_name)
    if use_proxy:
        ap_value = validation_oks(predictor, args.anno, args.images,
                                  **kw)["AP"]
    else:
        ap_value = validation(predictor, args.anno, args.images,
                              **kw).stats[0]
    print("AP:", ap_value)
    exit_report("evaluate", device, config=args.config, ap=ap_value,
                params_dtype=args.params_dtype)


if __name__ == "__main__":
    main()
