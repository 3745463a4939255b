"""Learn→AP protocol on the drawn-person fixture (counterpart of
``tools/synth_ap.py``)::

    python -m improved_body_parts_torch.cli.synth_ap --config synth_canonical \\
        --train-images 32 --val-images 12 --canvas 288 384 --epochs 18 \\
        --seed 0 --val-seed 12345 --decode-path device

Builds the drawn training corpus (HDF5) and a held-out val set (jpgs and
a COCO keypoint JSON, another seed), trains with the port's train CLI,
evaluates the last committed checkpoint with the port's evaluate CLI
(OKS evaluator, ``--boxsize`` = the network size), and evaluates a
fresh-init checkpoint of the same seed for contrast.  The CLIs run as
subprocesses on ``--device`` (``cuda`` unless asked for ``cpu``).  Writes
one strict JSON artifact (``--out``, default ``SYNTH_AP_TORCH.json``; a
``SYNTH_AP*.json`` name without ``_TORCH``, the JAX tool's, is refused
before any work) with the JAX tool's keys, plus each CLI's
``CLI_REPORT`` (device, kernel launches, timings).

``--decode-path``: ``full`` (the host full-map protocol,
``Predictor.predict``), ``fast`` (full maps, host decode), ``compact``
(device records, host assembly) or ``device`` (the fused lane).
``--dtype-matrix`` evaluates the trained checkpoint again with bf16 and
int8 weight storage (the evaluate CLI's ``--params-dtype``), writes
``ap_trained_bf16``, ``ap_trained_int8``, ``int8_vs_bf16_ap_delta`` and
``int8_within_tolerance`` (|AP(int8) - AP(bf16)| <= 0.01), and exits 1
when the bound is broken.  ``--workers N`` (shm-ring workers; 0, the
default, trains in-process) and ``--device-gt MAX_PEOPLE`` (the GT maps
made on the device) are passed to the train CLI.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "improved_body_parts_torch"
DECODE_FLAGS = {"full": [], "fast": ["--fast"], "compact": ["--compact"],
                "device": ["--device-decode"]}
INT8_AP_TOLERANCE = 0.01  # one synthetic-AP point


def run_cli(module: str, args, timeout: float, cwd=None) -> str:
    """Run ``python -m improved_body_parts_torch.cli.<module> args``; its
    standard output, or RuntimeError with both streams' tails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.cli.{module}"] + list(args),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=cwd)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cli.{module} failed rc={proc.returncode}\n"
            f"stdout: {proc.stdout[-2000:]}\nstderr: {proc.stderr[-2000:]}")
    return proc.stdout


def parse_ap(stdout: str) -> float:
    # floats in any notation Python prints: 0.42, 9.9e-05, nan
    m = re.search(r"^AP: ([0-9.eE+-]+|nan)$", stdout, re.MULTILINE)
    if not m:
        raise RuntimeError(f"no AP line in output tail: {stdout[-800:]}")
    return float(m.group(1))


def epoch_losses(checkpoint_dir: str) -> list:
    """The train losses of the append-only epoch log, in order."""
    with open(os.path.join(checkpoint_dir, "log")) as f:
        return [float(v) for v in
                re.findall(r"train_loss: ([0-9.eE+-]+|nan|inf)", f.read())]


def save_fresh_checkpoint(config_name: str, directory: str, seed: int
                          ) -> str:
    """An untrained checkpoint (the train CLI's init for ``seed``, built on
    the CPU), for the baseline evaluation."""
    from ..config import get_config
    from ..models import build_model
    from ..train import TrainState, save_checkpoint

    model = build_model(get_config(config_name), device="cpu", seed=seed)
    return save_checkpoint(directory, TrainState(model=model,
                                                 optimizer=None),
                           0, float("inf"), float("inf"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="synthetic learn->AP protocol (PyTorch port)")
    ap.add_argument("--config", default="synth")
    ap.add_argument("--train-images", type=int, default=96)
    ap.add_argument("--val-images", type=int, default=24)
    ap.add_argument("--people", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=0,
                    help="0 = the config's own epoch budget")
    ap.add_argument("--canvas", type=int, nargs=2, default=(192, 256),
                    metavar=("H", "W"))
    ap.add_argument("--workdir", default=None,
                    help="default: a fresh temp dir")
    ap.add_argument("--out", default="SYNTH_AP_TORCH.json")
    ap.add_argument("--decode-path", default="compact",
                    choices=sorted(DECODE_FLAGS))
    ap.add_argument("--dtype-matrix", action="store_true",
                    help="also evaluate the trained checkpoint with bf16 "
                         "and int8 weight storage; exit 1 when "
                         "|AP(int8) - AP(bf16)| > 0.01")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override the config learning rate (passed to "
                         "the train CLI)")
    ap.add_argument("--workers", type=int, default=0,
                    help="shm-ring workers of the train CLI; 0 (in-process) "
                         "is fastest on few-core hosts: each spawned worker "
                         "imports torch")
    ap.add_argument("--crowd", action="store_true",
                    help="render unannotated people + crowd regions into "
                         "train and val (miss-masked in training, "
                         "iscrowd-ignored in eval)")
    ap.add_argument("--no-miss-mask", action="store_true",
                    help="ablation for --crowd: mask_miss forced to ones")
    ap.add_argument("--device-gt", type=int, default=0,
                    help="train with the GT maps made on the device "
                         "(--device-gt N = max people a sample, passed to "
                         "the train CLI)")
    ap.add_argument("--train-timeout", type=int, default=0,
                    help="seconds before the train subprocess is killed; "
                         "0 = 600 s an epoch + 1 h, at least 2 h")
    ap.add_argument("--hard", action="store_true",
                    help="harder corpus tier: wider scales, rotations up "
                         "to +-60 deg, in train and val")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the train corpus and the train CLI; the "
                         "val set keeps --val-seed")
    ap.add_argument("--val-seed", type=int, default=12345)
    ap.add_argument("--keep-workdir", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the train and evaluate CLIs: 'cuda' "
                         "(default) or 'cpu'")
    args = ap.parse_args(argv)

    from . import parse_reports, refuse_synth_ap_artifact

    refuse_synth_ap_artifact(args.out)
    from ..config import get_config
    from ..data.fixture import build_fixture, build_val_set
    from ..obs.events import strict_dump, strict_dumps
    from ..train import latest_checkpoint

    work = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix="synth_ap_"))
    os.makedirs(work, exist_ok=True)
    cfg = get_config(args.config)
    epochs = args.epochs or cfg.train.epochs
    net_size = cfg.skeleton.height
    canvas = tuple(args.canvas)

    corpus = os.path.join(work, "train_drawn.h5")
    n_rec = build_fixture(corpus, num_images=args.train_images,
                          people_per_image=args.people, img_size=canvas,
                          image_size=net_size, seed=args.seed, drawn=True,
                          crowd=args.crowd, hard=args.hard,
                          mask_extras=not args.no_miss_mask)
    val_dir = os.path.join(work, "val")
    anno = os.path.join(work, "person_keypoints_synth.json")
    n_val = build_val_set(val_dir, anno, num_images=args.val_images,
                          people_per_image=args.people, img_size=canvas,
                          image_size=net_size, seed=args.val_seed, drawn=True,
                          crowd=args.crowd, hard=args.hard)
    print(f"corpus: {n_rec} records; val: {n_val} persons "
          f"({args.val_images} images)", flush=True)

    ckpt_dir = os.path.join(work, "ckpt")
    print(f"training {args.config} for {epochs} epochs on {args.device}...",
          flush=True)
    train_args = ["--config", args.config, "--epochs", str(epochs),
                  "--train-h5", corpus, "--checkpoint-dir", ckpt_dir,
                  "--workers", str(args.workers),
                  "--print-freq", "20", "--seed", str(args.seed),
                  "--device", args.device]
    if args.lr:
        train_args += ["--lr", str(args.lr)]
    if args.device_gt:
        train_args += ["--device-gt", str(args.device_gt)]
    train_out = run_cli("train", train_args,
                        timeout=args.train_timeout
                        or max(7200, 600 * epochs + 3600))
    losses = epoch_losses(ckpt_dir)
    print(f"loss first->last: {losses[0] if losses else '?'} -> "
          f"{losses[-1] if losses else '?'}", flush=True)
    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise RuntimeError(f"no committed checkpoint under {ckpt_dir}")

    # --dump-name is a name fragment (the dump lands under the eval
    # subprocess's cwd as results/person_keypoints_<name>.json), so the
    # evals run in the workdir under distinct names
    eval_args = ["--config", args.config, "--anno", anno,
                 "--images", val_dir, "--oks-proxy",
                 "--boxsize", str(net_size), "--device", args.device
                 ] + DECODE_FLAGS[args.decode_path]
    print("evaluating trained checkpoint...", flush=True)
    trained_out = run_cli("evaluate", eval_args + [
        "--checkpoint", latest, "--dump-name", "synth_trained"],
        timeout=3600, cwd=work)

    dtype_matrix, dtype_outs = {}, {}
    if args.dtype_matrix:
        # the same checkpoint, val set and decode path: only the weight
        # storage varies, so the AP deltas are the storage's own effect
        for dtype in ("bf16", "int8"):
            print(f"evaluating trained checkpoint @ {dtype}...", flush=True)
            dtype_outs[dtype] = run_cli("evaluate", eval_args + [
                "--checkpoint", latest, "--params-dtype", dtype,
                "--dump-name", f"synth_trained_{dtype}"],
                timeout=3600, cwd=work)
            dtype_matrix[dtype] = parse_ap(dtype_outs[dtype])

    # contrast: the untrained init through the same protocol — shows the
    # AP is learned, not an artifact of the decoder
    fresh = save_fresh_checkpoint(args.config,
                                  os.path.join(work, "ckpt_fresh"),
                                  args.seed)
    print("evaluating untrained baseline...", flush=True)
    fresh_out = run_cli("evaluate", eval_args + [
        "--checkpoint", fresh, "--dump-name", "synth_fresh"],
        timeout=3600, cwd=work)

    result = {
        "config": args.config,
        "train_images": args.train_images, "train_records": n_rec,
        "val_images": args.val_images, "val_persons": n_val,
        "epochs": epochs, "people_per_image": args.people,
        "lr": args.lr or cfg.train.learning_rate_per_device,
        "canvas": list(canvas), "decode_path": args.decode_path,
        "crowd": args.crowd, "miss_mask": not args.no_miss_mask,
        "device_gt": args.device_gt,
        "seed": args.seed, "val_seed": args.val_seed, "hard": args.hard,
        "train_platform": args.device, "eval_platform": args.device,
        "train_loss_first": losses[0] if losses else None,
        "train_loss_last": losses[-1] if losses else None,
        "train_loss_curve": losses,
        "ap_trained": parse_ap(trained_out),
        "ap_untrained": parse_ap(fresh_out),
        "protocol": "drawn-person fixture; held-out val (different seed); "
                    "OKS evaluator; the port's train/evaluate CLIs as "
                    "subprocesses",
        "checkpoint": latest,
        "workdir": work if (args.keep_workdir or args.workdir) else None,
        "cli_reports": {"train": parse_reports(train_out),
                        "evaluate_trained": parse_reports(trained_out),
                        "evaluate_untrained": parse_reports(fresh_out),
                        **{f"evaluate_trained_{d}": parse_reports(out)
                           for d, out in dtype_outs.items()}},
    }
    if args.dtype_matrix:
        delta = abs(dtype_matrix["int8"] - dtype_matrix["bf16"])
        result["ap_trained_bf16"] = dtype_matrix["bf16"]
        result["ap_trained_int8"] = dtype_matrix["int8"]
        result["int8_vs_bf16_ap_delta"] = round(delta, 6)
        result["int8_ap_tolerance"] = INT8_AP_TOLERANCE
        result["int8_within_tolerance"] = bool(delta <= INT8_AP_TOLERANCE)
    with open(args.out, "w") as f:
        strict_dump(result, f, indent=2)
    print(strict_dumps(result))
    if not args.keep_workdir and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    if args.dtype_matrix and not result["int8_within_tolerance"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
