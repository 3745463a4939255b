"""The SWA stage on a ``cli.synth_ap`` workdir, with AP before and after
(counterpart of ``tools/swa_stage.py``)::

    python -m improved_body_parts_torch.cli.synth_ap --config synth_deep \\
        --seed 1 --workdir WORK --keep-workdir --out SYNTH_AP_S1.json
    python -m improved_body_parts_torch.cli.swa_stage --workdir WORK \\
        --config synth_deep --base SYNTH_AP_S1.json --out SYNTH_AP_SWA_S1.json

Continues the workdir's last committed checkpoint through the reference's
SWA protocol (``cli.train --swa --resume auto``: cyclic LR, frozen BN,
the average saved swapped in; train_distributed_SWA.py), then scores the
averaged weights on the workdir's held-out val set with the evaluate CLI
(OKS evaluator) and writes one strict JSON artifact: ``ap_swa``, and with
``--base`` the base run's ``ap_trained`` as ``ap_base`` and the delta.
Both CLIs run as subprocesses on ``--device`` (``cuda`` unless asked for
``cpu``); their ``CLI_REPORT`` lines ride in the artifact.
"""
from __future__ import annotations

import argparse
import json
import os

from .synth_ap import DECODE_FLAGS, parse_ap, run_cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True,
                    help="a synth_ap --keep-workdir directory (train_drawn"
                         ".h5, ckpt/, val/, person_keypoints_synth.json)")
    ap.add_argument("--config", default="synth_deep")
    ap.add_argument("--base", default=None,
                    help="the base run's artifact; its ap_trained becomes "
                         "ap_base")
    ap.add_argument("--epochs", type=int, default=5,
                    help="additional SWA epochs (one --swa-freq cycle by "
                         "default)")
    ap.add_argument("--swa-freq", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--boxsize", type=int, default=0,
                    help="0 = the config's input height")
    ap.add_argument("--decode-path", default="compact",
                    choices=sorted(DECODE_FLAGS))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="SYNTH_AP_SWA.json")
    args = ap.parse_args(argv)

    from ..config import get_config
    from ..obs.events import strict_dump, strict_dumps
    from ..train import latest_checkpoint, read_commit_meta
    from . import parse_reports

    work = os.path.abspath(args.workdir)
    ckpt_dir = os.path.join(work, "ckpt")
    anno = os.path.join(work, "person_keypoints_synth.json")
    val_dir = os.path.join(work, "val")
    h5 = os.path.join(work, "train_drawn.h5")
    for path in (ckpt_dir, anno, val_dir, h5):
        if not os.path.exists(path):
            raise SystemExit(f"not a synth_ap workdir: {path} missing")
    boxsize = args.boxsize or get_config(args.config).skeleton.height

    print(f"SWA stage: +{args.epochs} epochs on {ckpt_dir}", flush=True)
    train_out = run_cli("train", [
        "--config", args.config, "--swa", "--resume", "auto",
        "--epochs", str(args.epochs), "--swa-freq", str(args.swa_freq),
        "--train-h5", h5, "--checkpoint-dir", ckpt_dir, "--workers", "0",
        "--seed", str(args.seed), "--device", args.device], timeout=21600)
    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise RuntimeError(f"no committed checkpoint under {ckpt_dir}")
    meta = read_commit_meta(latest)
    print(f"evaluating SWA checkpoint {latest}", flush=True)
    eval_out = run_cli("evaluate", [
        "--config", args.config, "--checkpoint", latest, "--anno", anno,
        "--images", val_dir, "--boxsize", str(boxsize), "--oks-proxy",
        "--dump-name", "swa", "--device", args.device]
        + DECODE_FLAGS[args.decode_path], timeout=3600, cwd=work)
    ap_swa = parse_ap(eval_out)
    result = {
        "config": args.config, "seed": args.seed,
        "swa_epochs": args.epochs, "swa_freq": args.swa_freq,
        "ap_swa": ap_swa, "checkpoint": latest,
        "checkpoint_meta": ({k: meta[k] for k in
                             ("epoch", "train_loss", "metric",
                              "metric_value") if k in meta}
                            if meta else None),
        "decode_path": args.decode_path, "device": args.device,
        "protocol": "cli.train --swa --resume auto (cyclic LR, frozen BN, "
                    "averaged swap) -> cli.evaluate --oks-proxy on the "
                    "workdir's held-out val",
        "cli_reports": {"train": parse_reports(train_out),
                        "evaluate_swa": parse_reports(eval_out)},
    }
    if args.base:
        with open(args.base) as f:
            base = json.load(f)
        result["ap_base"] = base["ap_trained"]
        result["base_artifact"] = os.path.basename(args.base)
        result["swa_delta"] = round(ap_swa - base["ap_trained"], 6)
    with open(args.out, "w") as f:
        strict_dump(result, f, indent=2)
    print(strict_dumps(result))
    return result


if __name__ == "__main__":
    main()
