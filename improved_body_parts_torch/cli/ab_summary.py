"""Seed-replicated A/B artifacts of ``cli.synth_ap`` into mean ± spread
claims (counterpart of ``tools/ab_summary.py``)::

    python -m improved_body_parts_torch.cli.ab_summary --dir runs \\
        --out ab_summary_torch.json

Reads the port's per-seed ``cli.synth_ap`` artifacts, named as the JAX
tool's with ``_TORCH`` before the seed (``SYNTH_AP_DEEP_TORCH_S<n>.json``,
``SYNTH_AP_DEEP_SWA_TORCH_S<n>.json``, ``SYNTH_AP_DEEP_DEVICEGT_TORCH_
S<n>.json``, ``SYNTH_AP_CROWD_TORCH_S<n>.json``,
``SYNTH_AP_CROWD_UNMASKED_TORCH_S<n>.json``), never the JAX package's,
and compares each pair of arms over their common seeds with the JAX
tool's rules: a mean delta no larger than the across-seed spread of
either arm, with per-seed deltas of both signs, is "neutral"; one seed
is "insufficient seeds".  Writes ``ab_summary_torch.json`` (``--out``;
the JAX tool's ``AB_SUMMARY.json`` is refused).  A host-side reader of
JSON files: it touches no device and takes no ``--device``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

#: artifacts of the JAX package's tool, which this CLI never writes
JAX_ARTIFACTS = ("AB_SUMMARY.json",)

#: arm -> (file pattern, AP key), the JAX tool's patterns with _TORCH
ARMS = {
    "base": ("SYNTH_AP_DEEP_TORCH_S[0-9]*.json", "ap_trained"),
    "swa": ("SYNTH_AP_DEEP_SWA_TORCH_S[0-9]*.json", "ap_swa"),
    "devgt": ("SYNTH_AP_DEEP_DEVICEGT_TORCH_S[0-9]*.json", "ap_trained"),
    "crowd": ("SYNTH_AP_CROWD_TORCH_S[0-9]*.json", "ap_trained"),
    "uncrowd": ("SYNTH_AP_CROWD_UNMASKED_TORCH_S[0-9]*.json", "ap_trained"),
}


def _stats(vals):
    n = len(vals)
    mean = sum(vals) / n
    spread = max(vals) - min(vals)
    sd = (sum((v - mean) ** 2 for v in vals) / (n - 1)) ** 0.5 if n > 1 \
        else 0.0
    return {"n": n, "mean": round(mean, 4), "min": round(min(vals), 4),
            "max": round(max(vals), 4), "range": round(spread, 4),
            "sd": round(sd, 4), "values": [round(v, 4) for v in vals]}


def _collect(pattern, key="ap_trained"):
    """seed -> (AP, file name) over the files matching ``pattern``."""
    out = {}
    for path in sorted(glob.glob(pattern)):
        seed_m = re.search(r"_S(\d+)\.json$", path)
        seed = int(seed_m.group(1)) if seed_m else 0
        with open(path) as f:
            out[seed] = (float(json.load(f)[key]), os.path.basename(path))
    return out


def _pair(arm_a, arm_b, label_a, label_b):
    """Compare two arms over their common seeds."""
    seeds = sorted(set(arm_a) & set(arm_b))
    if not seeds:
        return {"note": f"no common seeds yet ({label_a}: {sorted(arm_a)}, "
                        f"{label_b}: {sorted(arm_b)})"}
    a = [arm_a[s][0] for s in seeds]
    b = [arm_b[s][0] for s in seeds]
    delta = sum(x - y for x, y in zip(a, b)) / len(seeds)
    per_seed = [round(x - y, 4) for x, y in zip(a, b)]
    spread = max(_stats(a)["range"], _stats(b)["range"], 1e-9)
    consistent = all(d > 0 for d in per_seed) or all(d < 0 for d in per_seed)
    if len(seeds) < 2:
        # one seed is the single-run claim this tool exists to retire
        verdict = "insufficient seeds (n=1; no spread evidence)"
    elif abs(delta) <= spread and not consistent:
        verdict = "neutral (|delta| <= across-seed spread)"
    else:
        verdict = (f"{label_a} wins" if delta > 0 else f"{label_b} wins")
    return {"seeds": seeds, label_a: _stats(a), label_b: _stats(b),
            "mean_delta": round(delta, 4), "per_seed_delta": per_seed,
            "across_seed_spread": round(spread, 4),
            "delta_sign_consistent": consistent, "verdict": verdict,
            "sources": sorted({arm_a[s][1] for s in seeds}
                              | {arm_b[s][1] for s in seeds})}


def summarize(directory: str) -> dict:
    """The three comparisons over the port's artifacts in ``directory``."""
    arms = {name: _collect(os.path.join(directory, pattern), key)
            for name, (pattern, key) in ARMS.items()}
    return {
        "protocol": "per-seed pairs share corpus seed, init seed and the "
                    "val set; the port's cli.synth_ap artifacts "
                    "(*_TORCH_S<n>.json)",
        "swa_vs_base": _pair(arms["swa"], arms["base"], "swa", "base"),
        "devgt_vs_hostgt": _pair(arms["devgt"], arms["base"], "device_gt",
                                 "host_gt"),
        "crowd_masked_vs_ablated": _pair(arms["crowd"], arms["uncrowd"],
                                         "masked", "mask_ablated"),
    }


def main(argv=None) -> dict:
    from ..obs.events import strict_dump, strict_dumps
    from . import refuse_artifact

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=".")
    ap.add_argument("--out", default="ab_summary_torch.json")
    args = ap.parse_args(argv)
    refuse_artifact(args.out, JAX_ARTIFACTS)
    summary = summarize(args.dir)
    with open(args.out, "w") as f:
        strict_dump(summary, f, indent=2)
    print(strict_dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
