"""Entry points of the port, run as modules:

- ``python -m improved_body_parts_torch.cli.train``: train with ``fit``
  and the async checkpoint (the single-process path of ``tools/train.py``:
  every model variant, the shm ring, GT made on the device, the SWA
  stage, distillation and the run supervisor);
- ``python -m improved_body_parts_torch.cli.swa_stage``: AP before and
  after the SWA stage on a ``cli.synth_ap`` workdir
  (``tools/swa_stage.py``);
- ``python -m improved_body_parts_torch.cli.make_corpus``: COCO
  annotations + images -> the HDF5 corpus (host only);
- ``python -m improved_body_parts_torch.cli.evaluate``: COCO keypoint AP
  of a checkpoint, with pycocotools or the OKS evaluator;
- ``python -m improved_body_parts_torch.cli.synth_ap``: the learn→AP
  protocol on the drawn-person fixture (``tools/synth_ap.py``);
- ``python -m improved_body_parts_torch.cli.demo``: skeletons drawn over
  images;
- ``python -m improved_body_parts_torch.cli.tta_bench``: AP under each
  test-time-augmentation grid, or the grid's fused-vs-looped A/B
  (``tools/tta_bench.py``);
- the tools that measure the port on the card, each the counterpart of
  the JAX package's ``tools/`` script of its name: ``cli.speed_test``
  (network FPS), ``cli.perf_audit`` (audited and chained FPS beside the
  FLOP count, a bytes floor and the profiler's device ms),
  ``cli.train_bench`` (the train step over a batch sweep),
  ``cli.e2e_bench`` (forward plus decode to skeletons in every
  inference mode), ``cli.serve_bench`` (the batcher against
  sequential serving, and the thread- vs process-pool A/B) and
  ``cli.cascade_bench`` (student-first cascade serving against
  teacher-only on a mixed easy / hard stream);
- the fleet plane's tools: ``cli.fleet_audit`` (worker telemetry's
  overhead, conservation, compiles, scrape and crash postmortem on a live
  2-worker ``ProcessRouter``), and two host-side readers that take no
  ``--device``: ``cli.trace_report`` (a span trace and its worker shards
  stitched into one Perfetto file) and ``cli.request_report`` (the
  request records' causal trees, verified);
- the chaos plane: ``cli.chaos_serve`` (seven faults injected into a
  replica pool serving submits, hedged submits and stream sessions:
  zero lost futures, no first run after warmup, no leak), and two more
  host-side readers without ``--device``: ``cli.telemetry_report`` (an
  event stream's steps, bottleneck verdict, first runs, worker shards
  and history companion) and ``cli.history_report`` (a history store's
  shards verified and rendered).

Each runs on ``--device cuda`` unless asked for ``cpu``, and prints, as
its last report, one line ``CLI_REPORT {json}`` with the device it ran on
and the launches of the five kernels in that process
(:func:`exit_report`), so the caller (``cli.synth_ap``) can read them
across the process boundary.
"""
from __future__ import annotations

import fnmatch
import json
import os
import subprocess
from typing import Dict, Iterable, Optional

import torch

from ..obs.events import strict_dumps

REPORT_PREFIX = "CLI_REPORT "


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the five kernel wrappers in this process (the
    plain versions on CPU tensors count nothing)."""
    from ..ops import cuda_assembly, cuda_focal, cuda_peaks

    return {"topk_peaks": cuda_peaks.topk_peaks_kernel.launches,
            "limb_pair_stats": cuda_peaks.limb_pair_stats_kernel.launches,
            "greedy_assemble": cuda_assembly.greedy_assemble_kernel.launches,
            "focal_fwd": cuda_focal.focal_fwd_kernel.launches,
            "focal_bwd": cuda_focal.focal_bwd_kernel.launches}


def exit_report(cli: str, device: torch.device, **fields) -> dict:
    """Print and return the ``CLI_REPORT`` line: the CLI, its device type
    and name, the kernels' launches, and ``fields`` (strict JSON: a
    non-finite number is written as its name)."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    report = {"cli": cli, "device": device.type, "device_name": name,
              "launches": kernel_launches(), **fields}
    print(REPORT_PREFIX + strict_dumps(report), flush=True)
    return report


def parse_reports(stdout: str) -> list:
    """Every ``CLI_REPORT`` object in a CLI's standard output."""
    return [json.loads(line[len(REPORT_PREFIX):])
            for line in stdout.splitlines()
            if line.startswith(REPORT_PREFIX)]


def refuse_artifact(path: str, names: Iterable[str],
                    flag: str = "--out") -> None:
    """Exit with an error when ``path``'s file name matches one of
    ``names`` (fnmatch patterns): the artifacts of the JAX package's
    tools, which the port's tools never write.  ``flag`` names the
    option the path came from."""
    base = os.path.basename(path)
    for pattern in names:
        if fnmatch.fnmatchcase(base, pattern):
            raise SystemExit(f"{flag} {path}: {pattern} is the JAX tool's "
                             "artifact; pick another name")


def refuse_synth_ap_artifact(path: str) -> None:
    """Exit with an error when ``path``'s file name is a ``SYNTH_AP*.json``
    without ``_TORCH`` in it: the names the JAX package's ``synth_ap`` and
    ``swa_stage`` write (``SYNTH_AP_TORCH.json`` and the
    ``*_TORCH_S<n>.json`` names ``cli.ab_summary`` reads stay allowed)."""
    base = os.path.basename(path)
    if fnmatch.fnmatchcase(base, "SYNTH_AP*.json") and "_TORCH" not in base:
        raise SystemExit(f"--out {path}: a SYNTH_AP*.json name without "
                         "_TORCH is the JAX tool's artifact; pick another "
                         "name")


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a CUDA launch returns before the
    work ends, so every timing window closes here); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_stamp(device: torch.device) -> dict:
    """``device`` (the card's name, or ``cpu``) and ``power_limit`` (the
    card's limit as ``nvidia-smi`` reports it; None on the CPU or where
    ``nvidia-smi`` does not answer): what every measured number stands
    beside."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    limit: Optional[str] = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        limit = out.splitlines()[0].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"device": torch.cuda.get_device_name(index),
            "power_limit": limit}


def precision_stamp(model) -> dict:
    """The settings that change both the FLOP rate and the answers: TF32
    for cuDNN convolutions and for matmuls, the model's autocast dtype
    (its ``compute_dtype``) and its parameters' storage dtype."""
    store = next((p.dtype for p in model.parameters()
                  if p.is_floating_point()), None)
    return {"cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "matmul_allow_tf32": bool(
                torch.backends.cuda.matmul.allow_tf32),
            "autocast_dtype": str(getattr(model, "compute_dtype",
                                          torch.float32))[6:],
            "params_dtype": str(store)[6:] if store is not None else None}
