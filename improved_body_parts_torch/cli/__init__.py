"""Entry points of the port, run as modules:

- ``python -m improved_body_parts_torch.cli.train``: train with ``fit``
  and the async checkpoint (the single-process path of ``tools/train.py``);
- ``python -m improved_body_parts_torch.cli.evaluate``: COCO keypoint AP
  of a checkpoint, with pycocotools or the OKS evaluator;
- ``python -m improved_body_parts_torch.cli.synth_ap``: the learn→AP
  protocol on the drawn-person fixture (``tools/synth_ap.py``);
- ``python -m improved_body_parts_torch.cli.demo``: skeletons drawn over
  images;
- ``python -m improved_body_parts_torch.cli.tta_bench``: AP under each
  test-time-augmentation grid, or the grid's fused-vs-looped A/B
  (``tools/tta_bench.py``).

Each runs on ``--device cuda`` unless asked for ``cpu``, and prints, as
its last report, one line ``CLI_REPORT {json}`` with the device it ran on
and the launches of the five kernels in that process
(:func:`exit_report`), so the caller (``cli.synth_ap``) can read them
across the process boundary.
"""
from __future__ import annotations

import json
from typing import Dict

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
