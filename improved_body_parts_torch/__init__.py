"""PyTorch + CUDA port of ``improved_body_parts_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module names (``config``,
``models``, ``ops``, ``infer``, ``data``, ``train``, ``utils``) and keeps
its public layouts (NHWC maps, ``(C, K)`` / ``(L, M)`` decode records),
so each counterpart is easy to find and the tests compare like with
like.  It imports ``torch`` and
numpy (and cv2, h5py for the data pipeline) only, never ``jax`` and
nothing of the JAX package.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request it raises
(:func:`resolve_device`).  The kernels (``csrc/*.cu``) are built
with ``nvcc`` at first use (``ops/_build.py``); on a CPU tensor each
wrapper runs its kernel's plain PyTorch version instead.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for.  Never falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (the op launches its kernel),
    False on the CPU (the op runs the kernel's plain version); raises for
    any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the port runs on "
                     "'cuda', or on 'cpu' when asked")
