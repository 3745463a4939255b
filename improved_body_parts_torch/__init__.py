"""PyTorch + CUDA port of ``improved_body_parts_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module names (``config``,
``models``, ``ops``, ``infer``, ``data``, ``train``, ``serve``, ``obs``,
``utils``; its entry points, the JAX package's ``tools/``, are the
modules of ``cli``) and keeps
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

import functools

# torch is imported where it is used, not here: a spawned ring worker
# imports this package (``data.shm_ring`` says which modules, and a test
# holds a worker to it), so it starts without torch's import


def resolve_device(device="cuda") -> "torch.device":
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for.  Never falls back to the CPU quietly."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def use_kernel(t: "torch.Tensor") -> bool:
    """True when ``t`` lies on a CUDA device (the op launches its kernel),
    False on the CPU (the op runs the kernel's plain version); raises for
    any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the port runs on "
                     "'cuda', or on 'cpu' when asked")


def device_tensor(values: tuple, device: "torch.device",
                  dtype: "torch.dtype" = None) -> "torch.Tensor":
    """``values`` as a tensor on ``device`` (int64 unless ``dtype`` says
    otherwise), made once per (values, device, dtype) and shared: callers
    must not write to it.  A blocking copy from host memory makes PyTorch
    wait for the stream's queued work, so the serve lane takes its
    constant index tensors from here instead of copying them at each
    call."""
    import torch

    return _device_tensor(values, device, dtype or torch.int64)


@functools.lru_cache(maxsize=None)
def _device_tensor(values, device, dtype):
    import torch

    return torch.tensor(values, dtype=dtype).to(device)
