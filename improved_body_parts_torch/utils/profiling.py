"""Profiling helpers (the port's counterpart of
``improved_body_parts_tpu/utils/profiling.py``).

The reference's tracing is wall-clock meters around cuda.synchronize
(reference: train_distributed.py:285-298, test_inference_speed.py:106-115).
On the card the first-class tool is ``torch.profiler``:
:func:`profile_trace` captures a device trace and exports it as a Chrome
trace, :func:`timed` wall-clocks a block, :func:`chained_time` times
a serialized chain of forwards with CUDA events, and
:func:`device_window` / :func:`profile_device` read the card's own time
out of a profiler window (the one reading of device time that the
measuring tools and ``chip_smoke.py`` share).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import Callable, Iterator, Optional

import torch

from .meters import AverageMeter


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (CPU activity,
    and CUDA activity when a card is present) and export it as a Chrome
    trace, ``<log_dir>/trace.json`` (viewable in Perfetto or
    ``chrome://tracing``).

    The capture window is reported into the process's telemetry event
    stream (``trace_start`` / ``trace_stop`` records carrying the log
    dir and the trace file) whenever a run installed a sink, so a
    capture never sits on disk with nothing in the run's history saying
    when it was taken."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from ..obs.events import get_sink

    log_dir = os.path.abspath(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    get_sink().emit("trace_start", log_dir=log_dir)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        get_sink().emit("trace_stop", log_dir=log_dir, path=path,
                        duration_s=round(time.perf_counter() - t0, 6))


def _sync(value) -> None:
    """Wait for the card's work on ``value``'s device (the
    ``jax.block_until_ready`` counterpart); nothing to wait for on the
    CPU."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


@contextlib.contextmanager
def timed(label: str, meter: Optional[AverageMeter] = None,
          sync_value=None, log_fn=None) -> Iterator[None]:
    """Wall-clock a block; pass a tensor as ``sync_value`` to wait for
    its device's work first (the cuda.synchronize of the reference).

    The report goes to the process's telemetry event sink when a run
    installed one (``obs.events.set_sink`` / ``obs.RunTelemetry``) as a
    structured ``timed`` record; otherwise to ``log_fn`` (default:
    ``print``) — so library code stops writing to stdout the moment a
    run turns telemetry on, without every call site changing.
    """
    t0 = time.perf_counter()
    yield
    if sync_value is not None:
        _sync(sync_value)
    dt = time.perf_counter() - t0
    if meter is not None:
        meter.update(dt)
    from ..obs.events import get_sink

    sink = get_sink()
    if sink.enabled:
        sink.emit("timed", label=label, duration_s=round(dt, 6))
    else:
        (log_fn or print)(f"[{label}] {dt * 1000:.2f} ms")


def _first_leaf(out) -> torch.Tensor:
    """The first tensor of a forward's output (PoseNet returns nested
    ``[stack][scale]`` lists)."""
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


@torch.no_grad()
def chained_time(forward, variables, x: torch.Tensor, iters: int = 50,
                 warmup: int = 2) -> float:
    """Seconds per SERIALIZED step of ``forward(variables, x)``.

    Each step's input is ``x`` plus that step's slice of a seeded-fresh
    bank of small noise plus a bounded function of the previous step's
    output, so the steps run one after another and no two see the same
    values (the JAX package's chain, which it runs as one ``lax.scan``
    program).  Here the chain is ``iters`` eager forwards on ``x``'s
    device; the bank is drawn on that device beforehand.  On the card
    the chain is timed with CUDA events around it; on an explicit CPU
    device with ``time.perf_counter``.  ``warmup`` untimed chain steps
    run first (the first run of a shape pays cuDNN's choice and the
    allocator's first blocks)."""
    import os

    dev = x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int.from_bytes(os.urandom(4), "little"))

    def bank(n: int) -> torch.Tensor:
        return torch.rand((n, *x.shape[1:]), generator=gen, device=dev,
                          dtype=x.dtype) * 1e-3

    def chain(noise: torch.Tensor) -> torch.Tensor:
        prev = None
        for ns in noise:
            dep = (torch.tanh(_first_leaf(prev)[..., :1, :1, :1].sum())
                   * 1e-5 if prev is not None else 0.0)
            prev = forward(variables, x + ns + dep)
        return _first_leaf(prev)[..., :1, :1, :1].sum()

    float(chain(bank(max(1, int(warmup)))))
    noise = bank(iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(noise)
        end.record()
        float(out)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    float(chain(noise))
    return (time.perf_counter() - t0) / iters


_LAUNCH = re.compile(r"^cu(da)?LaunchKernel")
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class DeviceWindow:
    """What one profiler window saw (:func:`device_window`)."""

    activity: dict          # {name: [ns, records]}: kernels, copies, sets
    launch_calls: int       # the host's kernel-launch API calls
    cuda_launch_kernel: int  # of those, ``cudaLaunchKernel``'s
    wall_s: float           # host clock over the calls and the last sync
    prof: object            # the profiler (its host tables under cpu=True)

    @property
    def device_ns(self) -> int:
        """Every kernel, copy and set the card ran in the window."""
        return sum(ns for ns, _ in self.activity.values())

    @property
    def kernels(self) -> int:
        """Kernel records (copies and sets apart)."""
        return sum(n for name, (_, n) in self.activity.items()
                   if not name.startswith(_NOT_KERNELS))


def tally(events) -> tuple:
    """(activity, launch calls, ``cudaLaunchKernel`` calls) of raw kineto
    records (``prof.profiler.kineto_results.events()``).  A range the
    host records (an optimizer's step, DDP's forward) shows on the
    device's track as a user annotation spanning its kernels: it is no
    work of its own, so it is skipped, or the card would look busier
    than the wall clock allows."""
    from torch.autograd import DeviceType

    activity = {}
    launches = cuda_launch = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            rec = activity.setdefault(name, [0, 0])
            rec[0] += e.duration_ns()
            rec[1] += 1
        elif _LAUNCH.match(name):
            launches += 1
            cuda_launch += name == "cudaLaunchKernel"
    return activity, launches, cuda_launch


def device_window(fn: Callable, calls: int = 1, cpu: bool = False,
                  device=None) -> DeviceWindow:
    """``calls`` back-to-back calls of ``fn`` under ``torch.profiler``
    (CUDA activity, and host ops when ``cpu``), closed by a device sync.
    The raw records are read, not ``prof.events()``, whose tree costs
    ~50 us an event: tens of seconds for a window of 20 forwards."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    activity, launches, cuda_launch = tally(
        prof.profiler.kineto_results.events())
    return DeviceWindow(activity, launches, cuda_launch, wall, prof)


def profile_device(fn: Callable, device, calls: int = 20,
                   windows: int = 3) -> dict:
    """The card's work a call of ``fn``, from :func:`device_window` over
    ``calls`` calls: ``device_ms`` (every kernel and copy the card ran),
    ``kernels`` (kernel records), ``launch_calls`` (the host's
    kernel-launch API calls) and ``cuda_launch_kernel`` (of those,
    ``cudaLaunchKernel``'s), each a call.  The profiler drops a kernel or
    two at a window's start, and now and then most of a window's device
    activity, so a window that recorded fewer than 99% of its launch
    calls' kernels is profiled again, up to ``windows`` times; then every
    value is None (not measured), as on the CPU, which has no device to
    measure."""
    keys = ("device_ms", "kernels", "launch_calls", "cuda_launch_kernel")
    if device.type != "cuda":
        return dict.fromkeys(keys)
    fn()
    torch.cuda.synchronize(device)
    for window in range(1, windows + 1):
        w = device_window(fn, calls, device=device)
        if w.kernels > 0 and w.kernels >= 0.99 * w.launch_calls:
            return {"device_ms": w.device_ns / 1e6 / calls,
                    "kernels": w.kernels / calls,
                    "launch_calls": w.launch_calls / calls,
                    "cuda_launch_kernel": w.cuda_launch_kernel / calls}
        print(f"[profile_device] window {window} of {windows}: "
              f"{w.kernels} kernels recorded for {w.launch_calls} launch "
              "calls", flush=True)
    return dict.fromkeys(keys)
