"""Device memory accounting and OOM forensics for one device (the port's
counterpart of ``improved_body_parts_tpu/obs/memory.py``).

:class:`DeviceMemory` reads the CUDA caching allocator of ONE device —
the predictor's or the trainer's — and publishes it the JAX package's
way:

- **Live gauges** — from ``torch.cuda.memory_stats``:
  ``device_bytes_in_use{device=N}`` (allocated bytes, what
  ``memory_allocated`` reads), ``device_peak_bytes{device=N}`` (their
  peak since the process started or its last reset, what
  ``max_memory_allocated`` reads) and ``device_watermark_bytes{device=N}``,
  the highest bytes in use *sampled this run*;
- **Event-stream samples** — :meth:`sample` with ``emit=True`` writes a
  ``memory`` event into the run's sink;
- **OOM forensics** — :meth:`forensics` walks the live tensors through
  ``gc`` (the counterpart of ``jax.live_arrays()``) and groups those on
  this device by (shape, dtype), largest first.

On the CPU (``device="cpu"``, what the tests ask for) it is an explicit
zero sampler: :meth:`sample` reads nothing, registers nothing and
returns ``{}`` — the JAX package's statless-backend case — while
:meth:`forensics` still walks the CPU tensors, so the tests run the same
code path an OOM takes.  It is not a fallback: asked for ``cuda`` on a
host without a card, it raises.
"""
from __future__ import annotations

import gc
import warnings
from typing import Dict, List, Optional

import torch

from .events import NullSink
from .registry import Registry, get_registry


class DeviceMemory:
    """Allocator accounting of one device through one registry."""

    def __init__(self, registry: Optional[Registry] = None, sink=None,
                 device="cuda"):
        from .. import resolve_device

        self.registry = registry if registry is not None else get_registry()
        self._sink = sink if sink is not None else NullSink()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._watermark: Dict[str, int] = {}
        # the CPU has no allocator stats to read
        self.supported: bool = self.device.type == "cuda"

    # ---------------------------------------------------------- sampling
    def sample(self, emit: bool = False, **fields) -> Dict[str, dict]:
        """Read the device's allocator stats; update the gauges and the
        per-run watermark; optionally emit a ``memory`` event carrying
        the numbers plus ``fields``.  Returns ``{device_index:
        {bytes_in_use, peak_bytes, watermark_bytes, bytes_limit}}``, or
        ``{}`` on the CPU."""
        if not self.supported:
            return {}
        stats = torch.cuda.memory_stats(self.device)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        dev = str(self.device.index)
        mark = max(self._watermark.get(dev, 0), in_use)
        self._watermark[dev] = mark
        labels = {"device": dev}
        self.registry.gauge(
            "device_bytes_in_use", "allocator bytes currently live",
            labels=labels).set(in_use)
        self.registry.gauge(
            "device_peak_bytes", "allocator peak bytes",
            labels=labels).set(peak)
        self.registry.gauge(
            "device_watermark_bytes",
            "highest bytes_in_use sampled this run",
            labels=labels).set(mark)
        rec = {"bytes_in_use": in_use, "peak_bytes": peak,
               "watermark_bytes": mark, "bytes_reserved": reserved,
               "bytes_limit": int(torch.cuda.get_device_properties(
                   self.device).total_memory)}
        per_dev = {dev: rec}
        if emit:
            self._sink.emit("memory", devices=per_dev, **fields)
        return per_dev

    # --------------------------------------------------------- forensics
    def forensics(self, top: int = 15) -> dict:
        """The largest live tensors on this device, grouped by (shape,
        dtype), found by walking the objects ``gc`` tracks."""
        groups: Dict[tuple, List[int]] = {}
        total = 0
        n = 0
        with warnings.catch_warnings():
            # isinstance on some deprecated torch aliases warns
            warnings.simplefilter("ignore")
            objects = [o for o in gc.get_objects()
                       if isinstance(o, torch.Tensor)]
        for obj in objects:
            try:
                if obj.device.type != self.device.type:
                    continue
                if self.device.index is not None and \
                        obj.device.index != self.device.index:
                    continue
                nbytes = int(obj.numel()) * obj.element_size()
                key = (tuple(obj.shape), str(obj.dtype))
            except Exception:  # noqa: BLE001 — freed or exotic mid-walk
                continue
            n += 1
            g = groups.setdefault(key, [0, 0])
            g[0] += 1
            g[1] += nbytes
            total += nbytes
        largest = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
        return {
            "live_arrays": n,
            "live_bytes": total,
            "largest": [
                {"shape": list(shape), "dtype": dtype, "count": count,
                 "bytes": nbytes}
                for (shape, dtype), (count, nbytes) in largest],
        }

    def emit_forensics(self, reason: str = "", **fields) -> dict:
        """Emit the forensics report (plus the current device stats) into
        the event stream."""
        report = self.forensics()
        report["devices"] = self.sample()
        self._sink.emit("memory_forensics", reason=reason, **report,
                        **fields)
        return report
