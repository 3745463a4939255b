"""Loss and step-time meters (copies of
``improved_body_parts_tpu/utils/meters.py`` ``AverageMeter`` and
``StepTimer``; reference: train_distributed.py:412-425)."""
from __future__ import annotations

import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StepTimer:
    """Wall-clock step timer; call mark() after a device sync."""

    def __init__(self):
        self.meter = AverageMeter()
        self._last = time.perf_counter()

    def mark(self, steps: int = 1) -> float:
        now = time.perf_counter()
        dt = (now - self._last) / max(steps, 1)
        self._last = now
        self.meter.update(dt, steps)
        return dt
