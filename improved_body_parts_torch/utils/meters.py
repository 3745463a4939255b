"""Loss and step-time meters and the latency percentile reservoir of
the serving engine (``serve.metrics``): copies of
``improved_body_parts_tpu/utils/meters.py`` ``AverageMeter``,
``PercentileMeter`` and ``StepTimer`` (reference:
train_distributed.py:412-425)."""
from __future__ import annotations

import random
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


class PercentileMeter:
    """Bounded-memory percentile estimator (uniform reservoir sampling).

    Tail latency (p95/p99) cannot be read off an ``AverageMeter``; a
    serving run can also observe millions of requests, so keeping every
    sample is out.  Algorithm R keeps a fixed-size uniform sample of the
    stream: every observation has probability ``capacity / count`` of
    being in the reservoir, so percentiles computed from it are unbiased
    estimates of the stream's.  The mean and count are tracked exactly.

    Deterministically seeded: two meters fed the same stream report the
    same percentiles (keeps tests and A/B bench runs reproducible).
    """

    def __init__(self, capacity: int = 4096, seed: int = 0):
        self.capacity = capacity
        self._rng = random.Random(seed)
        self.reset()

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self._samples: list = []
        # sorted view of the reservoir, rebuilt lazily on read and
        # dropped only when the reservoir actually mutates: a scrape
        # reads several quantiles back to back (one sort instead of
        # three), and once the reservoir is full most updates replace
        # nothing (probability capacity/count), so the cache stays warm
        # between scrapes under steady load
        self._sorted: list = None

    def update(self, val: float):
        self.count += 1
        self.sum += val
        if len(self._samples) < self.capacity:
            self._samples.append(val)
            self._sorted = None
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._samples[j] = val
                self._sorted = None

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile of the reservoir, ``q`` in
        [0, 100]; 0.0 when no samples were recorded."""
        if not self._samples:
            return 0.0
        s = self._sorted
        if s is None:
            s = self._sorted = sorted(self._samples)
        pos = (len(s) - 1) * q / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def summary(self, scale: float = 1.0) -> dict:
        """{count, mean, p50, p95, p99} with values × ``scale`` (pass 1e3
        to report seconds as milliseconds)."""
        return {
            "count": self.count,
            "mean": self.avg * scale,
            "p50": self.percentile(50) * scale,
            "p95": self.percentile(95) * scale,
            "p99": self.percentile(99) * scale,
        }


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
