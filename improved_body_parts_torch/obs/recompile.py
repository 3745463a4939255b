"""Post-warmup "recompile" detection for the port (the counterpart of
``improved_body_parts_tpu/obs/recompile.py``).

What a compile means here.  PyTorch compiles no program ahead of a run,
but the first run of a (lane, padded shape, batch size) still pays
one-off costs on the card: the kernels' ``nvcc`` build at first use
(``ops/_build.py``), cuDNN's algorithm choice for the shape, and the
caching allocator's first blocks.  ``Predictor.precompile_compact``
(``serve.warmup.precompile``) pays them at start-up and records each
combination in the predictor's ``_warmed`` set.  The port's compile
event is therefore the FIRST run of a combination that set did not yet
hold: ``Predictor._run_chunk`` reports it through :func:`report_first_run`
with the host seconds of that dispatch, on every predictor in the
process (a ``device_replica`` starts with an empty set of its own).

:class:`CompileWatch` counts those events into the JAX package's
families — ``xla_compiles_total``, ``xla_compile_seconds_total`` and,
after :meth:`mark_warm`, ``xla_recompiles_post_warmup_total`` — and
emits the same ``recompile`` event into the run's sink, so the fleet's
merged exposition and its metric names carry over unchanged.  The
names keep "xla" for that reason only; nothing here involves XLA.

The JAX package's ``wrap()`` (a jaxpr signature cache for jax builds
without ``jax.monitoring``) has no counterpart: the predictor reports
its first runs itself.  Listeners are held by weak reference, so
:meth:`CompileWatch.uninstall` (or the watch's collection) stops the
counting.
"""
from __future__ import annotations

import threading
import weakref
from typing import List, Optional

from .events import NullSink
from .registry import Registry, get_registry

#: the event name the predictor reports (the JAX package's constant
#: names XLA's backend-compile duration event; the port's names its own)
COMPILE_EVENT = "predictor/first_run"

_listeners_lock = threading.Lock()
_listeners: "List[weakref.ref]" = []


def report_first_run(seconds: float, key=None) -> None:
    """Called by ``Predictor._run_chunk`` when it runs a (lane, shape,
    batch) combination its ``_warmed`` set did not hold: every installed
    :class:`CompileWatch` counts one compile of ``seconds`` (the host
    time of that first dispatch)."""
    with _listeners_lock:
        watches = [r() for r in _listeners]
        _listeners[:] = [r for r, w in zip(_listeners, watches)
                         if w is not None]
    for w in watches:
        if w is not None:
            w._on_duration(COMPILE_EVENT, seconds, key=key)


class CompileWatch:
    def __init__(self, registry: Optional[Registry] = None, sink=None):
        registry = registry if registry is not None else get_registry()
        self.compiles = registry.counter(
            "xla_compiles_total",
            "first runs of an unwarmed (lane, shape, batch) this process")
        self.recompiles = registry.counter(
            "xla_recompiles_post_warmup_total",
            "first runs of an unwarmed (lane, shape, batch) after "
            "mark_warm — each one stalled the pipeline")
        self.compile_seconds = registry.counter(
            "xla_compile_seconds_total",
            "host seconds of those first dispatches")
        self._sink = sink if sink is not None else NullSink()
        self._lock = threading.Lock()
        self._warm = False
        self._active = False
        # post-warmup first runs in arrival order
        self.timeline: List[dict] = []

    # ---------------------------------------------------------- lifecycle
    def install(self) -> "CompileWatch":
        """Listen for the predictors' first-run reports (idempotent)."""
        with self._lock:
            if self._active:
                return self
            self._active = True
        with _listeners_lock:
            _listeners.append(weakref.ref(self))
        return self

    def uninstall(self) -> None:
        """Stop counting (the listener entry is dropped at the next
        report)."""
        with self._lock:
            self._active = False
        with _listeners_lock:
            _listeners[:] = [r for r in _listeners
                             if r() is not None and r() is not self]

    @property
    def warm(self) -> bool:
        return self._warm

    # ------------------------------------------------------------ signals
    def _on_duration(self, name: str, secs: float, key=None) -> None:
        if self._active and name == COMPILE_EVENT:
            self._record(float(secs), source="predictor",
                         key=None if key is None else str(key))

    def _record(self, secs: float, source: str,
                key: Optional[str] = None) -> None:
        self.compiles.inc()
        self.compile_seconds.inc(secs)
        with self._lock:
            warm = self._warm
        if warm:
            self.recompiles.inc()
            ev = {"duration_s": round(secs, 6), "source": source}
            if key is not None:
                ev["key"] = key
            self.timeline.append(ev)
            self._sink.emit("recompile", **ev)

    def mark_warm(self, label: str = "") -> None:
        """Steady state starts now: every first run from here on is
        unexpected.  Idempotent — the first caller wins."""
        with self._lock:
            if self._warm:
                return
            self._warm = True
        self._sink.emit("warmup_complete", label=label,
                        compiles_during_warmup=self.compiles.value)
