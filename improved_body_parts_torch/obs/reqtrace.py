"""Request-scoped causal tracing across the serve stack (the port's own
copy of ``improved_body_parts_tpu/obs/reqtrace.py``).

The span trace answers *where each thread's time went*; it cannot
answer the question a slow request raises: **which hop ate this
request's budget?**  This module threads ONE causal context through
every component that handles a request:

- every component that handles a request opens a **node** — a unique id,
  its causal parent, the edge *kind* that created it (``submit`` /
  ``retry`` / ``hedge`` / ``failover`` / ``escalate`` / ``migrate``)
  and a reason annotation;
- each node records a **hop waterfall** — ordered ``(hop, seconds)``
  segments that partition its span (the batcher's
  queue / batch_formation / device / decode / deliver);
- when the LAST node of a request finishes, the recorder assembles one
  strict-JSON ``request`` record (the whole tree) and emits it through
  the process event sink, keeping a bounded in-memory copy for
  in-process consumers.

**Cross-component threading without signature changes.**  Engines share
one duck-typed ``submit(image, deadline_s=...)`` contract; threading a
context argument through it would fork that contract everywhere.
Instead a parent layer wraps its *synchronous* inner ``submit`` call in
:meth:`ReqNode.child_scope`, which installs the parent on a
thread-local; the inner component's :meth:`ReqTrace.begin` picks it up
and becomes a child.

**Delivering chain.**  Every non-leaf node records ``won_by`` — the
child whose outcome it delivered.  Following ``won_by`` from the root
yields the request's *delivering path*, and the chain's hop sum over
the root's end-to-end span is the conservation discipline (≥95%).

**Cost.**  With no recorder installed (the default), every site hits
:class:`NullReqTrace` / ``NULL_NODE`` — attribute checks and no-ops.
With a recorder installed, unsampled requests get ``NULL_NODE`` at the
root and every child inherits it through the scope, so sampling bounds
the per-request cost to one modulo.  Per-hop *histograms* are not this
module's job — they live on ``serve.metrics.ServeMetrics`` and are
recorded for every request regardless of sampling.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from .events import get_sink
from .trace import get_tracer

#: causal edge kinds a child node can be created under (reason-annotated
#: where the edge encodes a decision: why the failover, why the
#: escalation)
EDGE_KINDS = ("submit", "retry", "hedge", "failover", "escalate",
              "migrate", "resubmit")


class _Scope:
    """One ``child_scope`` activation: carries the parent + edge kind
    down the thread-local, and carries the created child node back up
    (``scope.node``) so the parent can record ``won_by``."""

    __slots__ = ("parent", "kind", "reason", "node")

    def __init__(self, parent, kind: str, reason: Optional[str]):
        self.parent = parent
        self.kind = kind
        self.reason = reason
        self.node = None        # filled by the inner begin()


class _ScopeCtx:
    """Context manager installing a :class:`_Scope` on the thread-local
    (save/restore — scopes nest)."""

    __slots__ = ("_scope", "_prev")

    def __init__(self, scope: _Scope):
        self._scope = scope

    def __enter__(self) -> _Scope:
        self._prev = getattr(_TLS, "scope", None)
        _TLS.scope = self._scope
        return self._scope

    def __exit__(self, *exc) -> None:
        _TLS.scope = self._prev


_TLS = threading.local()


class NullReqNode:
    """The inert node: parents of unsampled requests and every site
    when no recorder is installed.  ``child_scope`` still nests (the
    scope machinery must stay balanced) but creates more nulls."""

    __slots__ = ()
    sampled = False
    node_id = 0
    req = 0

    def child_scope(self, kind: str, reason: Optional[str] = None
                    ) -> _ScopeCtx:
        return _ScopeCtx(_Scope(self, kind, reason))

    def finish(self, status: str = "ok",
               hops: Optional[List[Tuple[str, float]]] = None,
               won_by=None, **labels) -> None:
        pass


NULL_NODE = NullReqNode()


class ReqNode:
    """One component's handling of one request (one tree node)."""

    __slots__ = ("_rec", "req", "node_id", "parent_id", "comp", "kind",
                 "reason", "labels", "t0", "t1", "hops", "status",
                 "won_by_id", "_done")

    sampled = True

    def __init__(self, rec: "ReqTrace", req: int, node_id: int,
                 parent_id: Optional[int], comp: str, kind: str,
                 reason: Optional[str], labels: Dict[str, str]):
        self._rec = rec
        self.req = req
        self.node_id = node_id
        self.parent_id = parent_id
        self.comp = comp
        self.kind = kind
        self.reason = reason
        self.labels = labels
        self.t0 = rec.now()
        self.t1: Optional[float] = None
        self.hops: List[Tuple[str, float]] = []
        self.status = "open"
        self.won_by_id: Optional[int] = None
        self._done = False

    def child_scope(self, kind: str, reason: Optional[str] = None
                    ) -> _ScopeCtx:
        """Wrap the parent's synchronous inner ``submit`` call; the
        component reached inside the ``with`` attaches as a child under
        edge ``kind`` and the scope hands its node back via
        ``scope.node`` (``None`` when the inner submit shed or the
        inner component is an uninstrumented fake)."""
        return _ScopeCtx(_Scope(self, kind, reason))

    def finish(self, status: str = "ok",
               hops: Optional[List[Tuple[str, float]]] = None,
               won_by=None, **labels) -> None:
        """Complete this node exactly once.  ``hops`` is the ordered
        waterfall partition of the node's span; ``won_by`` the child
        node whose outcome this node delivered (chain link)."""
        rec = self._rec
        if self._done:      # exactly-once: late losers / double-finish
            return
        self._done = True
        self.t1 = rec.now()
        if hops:
            self.hops = [(str(n), max(float(d), 0.0)) for n, d in hops]
        if won_by is not None and isinstance(won_by, ReqNode):
            self.won_by_id = won_by.node_id
        if labels:
            self.labels = {**self.labels,
                           **{k: str(v) for k, v in labels.items()}}
        self.status = status
        rec._node_finished(self)

    def as_dict(self) -> dict:
        return {
            "node": self.node_id,
            "parent": self.parent_id,
            "comp": self.comp,
            "kind": self.kind,
            **({"reason": self.reason} if self.reason else {}),
            **self.labels,
            "t0_ms": round(self.t0 * 1e3, 3),
            "dur_ms": round(((self.t1 if self.t1 is not None else self.t0)
                             - self.t0) * 1e3, 3),
            "status": self.status,
            **({"won_by": self.won_by_id}
               if self.won_by_id is not None else {}),
            "hops_ms": {n: round(d * 1e3, 3) for n, d in self.hops},
        }


class _LiveReq:
    """Accounting for one in-flight request tree."""

    __slots__ = ("root", "nodes", "pending")

    def __init__(self, root: ReqNode):
        self.root = root
        self.nodes: List[ReqNode] = [root]
        self.pending = 1


class NullReqTrace:
    """Tracing disabled: every begin returns the null node."""

    enabled = False
    emitted = 0
    dropped = 0

    def begin(self, comp: str, **labels):
        return NULL_NODE

    def records(self) -> List[dict]:
        return []

    def now(self) -> float:
        return 0.0


class ReqTrace:
    """Per-request causal recorder for one process.

    ``sample``: every Nth root request is recorded (1 = all, the bench
    default; a high-QPS deployment thins here — the per-hop histograms
    on ``ServeMetrics`` see every request regardless).  ``t0`` anchors
    node timestamps; pass the event sink's ``t0`` so request records,
    spans and JSONL events share one axis.

    Completed request records are emitted through the process event
    sink as ``request`` events AND kept in a bounded deque
    (:meth:`records`).  A request whose tree never completes (a future
    the caller abandoned mid-teardown) is evicted once ``max_live``
    trees are in flight — counted in ``dropped``, never a leak.
    """

    enabled = True

    def __init__(self, sample: int = 1, capacity: int = 4096,
                 max_live: int = 4096, t0: Optional[float] = None,
                 emit_to_sink: bool = True):
        import time

        self.sample = max(1, int(sample))
        self._t0 = float(t0) if t0 is not None else time.monotonic()
        self._mono = time.monotonic
        self._lock = threading.Lock()
        self._req_counter = 0
        self._node_counter = 0
        self._live: "Dict[int, _LiveReq]" = {}
        self._records: deque = deque(maxlen=int(capacity))
        self.max_live = int(max_live)
        self.emit_to_sink = emit_to_sink
        self.emitted = 0
        self.dropped = 0

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        return self._mono() - self._t0

    # ------------------------------------------------------------- begin
    def begin(self, comp: str, **labels):
        """Open a node for ``comp``'s handling of the current request.

        Inside an active :meth:`ReqNode.child_scope` this attaches as a
        child of the scope's parent (inheriting the request id and the
        scope's edge kind/reason, and handing itself back through
        ``scope.node``); otherwise it opens a new ROOT — where the
        sampling decision is made.
        """
        scope = getattr(_TLS, "scope", None)
        if scope is not None:
            parent = scope.parent
            if not parent.sampled:
                scope.node = NULL_NODE
                return NULL_NODE
            with self._lock:
                live = self._live.get(parent.req)
                if live is None:        # tree already evicted
                    scope.node = NULL_NODE
                    return NULL_NODE
                self._node_counter += 1
                node = ReqNode(self, parent.req, self._node_counter,
                               parent.node_id, comp, scope.kind,
                               scope.reason,
                               {k: str(v) for k, v in labels.items()})
                live.nodes.append(node)
                live.pending += 1
            scope.node = node
            trace = get_tracer()
            if trace.enabled:
                # the followable arc: one flow step per hop edge, on
                # whatever track the submitting thread records to
                trace.flow_step("reqpath", node.req, cat="reqpath")
            return node
        # root
        with self._lock:
            self._req_counter += 1
            if self._req_counter % self.sample:
                return NULL_NODE
            self._node_counter += 1
            node = ReqNode(self, self._req_counter, self._node_counter,
                           None, comp, "submit", None,
                           {k: str(v) for k, v in labels.items()})
            self._live[node.req] = _LiveReq(node)
            if len(self._live) > self.max_live:
                # evict the OLDEST in-flight tree (insertion order):
                # bounded memory beats a complete record for a request
                # someone abandoned
                evict = next(iter(self._live))
                del self._live[evict]
                self.dropped += 1
        trace = get_tracer()
        if trace.enabled:
            trace.flow_start("reqpath", node.req, cat="reqpath")
        return node

    # ------------------------------------------------------ node finish
    def _node_finished(self, node: ReqNode) -> None:
        record = None
        with self._lock:
            live = self._live.get(node.req)
            if live is None:
                return
            live.pending -= 1
            if live.pending <= 0 and live.root.t1 is not None:
                del self._live[node.req]
                record = self._assemble(live)
                self._records.append(record)
                self.emitted += 1
        if record is None:
            return
        trace = get_tracer()
        if trace.enabled:
            trace.flow_finish("reqpath", node.req, cat="reqpath",
                              ts=live.root.t1)
        if self.emit_to_sink:
            get_sink().emit("request", **record)

    # ---------------------------------------------------------- assembly
    @staticmethod
    def delivering_chain(nodes: List[dict]) -> List[dict]:
        """Follow ``won_by`` from the root: the path whose outcome the
        caller actually received.  The chain ends at the first node with
        no ``won_by`` — a leaf when a component resolved it, the
        interior node itself when a client-side timer did."""
        by_id = {n["node"]: n for n in nodes}
        root = next((n for n in nodes if n["parent"] is None), None)
        chain = []
        cur = root
        while cur is not None:
            chain.append(cur)
            cur = by_id.get(cur.get("won_by"))
        return chain

    def _assemble(self, live: _LiveReq) -> dict:
        # caller holds the lock
        root = live.root
        nodes = [n.as_dict() for n in live.nodes]
        e2e_ms = nodes[0]["dur_ms"] if nodes else 0.0
        chain = self.delivering_chain(nodes)
        covered_ms = sum(sum(n["hops_ms"].values()) for n in chain)
        return {
            "req": root.req,
            "t": round(root.t0, 6),
            "e2e_ms": e2e_ms,
            "status": root.status,
            "sampled_1_in": self.sample,
            "chain": [n["node"] for n in chain],
            "chain_hops_ms": round(covered_ms, 3),
            "hop_coverage": (round(covered_ms / e2e_ms, 4)
                             if e2e_ms > 0 else 1.0),
            "nodes": nodes,
        }

    # ----------------------------------------------------------- readout
    def records(self) -> List[dict]:
        """The bounded in-memory copy of emitted request records
        (newest last)."""
        with self._lock:
            return list(self._records)

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._live)

    def attach_registry(self, registry) -> None:
        """Expose emitted/dropped/live through a registry (duck-typed:
        any object with ``register_collector``; weakref collector — the
        ServeMetrics discipline)."""
        import weakref

        ref = weakref.ref(self)

        def _collect():
            r = ref()
            if r is None:
                return []
            return [
                ("reqtrace_requests_total", {}, "counter",
                 float(r.emitted)),
                ("reqtrace_dropped_total", {}, "counter",
                 float(r.dropped)),
                ("reqtrace_live_requests", {}, "gauge", float(r.live)),
            ]

        registry.register_collector(_collect)


_reqtrace_lock = threading.Lock()
_reqtrace = NullReqTrace()


def get_reqtrace():
    """The process's current request recorder (``NullReqTrace`` when no
    run installed one) — instrumentation sites record through this
    unconditionally, like ``get_tracer``/``get_sink``."""
    return _reqtrace


def set_reqtrace(rec):
    """Install ``rec`` as the process default; returns the previous one
    so callers can restore it."""
    global _reqtrace
    with _reqtrace_lock:
        prev = _reqtrace
        _reqtrace = rec if rec is not None else NullReqTrace()
        return prev
