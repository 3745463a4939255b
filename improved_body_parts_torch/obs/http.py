"""Background metrics endpoint over one :class:`Registry` (the port's
own copy of ``improved_body_parts_tpu/obs/http.py``).

A daemon-threaded ``ThreadingHTTPServer``; every route is declared once
in :data:`ROUTES` — the same table drives handler dispatch, the
module's route list below, and the unknown-path 404 body, so the three
can never drift (they used to be hand-enumerated in two places).

Route semantics beyond the table:

- ``/healthz`` answers 200 with ``{"status": "ok", ...}`` while
  healthy, 503 once the latest window diverged — the contract a stock
  load-balancer / liveness probe expects.  Without a health source it
  answers 200/"ok" (the endpoint being up is the only health there is);
- ``/slo`` answers 503 while any class's alarm fires, so a
  threshold-less consumer can gate on status alone; 404 when no
  tracker was wired;
- ``/fleet`` and ``/history`` answer 404 when their source was not
  wired;
- ``/query`` reads one history series over time: ``?series=<key>``
  (required; the key format is the snapshot key,
  ``name{label="v",…}``), optional ``since=<t>`` (monotonic seconds,
  same axis as event ``t``), ``step=<s>`` (0/absent = raw ring,
  otherwise the finest aggregate level at least that wide) and
  ``limit=`` (clamped to the store's bound) — responses are bounded no
  matter what retention the store carries.  400 on malformed
  parameters, 404 for an unknown series.

``HEAD`` is answered for every route with the same status and headers
and no body — LB probes default to HEAD, and an unanswered method must
not read as an unhealthy backend.

Port 0 binds an ephemeral port (read it back from ``.port`` / ``.url``);
the listener binds loopback by default — operators who want it exposed
front it with whatever ingress their deployment already has.  Serving is
scrape-time-only work: nothing is computed until a request arrives, so
an idle endpoint costs one parked thread.

Routes:
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Optional
from urllib.parse import parse_qs

from .events import _definan
from .registry import Registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the single source of truth for the route surface: path → one-line
#: description.  Handler dispatch, the module docstring's route list
#: and the unknown-path 404 body are all generated from it.
ROUTES = (
    ("/metrics", "Prometheus text exposition 0.0.4"),
    ("/snapshot", "registry JSON snapshot plus caller-supplied extras"),
    ("/healthz", "run-health state (503 once diverged)"),
    ("/slo", "SLO / error-budget document (503 while any alarm fires)"),
    ("/fleet", "per-worker fleet document"),
    ("/history", "telemetry-history store document"),
    ("/query", "one history series over time "
               "(?series=&since=&step=&limit=)"),
)

__doc__ += "".join(f"\n- ``{path}`` — {desc}" for path, desc in ROUTES)


def _unknown_route_message() -> str:
    paths = [p for p, _ in ROUTES]
    return "use " + ", ".join(paths[:-1]) + " or " + paths[-1]


class _Unavailable(Exception):
    """A declared route whose backing source was not wired → 404 with a
    per-route message."""


class MetricsServer:
    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1",
                 extra: Optional[Callable[[], dict]] = None,
                 health: Optional[Callable[[], dict]] = None,
                 slo: Optional[Callable[[], dict]] = None,
                 fleet: Optional[Callable[[], dict]] = None,
                 history=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry
        extra_fn = extra
        health_fn = health
        slo_fn = slo
        fleet_fn = fleet
        history_store = history  # obs.history.HistoryStore (doc/query)

        def _json_body(obj) -> bytes:
            # an empty histogram's quantiles are real NaNs; _definan
            # keeps every body strict JSON (JGL004)
            return json.dumps(_definan(obj), indent=2,
                              default=str).encode()

        # ------------------------------------------------ route handlers
        # each returns (code, body, content_type); raises _Unavailable
        # for a declared-but-unwired source (→ 404)
        def _r_metrics(query):
            return 200, reg.prometheus().encode(), PROMETHEUS_CONTENT_TYPE

        def _r_snapshot(query):
            snap = {"metrics": reg.snapshot()}
            if extra_fn is not None:
                snap.update(extra_fn())
            return 200, _json_body(snap), "application/json"

        def _r_healthz(query):
            state = (dict(health_fn()) if health_fn is not None
                     else {"status": "ok"})
            code = 200 if state.get("status", "ok") == "ok" else 503
            # the diverged body carries the NaN loss itself
            return code, _json_body(state), "application/json"

        def _r_slo(query):
            if slo_fn is None:
                raise _Unavailable("no SLO tracker wired on this endpoint")
            state = dict(slo_fn())
            code = 200 if state.get("status", "ok") != "alarm" else 503
            return code, _json_body(state), "application/json"

        def _r_fleet(query):
            if fleet_fn is None:
                raise _Unavailable("no fleet source wired on this endpoint")
            return 200, _json_body(dict(fleet_fn())), "application/json"

        def _r_history(query):
            if history_store is None:
                raise _Unavailable(
                    "no history store wired on this endpoint")
            return 200, _json_body(history_store.doc()), "application/json"

        def _r_query(query):
            if history_store is None:
                raise _Unavailable(
                    "no history store wired on this endpoint")
            params = parse_qs(query)
            series = params.get("series", [None])[0]
            if not series:
                return (400, _json_body({"error": "series= is required"}),
                        "application/json")
            try:
                since = (float(params["since"][0])
                         if "since" in params else None)
                step = (float(params["step"][0])
                        if "step" in params else None)
                limit = (int(params["limit"][0])
                         if "limit" in params else 2000)
            except (ValueError, IndexError):
                return (400, _json_body(
                    {"error": "since=/step= must be numbers, "
                              "limit= an integer"}), "application/json")
            try:
                doc = history_store.query(series, since=since, step=step,
                                          limit=limit)
            except KeyError:
                return (404, _json_body(
                    {"error": f"unknown series {series!r}",
                     "keys": history_store.keys()}), "application/json")
            return 200, _json_body(doc), "application/json"

        handlers = {"/metrics": _r_metrics, "/snapshot": _r_snapshot,
                    "/healthz": _r_healthz, "/slo": _r_slo,
                    "/fleet": _r_fleet, "/history": _r_history,
                    "/query": _r_query}
        # the dispatch table and the declared surface must be the same
        # set — a new route added to one place only fails loudly at
        # import, not silently at scrape time
        assert set(handlers) == {p for p, _ in ROUTES}, \
            "ROUTES and handler table drifted"

        class Handler(BaseHTTPRequestHandler):
            def _handle(self):
                path, _, query = self.path.partition("?")
                fn = handlers.get(path)
                try:
                    if fn is None:
                        # send_error handles HEAD itself (headers only)
                        self.send_error(404, _unknown_route_message())
                        return
                    code, body, ctype = fn(query)
                except _Unavailable as e:
                    self.send_error(404, str(e))
                    return
                except Exception as e:  # noqa: BLE001 — a scrape bug
                    # must 500, not kill the handler thread silently
                    self.send_error(500, type(e).__name__)
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                self._handle()

            def do_HEAD(self):  # noqa: N802 — LB probes default to HEAD
                self._handle()

            def log_message(self, *args):  # scrapes are not stdout news
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="obs-metrics-http",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
