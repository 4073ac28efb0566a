"""Status server: the port's own copy of the serving half of
``paddle_tpu/observability/monitor.py`` (``StatusServer``).

One stdlib HTTP thread answers the three operator questions about a
serving engine:

- ``/metrics`` — every registry instrument in the Prometheus text format;
- ``/healthz`` — 200 while the engine serves; 503 with the engine's state
  once it is ``draining`` or ``stopped``, and 503
  ``load-shed:queue_depth=<n>`` while the admission queue is past
  ``PTPU_SHED_QUEUE_DEPTH`` (the signal a balancer routes away on);
- ``/statusz`` — one JSON page: the health verdict, a ``serving``
  section (queue depth, running / waiting, TTFT / TPOT tails, KV
  occupancy, the registry's lifecycle counters, and the engine's own
  ``stats()`` with its ``resilience`` section, which wins where both
  carry a key) and a ``fleet`` section (the replica census, streams,
  client-observed TTFT / TPOT tails and the ``fleet.*`` counters, from
  the registry; the router's own ``stats()`` wins where the router
  hosts the server).

Start one with ``ServingEngine.start_status_server()`` or
``StatusServer(engine=..., router=...).start()``; ``port=0`` binds an
ephemeral port (read back from ``.port``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..framework.log import vlog
from .registry import get_registry
from .sinks import render_prometheus

__all__ = ["StatusServer"]


class StatusServer:
    """``/metrics``, ``/healthz`` and ``/statusz`` over one engine and / or
    one fleet router (or over the registry alone).  ``registry`` defaults to the process-global
    one at request time, so a server started before the first instrument
    still sees everything."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry=None, engine=None, router=None):
        self._registry = registry
        self.engine = engine
        self.router = router
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    # -- the three pages ---------------------------------------------------
    def render_metrics(self) -> str:
        return render_prometheus(self._reg())

    def healthz(self):
        """``(http_status, state)``: 503 once the engine is not serving
        (``draining`` / ``stopped``) or sheds load; 200 ``ok`` otherwise."""
        if self.engine is not None:
            try:
                estate = getattr(self.engine, "state", "serving")
                if estate != "serving":
                    return 503, estate
                if self.engine.should_shed():
                    depth = self.engine.sched.queue_depth
                    return 503, f"load-shed:queue_depth={depth}"
            except Exception as e:  # health must answer
                vlog(0, "monitor: healthz could not read the engine: %r", e)
        return 200, "ok"

    def statusz(self) -> Dict[str, Any]:
        snap = self._reg().snapshot()

        def hist(name):
            m = snap.get(name)
            if not m or m.get("type") != "histogram" or not m["count"]:
                return None
            return {"count": m["count"], "mean": m["mean"],
                    "p50": m["p50"], "p99": m["p99"]}

        def gauge(name):
            m = snap.get(name)
            return m["value"] if m and m.get("type") == "gauge" else None

        def counter(name):
            m = snap.get(name)
            return m["value"] if m and m.get("type") == "counter" else 0

        status: Dict[str, Any] = {"pid": os.getpid(), "time": time.time()}
        hs, state = self.healthz()
        status["health"] = {"ok": hs == 200, "state": state}
        serving: Dict[str, Any] = {}
        if any(k.startswith("serve.") for k in snap):
            serving = {
                "queue_depth": gauge("serve.queue_depth"),
                "waiting": gauge("serve.waiting"),
                "running": gauge("serve.running"),
                "kv_occupancy": gauge("serve.kv_occupancy"),
                "kv_blocks_used": gauge("serve.kv_blocks_used"),
                "ttft_ms": hist("serve.ttft_ms"),
                "tpot_ms": hist("serve.tpot_ms"),
                # registry-derived, so they render without an engine; the
                # engine's richer "resilience" dict wins when present
                "resilience": {
                    "deadline_misses": counter("serve.deadline_misses"),
                    "cancelled": counter("serve.cancelled"),
                    "poisoned": counter("serve.poisoned"),
                    "spilled": counter("serve.spilled"),
                    "watchdog_restarts":
                        counter("serve.watchdog_restarts"),
                    "callback_errors": counter("serve.callback_errors"),
                },
            }
        if self.engine is not None:
            try:
                serving.update(self.engine.stats())
            except Exception as e:  # statusz must render
                vlog(0, "monitor: statusz could not read the engine: %r", e)
        status["serving"] = serving or None
        # the serving fleet: replica census + stream / failover counters,
        # registry-derived so any process of the fleet can render it; the
        # router's richer stats() wins when the router hosts this server
        fleet: Dict[str, Any] = {}
        if any(k.startswith("fleet.") for k in snap):
            states = {}
            for key in snap:
                if key.startswith("fleet.replicas[state="):
                    states[key[len("fleet.replicas[state="):-1]] = \
                        gauge(key)
            fleet = {
                "replicas": states or None,
                "streams": gauge("fleet.streams"),
                # client-observed latency tails, beside the engine-local
                # serve.* histograms so the gap shows at a glance
                "ttft_ms": hist("fleet.ttft_ms"),
                "tpot_ms": hist("fleet.tpot_ms"),
                "dispatch": counter("fleet.dispatch"),
                "retries": counter("fleet.retries"),
                "failovers": counter("fleet.failovers"),
                "migrations": counter("fleet.migrations"),
                "shed": counter("fleet.shed"),
                "restarts": counter("fleet.restarts"),
                "deferred": counter("fleet.deferred"),
                "breaker_trips": counter("fleet.breaker_trips"),
                "autoscale_events": counter("fleet.autoscale"),
                "recovered": counter("fleet.recovered"),
            }
        if self.router is not None:
            try:
                fleet.update(self.router.stats())
            except Exception as e:  # statusz must render
                vlog(0, "monitor: statusz could not read the router: %r", e)
        status["fleet"] = fleet or None
        return status

    # -- plumbing ----------------------------------------------------------
    def start(self) -> "StatusServer":
        if self._httpd is not None:
            return self
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: vlog, not stderr
                vlog(2, "monitor: %s", fmt % args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._send(200,
                                   server.render_metrics().encode("utf-8"),
                                   "text/plain; version=0.0.4")
                    elif path == "/statusz":
                        self._send(200, json.dumps(
                            server.statusz(), indent=1,
                            default=str).encode("utf-8"))
                    elif path in ("/healthz", "/"):
                        code, state = server.healthz()
                        self._send(code, json.dumps(
                            {"ok": code == 200,
                             "state": state}).encode("utf-8"))
                    else:
                        self._send(404, b'{"error": "not found"}')
                except Exception as e:  # a broken page must not kill serving
                    try:
                        self._send(500, json.dumps(
                            {"error": repr(e)}).encode("utf-8"))
                    except OSError:
                        pass  # the client hung up mid-error

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="ptpu-status-server",
                                        daemon=True)
        self._thread.start()
        vlog(0, "monitor: status server on %s:%d (/metrics /statusz "
             "/healthz)", self.host, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
