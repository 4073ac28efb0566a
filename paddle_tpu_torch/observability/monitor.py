"""Status server: the port's own copy of ``paddle_tpu/observability/
monitor.py``'s ``StatusServer`` and ``maybe_start_server``.

One stdlib HTTP thread answers the three operator questions about a
serving engine or a supervised training run:

- ``/metrics`` — every registry instrument in the Prometheus text format;
- ``/healthz`` — 200 while the engine serves; 503 with the engine's state
  once it is ``draining`` or ``stopped``, and 503
  ``load-shed:queue_depth=<n>`` while the admission queue is past
  ``PTPU_SHED_QUEUE_DEPTH`` (the signal a balancer routes away on); with
  a run supervisor, 503 while the run is not running, has a rollback
  pending or has lost a worker;
- ``/statusz`` — one JSON page: the health verdict, the training step's
  numbers (step, loss, step-time and data-wait tails, MFU, tokens/s from
  the ``step.*`` instruments), a ``serving``
  section (queue depth, running / waiting, TTFT / TPOT tails, KV
  occupancy, the registry's lifecycle counters, and the engine's own
  ``stats()`` with its ``resilience`` section, which wins where both
  carry a key) and a ``fleet`` section (the replica census, streams,
  client-observed TTFT / TPOT tails and the ``fleet.*`` counters, from
  the registry; the router's own ``stats()`` wins where the router
  hosts the server); with a supervisor, its ``supervisor``,
  ``heartbeat``, ``watchdog``, ``integrity`` and ``flight`` sections, and
  the last device-memory table (``observability/memory.py``).

``RunSupervisor.begin_run`` starts one per worker through
:func:`maybe_start_server` when ``PTPU_MONITOR_PORT`` is set.  Start one
by hand with ``ServingEngine.start_status_server()`` or
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

__all__ = ["StatusServer", "maybe_start_server", "MONITOR_PORT_ENV"]

MONITOR_PORT_ENV = "PTPU_MONITOR_PORT"


class StatusServer:
    """``/metrics``, ``/healthz`` and ``/statusz`` over one engine, one
    fleet router and / or one run supervisor (or over the registry alone).
    ``registry`` defaults to the process-global one at request time, so a
    server started before the first instrument still sees everything."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry=None, engine=None, router=None, supervisor=None,
                 worker_id: Optional[int] = None):
        self._registry = registry
        self.engine = engine
        self.router = router
        self.supervisor = supervisor
        self.worker_id = worker_id
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
        (``draining`` / ``stopped``) or sheds load, or once a supervised
        run is not running, has a rollback pending or lost a worker; 200
        otherwise."""
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
        sup = self.supervisor
        if sup is None:
            return 200, "ok"
        if not getattr(sup, "_running", False):
            return 503, "not-running"
        if sup.pending_rollback:
            return 503, f"rollback-pending:{sup.pending_rollback}"
        state = getattr(sup.monitor, "_last_state", None)
        from ..supervisor.heartbeat import RunState
        if state == RunState.LOST_WORKER:
            return 503, state
        return 200, state or "healthy"

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

        now = time.time()
        status: Dict[str, Any] = {
            "worker": self.worker_id, "pid": os.getpid(), "time": now,
            "step": gauge("step.current"), "loss": gauge("step.loss"),
            "step_time_ms": hist("step.time_ms"),
            "data_ms": hist("step.data_ms"), "mfu": gauge("step.mfu"),
            "tokens_per_sec": gauge("step.tokens_per_sec")}
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
        self._training_sections(status, snap, gauge, counter, now)
        return status

    def _training_sections(self, status, snap, gauge, counter, now) -> None:
        """The supervised run's sections of ``/statusz``: integrity (from
        the ``integrity.*`` instruments, and the guard's own state when a
        supervisor with one hosts the server), supervisor, heartbeat,
        watchdog, flight recorder and the last device-memory table."""
        sup = self.supervisor
        integrity: Dict[str, Any] = {}
        if any(k.startswith("integrity.") for k in snap):
            integrity = {
                "last_step": gauge("integrity.last_step"),
                "interval": gauge("integrity.interval"),
                "digest": gauge("integrity.digest"),
                "workers": gauge("integrity.workers"),
                "suspects": gauge("integrity.suspects"),
                "checks": counter("integrity.checks"),
                "mismatches": counter("integrity.mismatches"),
                "audits": counter("integrity.audits"),
                "resyncs": counter("integrity.resyncs"),
            }
        ig = getattr(sup, "integrity", None) if sup else None
        if ig is not None:
            integrity.update({
                "enabled": ig.enabled,
                "interval": ig.every,
                "action": ig.action,
                "checks": ig.checks,
                "mismatches": ig.mismatches,
                "strikes": dict(ig.strikes),
                "last_digest": (ig.last_fingerprint.hex()
                                if ig.last_fingerprint is not None
                                else None),
                "last_verdict": (dict(ig.last_verdict)
                                 if ig.last_verdict is not None else None),
                "pending": (dict(sup.pending_integrity)
                            if sup.pending_integrity is not None else None),
                "stash_bytes": ig.stash_bytes,
            })
        status["integrity"] = integrity or None
        if sup is not None:
            if status["step"] is None:
                status["step"] = sup.gstep
            hb = sup.heartbeat
            status["heartbeat"] = {
                "beats": hb.beats,
                "last": hb._last_beat or None,
                "age_secs": (now - hb._last_beat) if hb.beats else None,
            }
            wd = sup.watchdog
            with wd._cond:
                armed = [e.label for e in wd._entries]
            status["watchdog"] = {"timeout_secs": wd.timeout,
                                  "timeouts": wd.timeouts,
                                  "armed": armed,
                                  "closed": wd._closed}
            status["supervisor"] = {
                "running": sup._running,
                "last_action": sup.last_action,
                "pending_rollback": sup.pending_rollback,
                "rollbacks_used": sup.rollback.used,
                "bad_batches": sup.guard.total_bad,
                "lr_scale": sup.guard.lr_scale,
                "consecutive_step_failures":
                    sup.consecutive_step_failures,
                "last_good_step": sup.elastic.last_good_step(),
            }
            fr = getattr(sup, "flight", None)
            if fr is not None:
                status["flight"] = {"records": fr.seen,
                                    "capacity": fr.capacity,
                                    "dumps": fr.dumps}
        try:
            from .memory import get_sampler
            status["memory"] = get_sampler().last_table or None
        except Exception as e:  # statusz must render
            vlog(1, "monitor: statusz could not read the sampler: %r", e)
            status["memory"] = None

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


def maybe_start_server(supervisor=None, worker_id: Optional[int] = None,
                       registry=None) -> Optional[StatusServer]:
    """Start a :class:`StatusServer` when ``PTPU_MONITOR_PORT`` is set.

    A nonzero base port is offset by the worker rank (worker 3 of a
    localhost simulation serves on base+3); 0 asks for an ephemeral port
    per worker.  Returns None when the knob is unset or the bind fails:
    monitoring must never take the run down with it."""
    raw = os.environ.get(MONITOR_PORT_ENV)
    if raw is None or raw.strip() == "":
        return None
    try:
        base = int(raw)
    except ValueError:
        vlog(0, "monitor: bad %s=%r - not starting a status server",
             MONITOR_PORT_ENV, raw)
        return None
    wid = int(worker_id or 0)
    port = base + wid if base > 0 else 0
    try:
        return StatusServer(port=port, registry=registry,
                            supervisor=supervisor, worker_id=wid).start()
    except OSError as e:
        vlog(0, "monitor: cannot bind status server on port %d: %s",
             port, e)
        return None
