"""The live run monitor: the port's own copy of ``paddle_tpu/
observability/monitor.py`` (``StatusServer``, ``maybe_start_server`` and
``LiveAggregator``).

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
  hosts the server); the bench sections from the registry's gauges
  (``perf``: the ``perf.*`` figures by scenario; ``roofline``: the
  ``roofline.*`` gap buckets with the doctor's ``mfu_gap`` verdict;
  ``interconnect``: the ``interconnect.*`` comm sub-budget with the
  doctor's ``comm_budget`` verdict), ``elastic`` from the ``elastic.*``
  gauges and ``compile`` (None: the port tracks no compiles yet); with a
  supervisor, its ``supervisor``, ``heartbeat``, ``watchdog``,
  ``integrity`` and ``flight`` sections, and the last device-memory table
  (``observability/memory.py``).

:class:`LiveAggregator` is the in-flight watcher: it tail-reads the
still-growing ``<run_dir>/metrics/worker-*.jsonl`` streams with the
drop-tolerant reader, keeps a bounded window of recent records per
worker and re-runs the doctor's rules over the window every
``PTPU_MONITOR_INTERVAL`` seconds (default 5).  Verdicts land in a
rolling ``<run_dir>/live_status.json`` and, the moment one first fires,
as a ``monitor.alert`` record on the supervisor timeline.

``RunSupervisor.begin_run`` starts one per worker through
:func:`maybe_start_server` when ``PTPU_MONITOR_PORT`` is set.  Start one
by hand with ``ServingEngine.start_status_server()`` or
``StatusServer(engine=..., router=...).start()``; ``port=0`` binds an
ephemeral port (read back from ``.port``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ..framework.log import vlog
from ..utils import fsio
from .aggregate import StreamTail, straggler_stats
from .registry import get_registry
from .sinks import metrics_dir, render_prometheus

__all__ = ["MONITOR_PORT_ENV", "MONITOR_INTERVAL_ENV", "StatusServer",
           "LiveAggregator", "default_monitor_interval",
           "maybe_start_server", "live_status_path"]

MONITOR_PORT_ENV = "PTPU_MONITOR_PORT"
MONITOR_INTERVAL_ENV = "PTPU_MONITOR_INTERVAL"

_WORKER_RE = re.compile(r"^worker-(\d+)\.jsonl$")


def default_monitor_interval() -> float:
    return float(os.environ.get(MONITOR_INTERVAL_ENV, "5"))


def live_status_path(run_dir: str) -> str:
    return os.path.join(run_dir, "live_status.json")


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
        self._bench_sections(status, snap, gauge, counter)
        self._training_sections(status, snap, gauge, counter, now)
        # the port tracks no compiles (no jit): the key is kept, empty
        status["compile"] = None
        return status

    def _bench_sections(self, status, snap, gauge, counter) -> None:
        """``elastic`` (the ``elastic.*`` gauges), ``perf``, ``roofline``
        and ``interconnect`` from the registry's gauges, with the doctor's
        verdicts on the row-alikes rebuilt from them, as the JAX
        ``statusz``.  ``perf``'s ``perf_regression`` and ``trends`` read
        the bench's golden rows and ledger series, which the port does not
        have yet: they are None."""
        elastic: Dict[str, Any] = {}
        if any(k.startswith("elastic.") for k in snap):
            elastic = {
                "generation": gauge("elastic.generation"),
                "world_size": gauge("elastic.world_size"),
                "dp": gauge("elastic.dp"),
                "resizes": counter("elastic.resizes"),
            }
        status["elastic"] = elastic or None
        perf: Dict[str, Any] = {}
        perf_gauges = {k: m for k, m in snap.items()
                       if k.startswith("perf.") and m.get("type") == "gauge"}
        if perf_gauges:
            scen: Dict[str, Dict[str, Any]] = {}
            for name, m in perf_gauges.items():
                if "[scenario=" not in name:
                    continue
                metric, _, rest = name.partition("[scenario=")
                label = rest[:-1]
                if metric == "perf.phase_ms" and ",phase=" in label:
                    sname, _, phase = label.partition(",phase=")
                    scen.setdefault(sname, {}).setdefault(
                        "phases_ms", {})[phase] = m["value"]
                else:
                    scen.setdefault(label, {})[
                        metric[len("perf."):]] = m["value"]
            perf["scenarios"] = scen
            # the verdicts read the bench's golden rows and ledger series
            perf["perf_regression"] = None
            perf["trends"] = None
        status["perf"] = perf or None
        # MFU microscope: the bench mirrors each row's
        # roofline gap budget into `roofline.*` gauges — statusz shows
        # the per-scenario buckets, coverage, and the doctor's mfu_gap
        # verdict so a glance answers "where did the step time go"
        roofline: Dict[str, Any] = {}
        try:
            roof_scen: Dict[str, Dict[str, Any]] = {}
            for name, m in snap.items():
                if (not name.startswith("roofline.")
                        or m.get("type") != "gauge"
                        or "[scenario=" not in name):
                    continue
                metric, _, rest = name.partition("[scenario=")
                label = rest[:-1]
                if metric == "roofline.bucket_ms" and ",sink=" in label:
                    sname, _, sink = label.partition(",sink=")
                    roof_scen.setdefault(sname, {}).setdefault(
                        "buckets_ms", {})[sink] = m["value"]
                else:
                    roof_scen.setdefault(label, {})[
                        metric[len("roofline."):]] = m["value"]
            if roof_scen:
                roofline["scenarios"] = roof_scen
                # row-alikes from the gauges → the doctor's verdict
                # (measured = bucket sum: the budget's own invariant;
                # dominant = largest non-mxu bucket, same rule the
                # roofline block uses)
                recs = []
                for sname, v in roof_scen.items():
                    buckets = v.get("buckets_ms") or {}
                    if not buckets:
                        continue
                    gaps = {s: b for s, b in buckets.items()
                            if s != "mxu"}
                    dom = (max(gaps, key=lambda s: gaps[s])
                           if gaps and max(gaps.values()) > 0 else None)
                    recs.append({
                        "kind": "bench.row", "scenario": sname,
                        "roofline": {
                            "buckets_ms": buckets,
                            "measured_step_ms": sum(
                                float(b or 0.0)
                                for b in buckets.values()),
                            "dominant_sink": dom,
                            "coverage": v.get("coverage"),
                        }})
                try:
                    from .doctor import check_mfu_gap
                    verdicts = check_mfu_gap({0: recs})
                except Exception as e:  # statusz must render
                    vlog(1, "monitor: statusz verdict failed: %r", e)
                    verdicts = []
                roofline["mfu_gap"] = ([
                    {"scenario": f["data"].get("scenario"),
                     "dominant": f["data"].get("dominant"),
                     "share": f["data"].get("share"),
                     "injected": f["data"].get("injected"),
                     "title": f["title"]} for f in verdicts] or None)
        except Exception as e:  # statusz must render
            vlog(1, "monitor: statusz roofline section failed: %r", e)
            roofline = {}
        status["roofline"] = roofline or None
        # interconnect microscope: the bench mirrors
        # each row's per-collective comm sub-budget into
        # `interconnect.*` gauges — statusz shows the per-scenario
        # entries (op, axis, measured, efficiency-vs-modeled) and the
        # doctor's comm_budget verdict
        interconnect: Dict[str, Any] = {}
        try:
            ic_scen: Dict[str, Dict[str, Any]] = {}
            for name, m in snap.items():
                if (not name.startswith("interconnect.")
                        or m.get("type") != "gauge"
                        or "[scenario=" not in name):
                    continue
                metric, _, rest = name.partition("[scenario=")
                metric = metric[len("interconnect."):]
                label = rest[:-1]
                if "," in label:
                    sname, _, rest_lbl = label.partition(",")
                    labels = dict(p.partition("=")[::2]
                                  for p in rest_lbl.split(","))
                    entry = ic_scen.setdefault(sname, {}).setdefault(
                        "by_op", {}).setdefault(
                        (labels.get("op"), labels.get("axis")), {})
                    entry[metric] = m["value"]
                else:
                    ic_scen.setdefault(label, {})[metric] = m["value"]
            if ic_scen:
                scen_out: Dict[str, Any] = {}
                recs = []
                for sname, v in sorted(ic_scen.items()):
                    entries = []
                    for (op, axis), fields in sorted(
                            (v.get("by_op") or {}).items()):
                        entries.append({
                            "op": op,
                            "axis": None if axis in (None, "none") else axis,
                            "measured_ms": fields.get("entry_ms"),
                            "efficiency": fields.get("efficiency")})
                    if v.get("unattributed_ms") is not None:
                        entries.append({"op": "(unattributed)",
                                        "axis": None,
                                        "measured_ms": v["unattributed_ms"]})
                    scen_out[sname] = {
                        "comm_bucket_ms": v.get("comm_bucket_ms"),
                        "overlapped_ms": v.get("overlapped_ms"),
                        "unattributed_ms": v.get("unattributed_ms"),
                        "entries": entries,
                    }
                    recs.append({
                        "kind": "bench.row", "scenario": sname,
                        "roofline": {"measured_step_ms": gauge(
                            f"perf.step_time_ms[scenario={sname}]")},
                        "interconnect": {
                            "comm_bucket_ms": v.get("comm_bucket_ms"),
                            "overlapped_ms": v.get("overlapped_ms"),
                            "entries": entries}})
                interconnect["scenarios"] = scen_out
                try:
                    from .doctor import check_comm_budget
                    verdicts = check_comm_budget({0: recs})
                except Exception as e:  # statusz must render
                    vlog(1, "monitor: statusz verdict failed: %r", e)
                    verdicts = []
                interconnect["comm_budget"] = ([
                    {"scenario": f["data"].get("scenario"),
                     "op": f["data"].get("op"),
                     "axis": f["data"].get("axis"),
                     "efficiency": f["data"].get("efficiency"),
                     "share": f["data"].get("share"),
                     "title": f["title"]} for f in verdicts] or None)
        except Exception as e:  # statusz must render
            vlog(1, "monitor: statusz interconnect section failed: %r", e)
            interconnect = {}
        status["interconnect"] = interconnect or None

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


# ---------------------------------------------------------------------------
# in-flight cross-worker aggregation
# ---------------------------------------------------------------------------
class LiveAggregator:
    """Re-runs the doctor's rule functions over a sliding window of the
    still-growing worker streams.

    Each :meth:`poll` tail-reads every ``worker-*.jsonl`` under
    ``<run_dir>/metrics`` (new files are picked up as workers appear),
    appends the records to a bounded per-worker window, evaluates the
    retrace-storm / HBM / straggler / data-starvation rules on the
    window, rewrites ``<run_dir>/live_status.json`` atomically, and —
    for every verdict *not seen before* — records a ``monitor.alert``
    event (through ``report``, typically the launcher's
    ``SupervisorReport``, whose metrics mirror puts it on the shared
    timeline).  Use ``start()`` for the background-thread form, or call
    ``poll()`` from your own loop.  The JAX aggregator's perf-regression
    and perf-trend rules wait on the port's bench.
    """

    def __init__(self, run_dir: str, interval: Optional[float] = None,
                 window: int = 512, report=None, registry=None,
                 clock=time.time):
        self.run_dir = run_dir
        self.interval = (default_monitor_interval() if interval is None
                         else float(interval))
        self.window = int(window)
        self.report = report
        self._registry = registry
        self._clock = clock
        # poll() runs on both the background thread (_run) and the main
        # thread (stop()'s final sweep, or a caller's own loop); all
        # window/alert state is shared and guarded.  An RLock so the
        # helpers can self-acquire under a poll() that already holds it.
        self._poll_lock = threading.RLock()
        self._tails: Dict[int, StreamTail] = {}      # guarded_by: _poll_lock
        self._windows: Dict[int, deque] = {}         # guarded_by: _poll_lock
        self._alerted: set = set()                   # guarded_by: _poll_lock
        self.alerts: List[Dict[str, Any]] = []       # guarded_by: _poll_lock
        self.polls = 0                               # guarded_by: _poll_lock
        self._last_poll = 0.0                        # guarded_by: _poll_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    # -- discovery + tailing -----------------------------------------------
    def _discover(self) -> None:
        mdir = metrics_dir(self.run_dir)
        if not os.path.isdir(mdir):
            return
        with self._poll_lock:
            for name in sorted(os.listdir(mdir)):
                m = _WORKER_RE.match(name)
                if m and int(m.group(1)) not in self._tails:
                    wid = int(m.group(1))
                    self._tails[wid] = StreamTail(os.path.join(mdir, name))
                    self._windows[wid] = deque(maxlen=self.window)

    def _ingest(self) -> int:
        self._discover()
        fresh = 0
        with self._poll_lock:
            for wid, tail in self._tails.items():
                recs = tail.poll()
                if recs:
                    self._windows[wid].extend(recs)
                    fresh += len(recs)
        return fresh

    # -- rules over the window ---------------------------------------------
    def _evaluate(self) -> List[Dict[str, Any]]:
        from . import doctor
        with self._poll_lock:
            workers = {wid: list(w)
                       for wid, w in self._windows.items() if w}
        if not workers:
            return []
        findings: List[Dict[str, Any]] = []
        findings += doctor.check_memory(workers)
        findings += doctor.check_compilation(workers)
        findings += doctor.check_straggler(workers)
        findings += doctor.check_data_starved(workers)
        findings += doctor.check_comm_bound(workers)
        findings += doctor.check_serving(workers)
        findings += doctor.check_fleet(workers)
        findings += doctor.check_fleet_flapping(workers)
        findings += doctor.check_fleet_slo_burn(workers)
        findings += doctor.check_tail_latency(workers)
        findings += doctor.check_mfu_gap(workers)
        findings += doctor.check_comm_budget(workers)
        findings.sort(key=lambda f: (-f["severity"], f["kind"]))
        return findings

    @staticmethod
    def _alert_key(finding: Dict[str, Any]) -> tuple:
        data = finding.get("data") or {}
        return (finding["kind"], data.get("function"), data.get("device"),
                data.get("worker"), data.get("scenario"))

    def _raise_alerts(self, findings: List[Dict[str, Any]]) -> None:
        for f in findings:
            key = self._alert_key(f)
            with self._poll_lock:
                if key in self._alerted:
                    continue
                self._alerted.add(key)
                alert = {"kind": f["kind"], "severity": f["severity"],
                         "title": f["title"], "evidence": f["evidence"],
                         "first_seen": float(self._clock())}
                self.alerts.append(alert)
            vlog(0, "monitor: ALERT [%d] %s: %s", f["severity"],
                 f["kind"], f["title"])
            reg = self._reg()
            reg.counter("monitor.alerts").inc()
            reg.emit("monitor.alert", verdict=f["kind"],
                     severity=f["severity"], title=f["title"])
            if self.report is not None:
                try:
                    self.report.record("monitor.alert", verdict=f["kind"],
                                       severity=f["severity"],
                                       title=f["title"],
                                       evidence=f["evidence"])
                except Exception as e:  # alerting is best-effort
                    vlog(1, "monitor: alert record failed: %r", e)

    # -- the poll ----------------------------------------------------------
    def poll(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """One tail-read + rule pass; throttled to ``interval`` unless
        ``force``.  Returns the status dict written to
        ``live_status.json`` (None when throttled)."""
        with self._poll_lock:
            now = float(self._clock())
            if not force and now - self._last_poll < self.interval:
                return None
            self._last_poll = now
            self.polls += 1
        self._ingest()
        findings = self._evaluate()
        self._raise_alerts(findings)
        status = self._status(now, findings)
        try:
            fsio.atomic_write_bytes(
                live_status_path(self.run_dir),
                json.dumps(status, indent=1,
                           default=str).encode("utf-8"))
        except OSError as e:
            vlog(1, "monitor: live_status.json write failed: %s", e)
        return status

    def _status(self, now: float,
                findings: List[Dict[str, Any]]) -> Dict[str, Any]:
        with self._poll_lock:
            last_step: Dict[str, Any] = {}
            records_seen: Dict[str, int] = {}
            for wid, window in self._windows.items():
                steps = [r.get("step") for r in window
                         if r.get("kind") == "step"
                         and r.get("step") is not None]
                last_step[str(wid)] = steps[-1] if steps else None
                records_seen[str(wid)] = len(window)
            drops: Dict[str, int] = {}
            for tail in self._tails.values():
                for k, v in tail.drops.items():
                    drops[k] = drops.get(k, 0) + v
            workers = {wid: list(w) for wid, w in self._windows.items() if w}
            return {
                "ts": now,
                "run_dir": os.path.abspath(self.run_dir),
                "polls": self.polls,
                "workers": sorted(self._tails),
                "last_step": last_step,
                "window_records": records_seen,
                "dropped": drops,
                "healthy": not findings,
                "findings": findings,
                # snapshot: the caller serializes this dict after the
                # lock is released, while alerts may keep growing
                "alerts": list(self.alerts),
                "straggler": straggler_stats(workers) if len(workers) > 1
                else None,
            }

    # -- background-thread form --------------------------------------------
    def start(self) -> "LiveAggregator":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ptpu-live-aggregator", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll(force=True)
            except Exception as e:  # the babysitter must outlive its rules
                vlog(0, "monitor: live aggregation pass failed: %r", e)

    def stop(self) -> None:
        """Stop the thread and run one final forced poll, so the status
        file reflects the stream tails at teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            self.poll(force=True)
        except Exception as e:  # the teardown must not raise
            vlog(1, "monitor: final poll failed: %r", e)
