"""CPU parity of the rest of the port's observability with the JAX
package's: the ``StderrSummary`` and ``PrometheusTextfile`` sinks
(``sinks.py``), the status page's bench, ``elastic`` and ``compile``
sections and ``LiveAggregator`` (``monitor.py``), the span exporter
(``tracing.py``), and the trace drill (``inference/fleet/drills.py``).

Both packages see the same instruments and the same growing worker
streams; what they render and find is **equal**, apart from wall-clock
fields, which are named where they are dropped (``ts``, ``time``,
``first_seen``, ``run_dir``).  The trace drill runs two CPU worker
processes with one torch thread each (the suite's other workers share the
cores)."""
import json
import logging
import os

import pytest

from paddle_tpu.observability import monitor as jmon
from paddle_tpu.observability import sinks as jsinks
from paddle_tpu.observability.registry import MetricsRegistry as JRegistry
from paddle_tpu.supervisor.report import SupervisorReport as JReport

from paddle_tpu_torch.observability import monitor as tmon
from paddle_tpu_torch.observability import sinks as tsinks
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.supervisor.report import SupervisorReport as TReport


def _fill(reg):
    reg.counter("supervisor.rollback").inc()
    reg.counter("step.count").inc(3)
    reg.gauge("step.mfu").set(0.45)
    reg.histogram("step.time_ms").observe(10.0)
    reg.gauge("elastic.generation").set(2)
    reg.gauge("elastic.world_size").set(4)
    reg.gauge("elastic.dp").set(4)
    reg.counter("elastic.resizes").inc(1)
    reg.gauge("perf.step_time_ms[scenario=synthetic_b]").set(90.0)
    reg.gauge("perf.mfu[scenario=synthetic_b]").set(0.3)
    reg.gauge("perf.phase_ms[scenario=synthetic_b,phase=compute]").set(70.0)
    for sink, ms in (("mxu", 10.0), ("memory_bound", 60.0), ("comm", 20.0)):
        reg.gauge(f"roofline.bucket_ms[scenario=synthetic_a,sink={sink}]"
                  ).set(ms)
    reg.gauge("roofline.coverage[scenario=synthetic_a]").set(0.9)
    reg.gauge("interconnect.comm_bucket_ms[scenario=synthetic_b]").set(50.0)
    reg.gauge("interconnect.overlapped_ms[scenario=synthetic_b]").set(4.0)
    reg.gauge("interconnect.unattributed_ms[scenario=synthetic_b]").set(15.0)
    reg.gauge("interconnect.entry_ms[scenario=synthetic_b,op=all_reduce,"
              "axis=dp]").set(35.0)
    reg.gauge("interconnect.efficiency[scenario=synthetic_b,op=all_reduce,"
              "axis=dp]").set(0.57)
    return reg


def test_prometheus_textfile_matches_jax(tmp_path):
    treg, jreg = _fill(MetricsRegistry()), _fill(JRegistry())
    tpath, jpath = str(tmp_path / "t.prom"), str(tmp_path / "j.prom")
    treg.add_sink(tsinks.PrometheusTextfile(tpath, interval=0.0))
    jreg.add_sink(jsinks.PrometheusTextfile(jpath, interval=0.0))
    treg.emit("step", step=0)
    jreg.emit("step", step=0)
    with open(tpath) as f, open(jpath) as g:
        text = f.read()
        assert text == g.read()
    assert "paddle_tpu_step_count 3" in text
    assert text == tsinks.render_prometheus(treg)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_stderr_summary_logs_the_jax_line():
    from paddle_tpu.framework.log import get_logger as jlogger
    from paddle_tpu_torch.framework.log import get_logger as tlogger
    lines = {}
    for name, Reg, mod, logger in (
            ("port", MetricsRegistry, tsinks, tlogger()),
            ("jax", JRegistry, jsinks, jlogger())):
        reg = Reg()
        reg.counter("supervisor.rollback").inc()
        s = reg.add_sink(mod.StderrSummary(interval=0.0))
        handler = _Lines()
        logger.addHandler(handler)
        try:
            reg.emit("step", step=5, step_time_ms=12.0,
                     tokens_per_sec=100.0, mfu=0.41)
        finally:
            logger.removeHandler(handler)
        assert s.emitted >= 1 and s._last_step["step"] == 5
        lines[name] = [m for m in handler.lines if m.startswith("metrics:")]
    assert lines["port"] == lines["jax"] and lines["port"]
    assert "step=5 step_ms=12.0 tok/s=100 mfu=0.410" in lines["port"][-1]


def test_status_page_sections_match_jax():
    tpage = tmon.StatusServer(registry=_fill(MetricsRegistry())).statusz()
    jpage = jmon.StatusServer(registry=_fill(JRegistry())).statusz()
    for key in ("elastic", "roofline", "interconnect"):
        assert tpage[key] is not None, key
        assert json.loads(json.dumps(tpage[key], default=str)) == \
            json.loads(json.dumps(jpage[key], default=str)), key
    assert tpage["roofline"]["mfu_gap"][0]["dominant"] == "memory_bound"
    assert tpage["interconnect"]["comm_budget"][0]["op"] == "all_reduce"
    assert tpage["perf"]["scenarios"] == jpage["perf"]["scenarios"]
    # the bench's verdicts wait on the port's bench; the compile tracker
    # on a tracker of the port's own
    assert tpage["perf"]["perf_regression"] is None
    assert tpage["perf"]["trends"] is None
    assert "compile" in tpage and tpage["compile"] is None
    bare = tmon.StatusServer(registry=MetricsRegistry()).statusz()
    for key in ("elastic", "perf", "roofline", "interconnect", "compile"):
        assert bare[key] is None, key


def _append(mdir, wid, records):
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, f"worker-{wid}.jsonl"), "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _steps(lo, hi, ms):
    return [{"ts": 1000.0 + s, "kind": "step", "step": s,
             "step_time_ms": ms, "data_ms": 1.0} for s in range(lo, hi)]


def _strip(status):
    """The live status without its wall-clock and location fields."""
    out = {k: v for k, v in status.items() if k not in ("ts", "run_dir")}
    out["alerts"] = [{k: v for k, v in a.items() if k != "first_seen"}
                     for a in status["alerts"]]
    return json.loads(json.dumps(out, default=str))


def test_live_aggregator_names_a_straggler_as_jax(tmp_path):
    runs = {}
    for name, mod, Report in (("port", tmon, TReport),
                              ("jax", jmon, JReport)):
        run_dir = str(tmp_path / name)
        mdir = os.path.join(run_dir, "metrics")
        report = Report(os.path.join(run_dir, "supervisor_report.json"))
        reg = MetricsRegistry() if name == "port" else JRegistry()
        agg = mod.LiveAggregator(run_dir, interval=0, report=report,
                                 registry=reg)
        _append(mdir, 0, _steps(0, 20, 10.0))
        _append(mdir, 1, _steps(0, 4, 50.0))       # 4 of 20 so far
        first = agg.poll(force=True)
        with open(mod.live_status_path(run_dir)) as f:
            on_disk = json.load(f)
        _append(mdir, 1, _steps(4, 20, 50.0))      # the stream grows
        with open(os.path.join(mdir, "worker-1.jsonl"), "a") as f:
            f.write('{"ts": 2000.0, "kind": "st')   # a torn tail
        second = agg.poll(force=True)
        runs[name] = (first, on_disk, second, report, reg)
    (t1, tdisk, t2, trep, treg), (j1, _, j2, jrep, _) = runs["port"], \
        runs["jax"]
    assert _strip(t1) == _strip(j1) and _strip(t2) == _strip(j2)
    assert _strip(tdisk) == _strip(t1)
    strag = [f for f in t1["findings"] if f["kind"] == "straggler"]
    assert strag and strag[0]["data"]["worker"] == 1
    assert t1["last_step"] == {"0": 19, "1": 3}
    assert len(t2["alerts"]) == 1 and t2["last_step"]["1"] == 19
    alerts = trep.of_kind("monitor.alert")
    assert [a["verdict"] for a in alerts] == [
        a["verdict"] for a in jrep.of_kind("monitor.alert")] == ["straggler"]
    assert treg.snapshot()["monitor.alerts"]["value"] == 1


def test_live_aggregator_thread_form_and_throttle(tmp_path):
    run_dir = str(tmp_path / "run")
    agg = tmon.LiveAggregator(run_dir, interval=3600)
    assert agg.poll(force=True) is not None
    assert agg.poll() is None                      # throttled
    agg = tmon.LiveAggregator(run_dir, interval=0.01)
    _append(os.path.join(run_dir, "metrics"), 0, _steps(0, 5, 10.0))
    agg.start()
    agg.stop()                                     # one final forced poll
    with open(tmon.live_status_path(run_dir)) as f:
        status = json.load(f)
    assert status["last_step"] == {"0": 4} and status["healthy"]


def test_span_chrome_export(tmp_path):
    ttracing.reset_tracing()
    with ttracing.span("step"):
        with ttracing.span("dispatch"):
            pass
    path = str(tmp_path / "spans.json")
    assert ttracing.export_chrome_trace(path, reset=True) == 2
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert names == {"step", "step/dispatch"}
    assert ttracing.trace_events() == []
    ttracing.reset_tracing()
    assert ttracing.span_tree_totals() == {}


def test_trace_drill_on_the_cpu(tmp_path, monkeypatch):
    from paddle_tpu_torch.inference.fleet import drills
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = drills.trace_drill(str(tmp_path), device="cpu")
    assert out["complete"] == out["traces"] == out["streams"] == 8
    assert out["token_exact"] == 8 and out["orphan_spans"] == 0
    assert out["stitched_across_replicas"] >= 1
    assert out["coverage_min"] >= 0.95
    assert out["tail_dominant"] == "failover_recompute"
    assert out["wal_matched"] == 8


def test_a_reply_cut_short_is_a_transport_failure():
    """A replica killed mid-reply leaves a short body; the router's
    failover path sees it as any transport failure (ConnectionError)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from paddle_tpu_torch.inference.fleet.replica import HttpReplica

    class Cut(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "64")
            self.end_headers()
            self.wfile.write(b'{"tokens": [1')
            self.wfile.flush()
            self.connection.close()

    server = ThreadingHTTPServer(("127.0.0.1", 0), Cut)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rep = HttpReplica(0, server.server_address[1], timeout=5.0)
        with pytest.raises(ConnectionError):
            rep.poll("fleet-0", start=0)
    finally:
        server.shutdown()
        server.server_close()
