"""CPU parity of the port's run doctor (``paddle_tpu_torch/observability/
doctor.py``) and cross-worker aggregation (``aggregate.py``) with the JAX
package's, on the same synthetic run directory.

One degraded run is written once a test to ``tmp_path`` (three workers'
JSONL streams, a supervisor report): a retrace storm, device memory
creeping to its limit and an OOM, a straggler, data starvation, a
communication-bound collective, a poisoned request and deadline misses, a
fleet failover, a flapping replica, an SLO burn at the fleet ceiling,
request traces whose tail pays for a failover recompute, roofline and
interconnect bench rows, supervisor interventions and an integrity
desync.  Every rule's findings, the ranked diagnosis, the report text,
the summary, the straggler statistics and the Chrome trace are **equal**
between the packages (pure-Python arithmetic on the same records).  The
only text that differs is the command a finding points the operator to:
the port names its own ``paddle_tpu_torch.observability`` modules
(``_same``)."""
import json
import os
import shutil

import numpy as np
import pytest

from paddle_tpu.observability import aggregate as jagg
from paddle_tpu.observability import doctor as jdoc
from paddle_tpu.supervisor.report import SupervisorReport as JReport

from paddle_tpu_torch.observability import aggregate as tagg
from paddle_tpu_torch.observability import doctor as tdoc
from paddle_tpu_torch.supervisor.report import SupervisorReport as TReport


def _same(port, jax):
    """Equal, once the port's module paths read as the JAX package's."""
    text = json.dumps(port, sort_keys=True, default=str)
    text = text.replace("paddle_tpu_torch.observability",
                        "paddle_tpu.observability")
    assert json.loads(text) == json.loads(
        json.dumps(jax, sort_keys=True, default=str))


def _steps(wid, n=30, slow=False, data_ms=1.0):
    rng = np.random.RandomState(7 + wid)
    return [{"ts": 1000.0 + s, "kind": "step", "step": s,
             "step_time_ms": 100.0 + float(rng.rand()) * 2.0
             + (30.0 if slow else 0.0), "data_ms": data_ms,
             "tokens_per_sec": 1000.0, "mfu": 0.2}
            for s in range(n)]


def _trace_records():
    """Six requests over two replicas; the two that failed over pay a
    recompute the others do not."""
    recs = []
    for i in range(6):
        tid, rid = f"t{i}", f"fleet-{i}"
        t0 = 2000.0 + 0.01 * i
        victim = i >= 4
        end = t0 + (0.9 if victim else 0.5)
        recs.append({"ts": t0, "kind": "trace.request", "trace_id": tid,
                     "request_id": rid, "t0": t0, "proc": "router"})
        recs.append({"ts": t0, "kind": "trace.span", "trace_id": tid,
                     "request_id": rid, "name": "dispatch",
                     "component": "dispatch", "t0": t0, "t1": t0 + 0.01,
                     "dur_ms": 10.0, "proc": "router"})
        recs.append({"ts": t0, "kind": "trace.span", "trace_id": tid,
                     "request_id": rid, "name": "prefill",
                     "component": "prefill", "t0": t0 + 0.01,
                     "t1": t0 + 0.05, "dur_ms": 40.0,
                     "proc": f"replica-{i % 2}"})
        if victim:
            recs.append({"ts": t0, "kind": "trace.span", "trace_id": tid,
                         "request_id": rid, "name": "prefill",
                         "component": "failover_recompute",
                         "t0": t0 + 0.3, "t1": t0 + 0.7, "dur_ms": 400.0,
                         "proc": "replica-1"})
        recs.append({"ts": end, "kind": "trace.span", "trace_id": tid,
                     "request_id": rid, "name": "deliver",
                     "component": "deliver", "t0": t0 + 0.01, "t1": end,
                     "dur_ms": (end - t0 - 0.01) * 1e3, "proc": "router"})
        recs.append({"ts": end, "kind": "trace.request_end",
                     "trace_id": tid, "request_id": rid, "t1": end,
                     "reason": "length", "tokens": 16, "proc": "router"})
    for k in range(20):
        t = 2000.05 + 0.02 * k
        recs.append({"ts": t, "kind": "trace.span", "name": "decode_batch",
                     "component": "decode", "t0": t, "t1": t + 0.02,
                     "dur_ms": 20.0, "residents": 4, "proc": "replica-0",
                     "requests": [[f"fleet-{i}", f"t{i}"]
                                  for i in range(6)]})
    return recs


def _worker0():
    recs = _steps(0)
    recs += [
        {"ts": 1000.5, "kind": "compile", "function": "hapi.train_step",
         "retrace": False, "changed": [], "wall_ms": 500.0, "nargs": 6},
        *[{"ts": 1001.0 + i, "kind": "compile",
           "function": "hapi.train_step", "retrace": True,
           "changed": [{"arg": "data[1]",
                        "detail": "int32[2,8] -> int32[2,12]"}],
           "wall_ms": 400.0, "nargs": 6} for i in range(4)],
        {"ts": 1006.0, "kind": "compile.retrace_storm",
         "function": "hapi.train_step", "retraces": 4, "window": 16,
         "culprits": ["data[1]"], "culprit": "data[1]"},
    ]
    recs += [{"ts": 1000.0 + i, "kind": "memory", "step": i,
              "devices": {"cuda:0": {
                  "bytes_in_use": 500 + 900 * i,
                  "peak_bytes_in_use": 600 + 900 * i,
                  "bytes_limit": 10_000}}} for i in range(10)]
    recs.append({"ts": 1030.0, "kind": "memory.oom", "step": 29,
                 "error": "CUDA out of memory",
                 "devices": {"cuda:0": {"bytes_in_use": 9900,
                                        "peak_bytes_in_use": 9990,
                                        "bytes_limit": 10_000}}})
    recs.append({"ts": 1031.0, "kind": "metrics.snapshot", "snapshot": {
        "step.time_ms": {"type": "histogram", "count": 30, "p50": 101.0},
        "collective.all_reduce.ms[axis=dp,n=8]": {
            "type": "histogram", "count": 30, "p50": 60.0, "p99": 70.0},
        "collective.all_gather.ms": {
            "type": "histogram", "count": 30, "p50": 5.0, "p99": 6.0}}})
    recs += [
        {"ts": 1040.0, "kind": "serve.quarantine", "request_id": "r7",
         "step_kind": "decode", "error": "RuntimeError('nan logits')"},
        {"ts": 1041.0, "kind": "serve.deadline_miss", "request_id": "r8",
         "miss": "ttft"},
        {"ts": 1042.0, "kind": "serve.deadline_miss", "request_id": "r9",
         "miss": "total"},
        {"ts": 1050.0, "kind": "fleet.replica_state", "replica": 0,
         "state": "dead"},
        {"ts": 1050.1, "kind": "fleet.failover", "request_id": "fleet-4",
         "from_replica": 0, "to_replica": 1, "why": "replica died",
         "accepted_tokens": 5},
        {"ts": 1050.2, "kind": "fleet.failover", "request_id": "fleet-5",
         "from_replica": 0, "to_replica": 1, "why": "replica died",
         "accepted_tokens": 3},
        {"ts": 1051.0, "kind": "fleet.breaker", "replica": 1,
         "state": "open", "prev": "closed"},
        {"ts": 1052.0, "kind": "fleet.breaker", "replica": 1,
         "state": "open", "prev": "half_open"},
        {"ts": 1052.5, "kind": "fleet.shed", "why": "retry_budget"},
        {"ts": 1052.6, "kind": "fleet.deferred", "request_id": "fleet-5"},
        {"ts": 1053.0, "kind": "fleet.autoscale", "action": "up",
         "target": 3, "burn": 2.5, "why": "ttft p99 over the SLO"},
        {"ts": 1054.0, "kind": "fleet.autoscale",
         "action": "blocked_at_max", "replicas": 4, "burn": 3.0,
         "why": "still burning"},
        {"ts": 1060.0, "kind": "bench.row", "scenario": "synthetic_a",
         "roofline": {"buckets_ms": {"mxu": 10.0, "memory_bound": 60.0,
                                     "comm": 20.0, "residual": 10.0},
                      "measured_step_ms": 100.0,
                      "dominant_sink": "memory_bound", "coverage": 0.9}},
        {"ts": 1061.0, "kind": "bench.row", "scenario": "synthetic_b",
         "roofline": {"buckets_ms": {"mxu": 40.0, "comm": 50.0},
                      "measured_step_ms": 90.0, "dominant_sink": "comm"},
         "interconnect": {
             "comm_bucket_ms": 50.0, "overlapped_ms": 4.0,
             "entries": [
                 {"op": "all_reduce", "axis": "dp", "measured_ms": 35.0,
                  "modeled_ms": 20.0, "efficiency": 0.57,
                  "participants": 8},
                 {"op": "(unattributed)", "axis": None,
                  "measured_ms": 15.0}]}},
    ]
    recs += _trace_records()
    recs.sort(key=lambda r: r["ts"])
    return recs


def _write_run(root):
    run_dir = str(root / "run")
    mdir = os.path.join(run_dir, "metrics")
    os.makedirs(mdir)
    streams = {0: _worker0(), 1: _steps(1, slow=True),
               2: _steps(2, data_ms=160.0)}
    for wid, recs in streams.items():
        with open(os.path.join(mdir, f"worker-{wid}.jsonl"), "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        # a torn tail and a garbled line: counted, never fatal
        with open(os.path.join(mdir, f"worker-{wid}.jsonl"), "a") as f:
            f.write("not json\n" + '{"ts": 9.0, "kind": "st')
    events = [{"kind": "rollback", "step": 12},
              {"kind": "watchdog_timeout", "step": 13},
              {"kind": "integrity.desync", "step": 20, "suspects": [1]},
              {"kind": "integrity.audit", "step": 20,
               "verdict": "sdc_suspect"},
              {"kind": "integrity.heal", "step": 20, "action": "resync"}]
    with open(os.path.join(run_dir, "supervisor_report.json"), "w") as f:
        json.dump({"events": events}, f)
    return run_dir, streams, events


def _workers(run_dir, pkg):
    mdir = os.path.join(run_dir, "metrics")
    return {int(n.split("-")[1].split(".")[0]): pkg.read_worker_stream(
        os.path.join(mdir, n)) for n in sorted(os.listdir(mdir))}


_WORKER_RULES = ["check_compilation", "check_memory", "check_straggler",
                 "check_data_starved", "check_comm_bound", "check_serving",
                 "check_fleet", "check_fleet_flapping",
                 "check_fleet_slo_burn", "check_tail_latency",
                 "check_mfu_gap", "check_comm_budget"]


@pytest.mark.parametrize("rule", _WORKER_RULES)
def test_each_rule_finds_what_the_jax_rule_finds(tmp_path, rule):
    run_dir, _, _ = _write_run(tmp_path)
    jw, tw = _workers(run_dir, jagg), _workers(run_dir, tagg)
    _same(tw, jw)
    got, want = getattr(tdoc, rule)(tw), getattr(jdoc, rule)(jw)
    assert got, f"{rule}: the synthetic run must exercise the rule"
    _same(got, want)


@pytest.mark.parametrize("rule", ["check_supervisor", "check_integrity"])
def test_event_rules_match_jax(tmp_path, rule):
    _, _, events = _write_run(tmp_path)
    got = getattr(tdoc, rule)(events)
    assert got
    _same(got, getattr(jdoc, rule)(events))


def test_diagnosis_report_and_mirror_match_jax(tmp_path):
    run_dir, _, _ = _write_run(tmp_path)
    jrun = str(tmp_path / "jrun")
    shutil.copytree(run_dir, jrun)
    for d in (run_dir, jrun):
        with open(os.path.join(d, "supervisor_report.json")) as f:
            events = json.load(f)["events"]
        os.remove(os.path.join(d, "supervisor_report.json"))
        rep = (TReport if d == run_dir else JReport)(
            os.path.join(d, "supervisor_report.json"))
        for e in events:
            rep.record(e["kind"], **{k: v for k, v in e.items()
                                     if k != "kind"})
    got, want = tdoc.diagnose(run_dir), jdoc.diagnose(jrun)
    assert not got["healthy"] and len(got["findings"]) >= 14
    # the only run-specific field is the directory itself
    _same({**got, "run_dir": None}, {**want, "run_dir": None})
    assert got["findings"][0]["kind"] == "oom"
    _same(tdoc.render_report(got).replace(run_dir, "R"),
          jdoc.render_report(want).replace(jrun, "R"))
    with open(os.path.join(run_dir, "diagnosis.json")) as f:
        assert json.load(f)["findings"] == json.loads(
            json.dumps(got["findings"], default=str))
    tv = TReport.load(os.path.join(run_dir, "supervisor_report.json"))
    jv = JReport.load(os.path.join(jrun, "supervisor_report.json"))
    # "time" is each event's wall clock
    strip = [{k: v for k, v in e.items() if k != "time"}
             for e in tv.of_kind("doctor.verdict")]
    jstrip = [{k: v for k, v in e.items() if k != "time"}
              for e in jv.of_kind("doctor.verdict")]
    assert strip and len(strip) == len(got["findings"])
    _same(strip, jstrip)


def test_aggregate_summary_straggler_and_chrome_trace_match_jax(tmp_path):
    run_dir, _, _ = _write_run(tmp_path)
    jrun = str(tmp_path / "jrun")
    shutil.copytree(run_dir, jrun)
    got, want = tagg.aggregate_run(run_dir), jagg.aggregate_run(jrun)
    # wall-clock and location fields: generated_at, run_dir
    for d in (got, want):
        d.pop("generated_at", None)
        d.pop("run_dir", None)
    _same(got, want)
    assert got["straggler"]["straggler"] == 1
    drops = {}
    tagg.read_worker_stream(os.path.join(run_dir, "metrics",
                                         "worker-1.jsonl"), drops)
    assert drops == {"garbled": 1, "torn": 1} or sum(drops.values()) == 2
    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    n = tagg.export_chrome_trace(run_dir, out_t)
    assert n == jagg.export_chrome_trace(jrun, out_j) and n > 0
    with open(out_t) as f, open(out_j) as g:
        _same(json.load(f), json.load(g))


def test_stream_tail_reads_only_whole_lines(tmp_path):
    path = str(tmp_path / "worker-0.jsonl")
    tails = (tagg.StreamTail(path), jagg.StreamTail(path))
    with open(path, "w") as f:
        f.write(json.dumps({"ts": 1, "kind": "step"}) + "\n"
                + '{"ts": 2, "kind"')
    first = [t.poll() for t in tails]
    with open(path, "a") as f:
        f.write(': "step"}\n')
    second = [t.poll() for t in tails]
    with open(path, "w") as f:             # truncated: read again
        f.write(json.dumps({"ts": 3, "kind": "step"}) + "\n")
    third = [t.poll() for t in tails]
    _same(first[0], first[1])
    _same(second[0], second[1])
    _same(third[0], third[1])
    assert [len(first[0]), len(second[0])] == [1, 1]
    _same(tails[0].drops, tails[1].drops)


def test_cli_main(tmp_path, capsys):
    run_dir, _, _ = _write_run(tmp_path)
    assert tdoc.main([run_dir]) == 0
    out = capsys.readouterr().out
    assert "finding(s), most severe first" in out and "oom" in out
    assert tdoc.main(["--json", run_dir]) == 0
    assert json.loads(capsys.readouterr().out)["findings"]
    assert tdoc.main([str(tmp_path / "empty")]) == 1
    assert tdoc.main([]) == 2
    assert tagg.main([run_dir]) == 0
    assert os.path.exists(os.path.join(run_dir, "metrics", "summary.json"))
