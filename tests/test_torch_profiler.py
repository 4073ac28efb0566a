"""``paddle_tpu_torch.profiler`` against ``paddle_tpu.profiler`` on the CPU.

Exact: the scheduler's state sequence, the steps at which a recording
window opens and closes and ``on_trace_ready`` runs (the JAX tracer is
replaced by a recorder here, the port records with ``torch.profiler``),
the host statistic table of the ``RecordEvent`` ranges.  The chrome trace
is written and read back with the ranges in it.  By design the trace is
chrome JSON (not XPlane) and ``ProfilerTarget.TPU`` / ``GPU`` both mean
the card (pinned below).
"""
from __future__ import annotations

import glob
import os

import pytest
import torch

import jax

import paddle_tpu.profiler as jprof
import paddle_tpu_torch.profiler as tprof

CONFIGS = [dict(closed=1, ready=1, record=2),
           dict(closed=0, ready=0, record=1),
           dict(closed=2, ready=1, record=3, repeat=2),
           dict(closed=1, ready=2, record=1, repeat=1, skip_first=3)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(i) for i in range(4)])
def test_scheduler_states_equal_jax(cfg):
    js, ts = jprof.make_scheduler(**cfg), tprof.make_scheduler(**cfg)
    assert [ts(i).name for i in range(30)] == [js(i).name for i in range(30)]
    assert [s.value for s in tprof.ProfilerState] == \
        [s.value for s in jprof.ProfilerState]


def _drive(mod, cfg, events, steps=9, **kw):
    prof = mod.Profiler(scheduler=mod.make_scheduler(**cfg),
                        on_trace_ready=lambda p: events.append(
                            ("ready", p.step_num)), **kw)
    prof.start()
    for _ in range(steps):
        with mod.RecordEvent("work"):
            torch.ones(4) @ torch.ones(4)
        prof.step()
    prof.stop()
    return prof


@pytest.mark.parametrize("cfg", CONFIGS, ids=[str(i) for i in range(4)])
def test_recording_windows_and_callbacks_follow_jax(cfg, monkeypatch,
                                                    tmp_path):
    jev, tev = [], []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: jev.append(("start", None)))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: jev.append(("stop", None)))

    class StepAnn:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *e):
            return None
    monkeypatch.setattr(jax.profiler, "StepTraceAnnotation", StepAnn)
    jp = _drive(jprof, cfg, jev, log_dir=str(tmp_path))
    orig_start, orig_stop = tprof.Profiler._start_trace, \
        tprof.Profiler._stop_trace

    def start(self):
        if not self._tracing:
            tev.append(("start", None))
        orig_start(self)

    def stop(self, trigger_callback):
        if self._tracing:
            tev.append(("stop", None))
        orig_stop(self, trigger_callback)
    monkeypatch.setattr(tprof.Profiler, "_start_trace", start)
    monkeypatch.setattr(tprof.Profiler, "_stop_trace", stop)
    tp = _drive(tprof, cfg, tev)
    assert tev == jev
    assert tp.step_num == jp.step_num == 9
    assert tp.current_state == tprof.ProfilerState.CLOSED


def test_record_event_statistics_match_jax():
    jprof.profiler_summary(reset=True)
    tprof.profiler_summary(reset=True)
    for mod in (jprof, tprof):
        @mod.record_function("deco")
        def f(x):
            return x + 1
        for _ in range(3):
            f(1)
        ev = mod.RecordEvent("manual")
        ev.begin()
        ev.end()
        ev.end()                               # a second end is a no-op
    j, t = jprof.profiler_summary(), tprof.profiler_summary(reset=True)
    assert {k: v[0] for k, v in t.items()} == {k: v[0] for k, v in j.items()}
    assert t["deco"][0] == 3 and t["manual"][0] == 1
    assert tprof.profiler_summary() == {}


def test_chrome_export_load_and_summary(tmp_path):
    tprof.profiler_summary(reset=True)
    out = tmp_path / "trace"
    prof = tprof.Profiler(
        scheduler=tprof.make_scheduler(closed=1, ready=1, record=2,
                                       repeat=1),
        on_trace_ready=tprof.export_chrome_tracing(str(out), "w0"))
    with prof:
        for _ in range(5):
            with tprof.RecordEvent("matmul_range"):
                torch.randn(32, 32) @ torch.randn(32, 32)
            prof.step()
    files = sorted(glob.glob(str(out / "*.json")))
    assert [os.path.basename(f) for f in files] == \
        ["w0.step3.paddle_trace.json"]
    trace = tprof.load_profiler_result(files[0])
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert names.count("matmul_range") == 2          # steps 2 and 3
    assert "ProfilerStep#2" in names and "ProfilerStep#3" in names
    assert "ProfilerStep#1" not in names
    text = prof.summary()
    assert "matmul_range" in text and "steps: 5" in text
    assert prof.key_averages() is not None
    pb = tprof.Profiler(scheduler=tprof.make_scheduler(closed=0, ready=0,
                                                       record=1, repeat=1),
                        on_trace_ready=tprof.export_protobuf(str(out)))
    with pb:
        torch.ones(2) + 1
        pb.step()
    assert glob.glob(str(out / "*.paddle_trace.pb.json"))


def test_timer_only_records_no_window():
    calls = []
    prof = tprof.Profiler(on_trace_ready=lambda p: calls.append(1),
                          timer_only=True)
    with prof:
        for _ in range(3):
            prof.step()
    assert calls == [] and prof.key_averages() is None
    with pytest.raises(RuntimeError):
        prof.export("x.json")
    assert "steps: 3" in prof.summary()


def test_gpu_and_tpu_targets_both_mean_the_card(monkeypatch):
    # a difference by design: the JAX TPU target is the card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    acts = {t: tprof.Profiler(targets=[tprof.ProfilerTarget.CPU, t])
            ._activities() for t in (tprof.ProfilerTarget.GPU,
                                     tprof.ProfilerTarget.TPU)}
    cuda = torch.profiler.ProfilerActivity.CUDA
    assert acts[tprof.ProfilerTarget.GPU] == acts[tprof.ProfilerTarget.TPU]
    assert cuda in acts[tprof.ProfilerTarget.GPU]
    assert cuda not in tprof.Profiler(
        targets=[tprof.ProfilerTarget.CPU])._activities()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cuda not in tprof.Profiler()._activities()
    assert [k.value for k in tprof.SortedKeys] == \
        [k.value for k in jprof.SortedKeys]
    assert [t.value for t in tprof.ProfilerTarget] == \
        [t.value for t in jprof.ProfilerTarget]


def test_unrecorded_launches_counts_launches_without_a_device_record():
    # a port extension (the JAX profiler has no host launch records): the
    # launch of correlation 2 lost its kernel record, 3 is a host function
    # (no device record by nature), 4 a copy kept as gpu_memcpy
    def ev(cat, name, corr):
        return {"cat": cat, "name": name, "ts": corr,
                "args": {"correlation": corr}}
    trace = {"traceEvents": [
        ev("cuda_runtime", "cudaLaunchKernel", 1),
        ev("kernel", "k1", 1),
        ev("cuda_runtime", "cudaLaunchKernelExC", 2),
        ev("cuda_runtime", "cudaLaunchHostFunc", 3),
        ev("cuda_driver", "cuLaunchKernel", 4),
        ev("gpu_memcpy", "Memcpy HtoD", 4),
        ev("cuda_runtime", "cudaMemcpyAsync", 5),
        ev("user_annotation", "step", 6)]}
    assert tprof.unrecorded_launches(trace) == 1
    pairs = [(launch["args"]["correlation"], rec and rec["name"])
             for launch, rec in tprof.launch_records(trace)]
    assert pairs == [(1, "k1"), (2, None), (4, "Memcpy HtoD")]
    trace["traceEvents"].append(ev("Kernel", "k2", 2))
    assert tprof.unrecorded_launches(trace) == 0
    assert tprof.unrecorded_launches({}) == 0
