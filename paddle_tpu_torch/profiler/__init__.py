"""``paddle.profiler``: the port of ``paddle_tpu/profiler/__init__.py``
(reference python/paddle/profiler/profiler.py ``Profiler`` with the
scheduler states CLOSED / READY / RECORD / RECORD_AND_RETURN,
``make_scheduler``, the chrome-trace export, ``RecordEvent`` host ranges
and the ``profiler_statistic.py`` summary).

The device side is ``torch.profiler`` with CUDA activities (CUPTI): a
recording window holds every kernel the card ran, with its launch and
device time.  ``RecordEvent`` ranges are ``torch.profiler`` user ranges
in the same timeline, and a host statistic table (name -> count, total
seconds) serves :func:`profiler_summary` and :meth:`Profiler.summary`
without a trace.  Differences by design: the trace is chrome JSON
(``export_chrome_tracing``; ``export_protobuf`` writes the same JSON,
torch has no protobuf trace), not XPlane, and ``ProfilerTarget.TPU`` and
``GPU`` both mean the card.

On a machine whose device clock misplaces the first kernel records of a
CUPTI session, kineto drops those records as outside the recording
window (``torch.profiler.profile`` alone does the same): each window's
set-up therefore runs a few kernels of its own and waits for them before
the window opens.  The same clock may place one of those records inside
the window; :func:`launch_records` pairs each launch of a trace with its
device record in host order, and :func:`unrecorded_launches` counts the
launches that still have none.
"""
from __future__ import annotations

import enum
import functools
import json
import os
import socket
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

__all__ = ["ProfilerTarget", "ProfilerState", "Profiler", "RecordEvent",
           "make_scheduler", "record_function", "profiler_summary",
           "SortedKeys", "export_chrome_tracing", "export_protobuf",
           "load_profiler_result", "launch_records", "unrecorded_launches"]

# kernels each window's set-up launches (and waits for) before it records
_WARM_LAUNCHES = 16


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1          # the card
    TPU = 2          # the card too (source compatibility)


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """step -> state over the cycle [skip_first | (closed, ready,
    record) * repeat]; the last record step of a cycle is
    RECORD_AND_RETURN."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        cycle, pos = divmod(s, period)
        if repeat > 0 and cycle >= repeat:
            return ProfilerState.CLOSED
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


# ---------------------------------------------------------------------------
# Host statistics of the RecordEvent ranges
# ---------------------------------------------------------------------------
_stats_lock = threading.Lock()
_stats: Dict[str, Tuple[int, float]] = {}


def _record_stat(name: str, dt: float) -> None:
    with _stats_lock:
        n, total = _stats.get(name, (0, 0.0))
        _stats[name] = (n + 1, total + dt)


def profiler_summary(reset: bool = False) -> Dict[str, Tuple[int, float]]:
    """{event name: (count, total seconds)} of every RecordEvent so far."""
    with _stats_lock:
        out = dict(_stats)
        if reset:
            _stats.clear()
    return out


class RecordEvent:
    """A named host range, in the trace (a ``torch.profiler`` user range)
    and in the host statistics.  A context manager, or ``begin()`` /
    ``end()``."""

    def __init__(self, name: str, event_type: Any = None):
        self.name = name
        self._range = None
        self._t0 = None

    def begin(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def end(self) -> None:
        if self._range is not None:
            _record_stat(self.name, time.perf_counter() - self._t0)
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self) -> "RecordEvent":
        self.begin()
        return self

    def __exit__(self, *exc) -> None:
        self.end()


def record_function(name: Optional[str] = None):
    """Decorator form of :class:`RecordEvent`."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with RecordEvent(label):
                return fn(*a, **kw)
        return wrapped
    return deco


def _device_time_us(avg) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    return 0.0


class Profiler:
    """paddle.profiler.Profiler(targets, scheduler, on_trace_ready).

    >>> p = Profiler(scheduler=make_scheduler(closed=1, ready=1, record=2,
    ...                                       repeat=1),
    ...              on_trace_ready=export_chrome_tracing("./trace"))
    >>> p.start()
    >>> for batch in loader:
    ...     train_step(...)
    ...     p.step()
    >>> p.stop()

    Each recording window is one ``torch.profiler.profile`` (CUDA
    activities when a target is the card and a card is visible), set up
    in the READY step before it (``prepare_trace``, then ``_WARM_LAUNCHES``
    kernels of its own, waited for: CUPTI is running when the first
    recorded kernel launches), or as the window opens when no READY step
    precedes it, and recording from the first RECORD step
    (``start_trace``); ``on_trace_ready(prof)`` runs when a
    window closes, and :meth:`export` writes its chrome trace.  Each step
    is a ``ProfilerStep#<n>`` range."""

    def __init__(self, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler: Optional[Callable[[int], ProfilerState]] = None,
                 on_trace_ready: Optional[Callable[["Profiler"], None]] = None,
                 log_dir: Optional[str] = None, timer_only: bool = False):
        self.targets = list(targets) if targets else [ProfilerTarget.CPU,
                                                      ProfilerTarget.GPU]
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        self.on_trace_ready = on_trace_ready
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                               "paddle_tpu_torch_profile")
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._tracing = False
        self._prepared = False      # set up in a READY step, not recording
        self._prof = None           # the window being recorded, or the last
        self._step_range = None
        self._step_t0 = None
        self._step_times = []

    def _card(self) -> bool:
        return torch.cuda.is_available() and any(
            t in (ProfilerTarget.GPU, ProfilerTarget.TPU)
            for t in self.targets)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._card():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.current_state = self.scheduler(self.step_num)
        self._apply_state(self.current_state)
        self._begin_step_range()

    def stop(self) -> None:
        self._end_step_range()
        if self._tracing:
            self._stop_trace(trigger_callback=True)
        elif self._prepared:        # a READY window that never recorded
            self._prof.start_trace()
            self._prof.stop_trace()
            self._prepared = False
        self.current_state = ProfilerState.CLOSED

    def step(self) -> None:
        """Advance the scheduler (once per iteration)."""
        self._end_step_range()
        if self._step_t0 is not None:
            self._step_times.append(time.perf_counter() - self._step_t0)
        next_state = self.scheduler(self.step_num + 1)
        self._transition(self.current_state, next_state)
        self.step_num += 1
        self.current_state = next_state
        self._begin_step_range()

    # -- internals ---------------------------------------------------------
    def _begin_step_range(self) -> None:
        if self._tracing:
            self._step_range = torch.profiler.record_function(
                f"ProfilerStep#{self.step_num}")
            self._step_range.__enter__()
        self._step_t0 = time.perf_counter()

    def _end_step_range(self) -> None:
        if self._step_range is not None:
            self._step_range.__exit__(None, None, None)
            self._step_range = None

    def _apply_state(self, state: ProfilerState) -> None:
        if state == ProfilerState.READY:
            self._prepare_trace()
        if state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._start_trace()

    def _transition(self, cur: ProfilerState, new: ProfilerState) -> None:
        recording = cur in (ProfilerState.RECORD,
                            ProfilerState.RECORD_AND_RETURN)
        will_record = new in (ProfilerState.RECORD,
                              ProfilerState.RECORD_AND_RETURN)
        if recording and (not will_record
                          or cur == ProfilerState.RECORD_AND_RETURN):
            self._stop_trace(
                trigger_callback=cur == ProfilerState.RECORD_AND_RETURN)
        if new == ProfilerState.READY and not self._tracing:
            self._prepare_trace()
        if will_record and (not recording
                            or cur == ProfilerState.RECORD_AND_RETURN):
            self._start_trace()

    def _prepare_trace(self) -> None:
        if self._tracing or self._prepared or self.timer_only:
            return
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.prepare_trace()
        if self._card():
            # CUPTI is on: the session's first kernel records, which a
            # misplacing device clock puts outside the window, are these
            scratch = torch.empty(_WARM_LAUNCHES, device="cuda")
            for i in range(_WARM_LAUNCHES):
                scratch[i:i + 1].fill_(0.0)
            torch.cuda.synchronize()
        self._prepared = True

    def _start_trace(self) -> None:
        if self._tracing or self.timer_only:
            return
        self._prepare_trace()
        self._prof.start_trace()
        self._prepared = False
        self._tracing = True

    def _stop_trace(self, trigger_callback: bool) -> None:
        if not self._tracing:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop_trace()
        self._tracing = False
        if trigger_callback and self.on_trace_ready is not None:
            self.on_trace_ready(self)

    # -- results -------------------------------------------------------------
    def export(self, path: str, format: str = "json") -> str:
        """Write the last recording window's chrome trace to ``path``."""
        if self._prof is None:
            raise RuntimeError("no recorded window to export")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._prof.export_chrome_trace(path)
        return path

    def key_averages(self):
        """``torch.profiler``'s per-name table of the last window."""
        return None if self._prof is None else self._prof.key_averages()

    def summary(self, sorted_by: str = "total", reset: bool = False) -> str:
        """The host table (RecordEvent statistics and step times), the
        span tree of ``observability.tracing`` (count, total and self ms
        by path), and the last window's device time by kernel."""
        rows = [(name, n, tot) for name, (n, tot) in
                profiler_summary(reset=reset).items()]
        rows.sort(key=lambda r: r[2], reverse=True)
        lines = [f"{'event':40s} {'count':>8s} {'total ms':>10s} "
                 f"{'avg ms':>10s}"]
        for name, n, tot in rows:
            lines.append(f"{name[:40]:40s} {n:8d} {tot * 1e3:10.2f} "
                         f"{tot / n * 1e3:10.2f}")
        if self._step_times:
            ts = self._step_times
            lines.append(f"steps: {len(ts)}  avg "
                         f"{sum(ts) / len(ts) * 1e3:.2f} ms")
        from ..observability.tracing import span_tree_totals
        tree = span_tree_totals(reset=reset)
        if tree:
            lines.append("")
            lines.append(f"{'span':40s} {'count':>8s} {'total ms':>10s} "
                         f"{'self ms':>10s}")
            for path, row in tree.items():
                lines.append(f"{path[:40]:40s} {row['count']:8d} "
                             f"{row['total_ms']:10.2f} "
                             f"{row['self_ms']:10.2f}")
        avgs = self.key_averages()
        if avgs is not None:
            dev = [(a.key, a.count, _device_time_us(a)) for a in avgs
                   if _device_time_us(a) > 0]
            if dev:
                dev.sort(key=lambda r: r[2], reverse=True)
                lines.append("")
                lines.append(f"{'device':40s} {'count':>8s} "
                             f"{'total ms':>10s}")
                for name, n, us in dev:
                    lines.append(f"{name[:40]:40s} {n:8d} {us / 1e3:10.3f}")
        return "\n".join(lines)

    def __enter__(self) -> "Profiler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class SortedKeys(enum.Enum):
    """Summary-table sort orders."""
    CPUTotal = "total"
    CPUAvg = "avg"
    CPUMax = "max"
    CPUMin = "min"
    GPUTotal = "device_total"
    GPUAvg = "device_avg"


def _trace_handler(dir_name: str, worker_name: Optional[str], suffix: str):
    def handler(prof: Profiler):
        worker = worker_name or f"{socket.gethostname()}_{os.getpid()}"
        prof.export(os.path.join(
            dir_name, f"{worker}.step{prof.step_num}.{suffix}"))
    return handler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` handler writing each window's chrome trace to
    ``dir_name/<worker>.step<n>.paddle_trace.json``."""
    return _trace_handler(dir_name, worker_name, "paddle_trace.json")


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """As :func:`export_chrome_tracing` (torch writes no protobuf trace):
    ``dir_name/<worker>.step<n>.paddle_trace.pb.json``."""
    return _trace_handler(dir_name, worker_name, "paddle_trace.pb.json")


def load_profiler_result(file_name: str):
    """An exported chrome trace, read back (the ``traceEvents`` dict)."""
    with open(file_name) as f:
        return json.load(f)


def launch_records(trace):
    """``[(launch, device)]`` of a chrome trace (``load_profiler_result``)
    in host order: each runtime or driver launch record the tracer saw on
    the host, with the kernel, copy or set record on the device of the
    same correlation id, or None where the tracer dropped it."""
    events = trace.get("traceEvents", [])
    device = {}
    for e in events:
        if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            device.setdefault(e.get("args", {}).get("correlation"), e)
    launches = sorted(
        (e for e in events
         if str(e.get("cat", "")).lower() in ("cuda_runtime", "cuda_driver")
         and "Launch" in str(e.get("name", ""))
         and "HostFunc" not in str(e.get("name", ""))),
        key=lambda e: float(e.get("ts", 0.0)))
    return [(e, device.get(e.get("args", {}).get("correlation")))
            for e in launches]


def unrecorded_launches(trace) -> int:
    """The launches of a chrome trace whose device record the tracer
    dropped (:func:`launch_records`)."""
    return sum(1 for _, dev in launch_records(trace) if dev is None)
