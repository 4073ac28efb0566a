"""Typed span tracing: the port's own copy of ``paddle_tpu/observability/
tracing.py``.

``with span("data_load"): ...`` / ``with span("step"): ...`` nest on a
per-thread stack; a nested span's identity is its *path*
("step/dispatch"), so the same leaf name under different parents stays
distinguishable.  Every span feeds:

- the PyTorch profiler's host annotations (``torch.profiler.
  record_function``) while a profiler is recording, so spans land in its
  trace beside the CUDA kernels (the JAX span feeds its profiler's
  ``RecordEvent`` the same way);
- an aggregated **span tree** (path -> count / total ms / self ms, where
  self excludes child spans): :func:`span_tree_totals`;
- a bounded in-memory buffer of completed spans, as chrome trace events
  (:func:`trace_events`; the flight recorder dumps them).

All are process-wide and thread-safe; the buffer is bounded
(``PTPU_TRACE_BUFFER`` spans, default 65536).  Span times are host wall
times: a span around a CUDA launch measures the launch, and one around a
readback absorbs the card's work before it.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict

__all__ = ["span", "span_tree_totals", "trace_events"]

TRACE_BUFFER_ENV = "PTPU_TRACE_BUFFER"

_tls = threading.local()
_lock = threading.Lock()
# path -> [count, total_s, self_s]
_tree: Dict[str, list] = {}
_buffer: deque = deque(
    maxlen=int(os.environ.get(TRACE_BUFFER_ENV, "65536")))


def _profiler_recording() -> bool:
    import torch
    return torch.autograd._profiler_enabled()


class span:
    """Nesting context manager timing one region of host code.

    >>> with span("step"):
    ...     with span("dispatch"):
    ...         ...        # recorded as "step/dispatch"

    ``elapsed`` (seconds) is available after exit: callers that need the
    number (hapi's step breakdown) read it instead of timing again.
    """

    __slots__ = ("name", "path", "elapsed", "_t0", "_wall0", "_child",
                 "_event")

    def __init__(self, name: str):
        self.name = str(name)
        self.path = self.name
        self.elapsed = 0.0
        self._child = 0.0
        self._event = None

    def __enter__(self) -> "span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if stack:
            self.path = stack[-1].path + "/" + self.name
        stack.append(self)
        if _profiler_recording():
            import torch
            self._event = torch.profiler.record_function(self.path)
            self._event.__enter__()
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._event is not None:
            self._event.__exit__(None, None, None)
            self._event = None
        self.elapsed = dt
        stack = _tls.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        self_s = max(0.0, dt - self._child)
        tid = threading.get_ident()
        with _lock:
            row = _tree.get(self.path)
            if row is None:
                _tree[self.path] = [1, dt, self_s]
            else:
                row[0] += 1
                row[1] += dt
                row[2] += self_s
            _buffer.append((self.path, self._wall0, dt, tid))


def span_tree_totals(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Aggregated span stats: path -> {count, total_ms, self_ms} (self
    excludes time spent inside child spans)."""
    with _lock:
        out = {path: {"count": row[0], "total_ms": row[1] * 1e3,
                      "self_ms": row[2] * 1e3}
               for path, row in sorted(_tree.items())}
        if reset:
            _tree.clear()
    return out


def trace_events() -> list:
    """The buffered completed spans as chrome trace events (us units)."""
    with _lock:
        items = list(_buffer)
    pid = os.getpid()
    return [{"name": path, "ph": "X", "ts": wall0 * 1e6, "dur": dur * 1e6,
             "pid": pid, "tid": tid}
            for path, wall0, dur, tid in items]
