"""Crash flight recorder: the port's own copy of ``paddle_tpu/
observability/flight.py``.

The JSONL telemetry stream is buffered and lossy by contract: a hard death
(SIGKILL after a watchdog verdict, an allocator OOM, a fault inside a
kernel) loses the in-memory tail of the timeline, which is the part a
post-mortem needs.  The :class:`FlightRecorder` is the black box for that
case: a bounded in-memory ring of the last N event records (attached to
the metrics registry as one more sink, so it sees the same timeline every
other sink sees) plus the most recent span closures, dumped durably to
``<run_dir>/flight/worker-<i>.json`` on any abnormal exit:

- the supervisor's fault path (``RunSupervisor.end_run(status !=
  "completed")``, a ``fit()`` that raised);
- SIGTERM / SIGINT (chained onto whatever handler was installed, e.g. the
  elastic checkpointer's preemption flush);
- ``atexit``, as the backstop for a run that never reached ``end_run``.

The ring is ``PTPU_FLIGHT_BUFFER`` records deep (default 512).  The
worker id defaults to the ``torch.distributed`` rank (0 without a group).
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..framework.log import vlog
from ..utils import fsio

__all__ = ["FLIGHT_BUFFER_ENV", "FlightRecorder", "default_capacity",
           "flight_dir", "read_flight_bundles"]

FLIGHT_BUFFER_ENV = "PTPU_FLIGHT_BUFFER"
_FLIGHT_RE_PREFIX = "worker-"
_FLIGHT_SUFFIX = ".json"


def default_capacity() -> int:
    return max(16, int(os.environ.get(FLIGHT_BUFFER_ENV, "512")))


def flight_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "flight")


class FlightRecorder:
    """Bounded ring of the most recent telemetry records, dumped on
    abnormal exit.

    Attach it as a registry sink (``get_registry().add_sink(fr)``) so it
    rides the same event fan-out as the JSONL writer; :meth:`install`
    arms the signal/atexit dump paths, :meth:`dump` is the explicit one
    (the supervisor's fault path calls it directly).  ``write`` is a
    deque append — cheap enough to sit on the hot path unconditionally.
    """

    def __init__(self, run_dir: str, worker_id: Optional[int] = None,
                 capacity: Optional[int] = None):
        if worker_id is None:
            from ..distributed import get_rank
            worker_id = get_rank()
        self.run_dir = run_dir
        self.worker_id = int(worker_id)
        self.capacity = (default_capacity() if capacity is None
                         else max(1, int(capacity)))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.seen = 0
        self.dumps = 0
        self._installed = False
        self._prev_handlers: Dict[int, Any] = {}
        self._atexit_armed = False

    @property
    def path(self) -> str:
        return os.path.join(flight_dir(self.run_dir),
                            f"{_FLIGHT_RE_PREFIX}{self.worker_id}"
                            f"{_FLIGHT_SUFFIX}")

    # -- sink protocol -----------------------------------------------------
    def write(self, record: Dict[str, Any]) -> None:
        # locked so a dump racing a concurrent emit (the exact moment a
        # crash dump happens) never hits "deque mutated during iteration"
        with self._lock:
            self._ring.append(record)
            self.seen += 1

    def flush(self) -> None:
        pass  # nothing durable until a dump is warranted

    def close(self) -> None:
        pass  # detach is not abnormal exit; the ring stays dumpable

    # -- the dump ----------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Durably write the ring (+ recent span closures) as
        ``<run_dir>/flight/worker-<i>.json``; returns the path, or None
        when the write failed (a dying process must not die harder
        because its black box had an I/O error)."""
        records = self.snapshot()
        try:
            from .tracing import trace_events
            spans = trace_events()[-self.capacity:]
        except Exception:  # noqa: swallow
            spans = []  # tracing state is a bonus, never a dependency
        payload = {
            "worker": self.worker_id,
            "pid": os.getpid(),
            "reason": str(reason),
            "ts": time.time(),
            "capacity": self.capacity,
            "records_seen": self.seen,
            "records": records,
            "spans": spans,
        }
        try:
            os.makedirs(flight_dir(self.run_dir), exist_ok=True)
            fsio.atomic_write_bytes(
                self.path,
                json.dumps(payload, default=str).encode("utf-8"))
        except OSError as e:
            vlog(0, "flight: dump to %s failed: %s", self.path, e)
            return None
        self.dumps += 1
        vlog(0, "flight: dumped %d records (%s) -> %s", len(records),
             reason, self.path)
        return self.path

    # -- abnormal-exit arming ----------------------------------------------
    def install(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        """Arm the dump on ``signals`` (chaining any existing handler —
        the elastic checkpointer's SIGTERM flush keeps working) and on
        interpreter exit.  Signal handlers can only be set from the main
        thread; elsewhere only the atexit backstop is armed."""
        if self._installed:
            return
        self._installed = True
        for sig in signals:
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._make_handler(sig))
            except ValueError:  # not the main thread
                vlog(1, "flight: cannot install handler for signal %s "
                     "off the main thread", sig)
        if not self._atexit_armed:
            self._atexit_armed = True
            atexit.register(self._atexit_dump)

    def uninstall(self) -> None:
        """Restore chained signal handlers and disarm the atexit dump
        (a run that ended cleanly leaves no bundle)."""
        if not self._installed:
            return
        self._installed = False
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # noqa: swallow
                pass  # off-main-thread teardown: leave the chain in place
        self._prev_handlers.clear()
        if self._atexit_armed:
            self._atexit_armed = False
            atexit.unregister(self._atexit_dump)

    def _make_handler(self, sig):
        def handler(signum, frame):
            self.dump(reason=f"signal-{signum}")
            prev = self._prev_handlers.get(sig)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
        return handler

    def _atexit_dump(self) -> None:
        # only an ABNORMAL exit dumps: a clean end_run uninstalls first
        if self._installed:
            self.dump(reason="atexit")


def read_flight_bundles(run_dir: str) -> Dict[int, Dict[str, Any]]:
    """{worker_id: bundle} for every readable
    ``<run_dir>/flight/worker-<i>.json`` (garbled bundles are skipped —
    a half-written black box reads as no black box)."""
    fdir = flight_dir(run_dir)
    bundles: Dict[int, Dict[str, Any]] = {}
    if not os.path.isdir(fdir):
        return bundles
    for name in sorted(os.listdir(fdir)):
        if not (name.startswith(_FLIGHT_RE_PREFIX)
                and name.endswith(_FLIGHT_SUFFIX)):
            continue
        try:
            payload = json.loads(
                fsio.read_bytes(os.path.join(fdir, name)))
            bundles[int(payload["worker"])] = payload
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return bundles
