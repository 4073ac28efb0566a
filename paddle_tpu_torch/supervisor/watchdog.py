"""Step watchdog: the port's own copy of ``paddle_tpu/supervisor/
watchdog.py``, a deadline armed around each serving step.

A hung step does not crash — it sits idle forever while the card's bill
runs.  The watchdog turns "forever" into a bounded event: a monitor thread
tracks every armed section, and when a deadline expires it (1) dumps the
stacks of every live thread through ``vlog`` and (2) raises
:class:`StepTimeout` inside the armed thread (``PyThreadState_SetAsyncExc``
through ``ctypes``) so the loop regains control.

The async raise lands at the next Python bytecode boundary.  It interrupts
host-side loops, sleeps taken in slices and retry backoff, which covers
every hang the fault harness injects (``testing.faults.hang``).  A thread
blocked inside native code sees it only when that call returns: a
device-to-host copy waiting behind a wedged CUDA kernel raises only after
the copy completes, so a kernel that never finishes is not recoverable
from here; the stack dump still fires, which is what a supervising
launcher needs to kill and reschedule the process.

Env knob: ``PTPU_WATCHDOG_SECS`` (default 300) seeds the default
deadline; each ``armed()`` call may override it.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
import time
import traceback
from typing import List, Optional

from ..framework.log import vlog

__all__ = ["StepTimeout", "Watchdog", "install_global", "global_watchdog",
           "guarded", "dump_all_stacks"]

DEFAULT_TIMEOUT_ENV = "PTPU_WATCHDOG_SECS"


class StepTimeout(RuntimeError):
    """An armed section outlived its watchdog deadline."""


def default_timeout() -> float:
    return float(os.environ.get(DEFAULT_TIMEOUT_ENV, "300"))


def _async_raise(thread_id: int, exc_type) -> bool:
    """Raise ``exc_type`` asynchronously in the thread with ``thread_id``;
    True when the interpreter accepted exactly one target."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(exc_type))
    if res > 1:  # "we broke more than one thread" — undo, never deliver
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


def dump_all_stacks(limit: int = 16, first: Optional[int] = None) -> str:
    """Stack of every live thread, hung ones included (the forensic core
    of the timeout path).  ``first`` puts that thread id at the top —
    the report clips long dumps, and in a thread-heavy process (serving
    callbacks, io workers, peer watchdogs) the hung thread's stack must
    survive the clip."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sys._current_frames().items():
        header = f"--- thread {names.get(tid, '?')} ({tid}) ---"
        chunk = (header + "\n"
                 + "".join(traceback.format_stack(frame, limit=limit)))
        if tid == first:
            chunks.insert(0, chunk)
        else:
            chunks.append(chunk)
    return "\n".join(chunks)


class _Armed:
    __slots__ = ("label", "timeout", "deadline", "thread_id", "expired",
                 "delivered")

    def __init__(self, label: str, timeout: float, deadline: float,
                 thread_id: int):
        self.label = label
        self.timeout = timeout
        self.deadline = deadline
        self.thread_id = thread_id
        self.expired = False
        self.delivered = False


class Watchdog:
    """Deadline monitor for blocking sections.

    >>> wd = Watchdog(timeout=30.0)
    >>> with wd.armed("serve_step"):
    ...     engine_step()                 # StepTimeout if it stalls

    One daemon monitor thread serves all armed sections (several threads
    may arm at once).
    """

    def __init__(self, timeout: Optional[float] = None):
        self.timeout = default_timeout() if timeout is None else float(timeout)
        self._clock = time.monotonic
        self._cond = threading.Condition()
        self._entries: List[_Armed] = []
        self._monitor: Optional[threading.Thread] = None
        self._closed = False
        self.timeouts = 0

    # -- arming ------------------------------------------------------------
    @contextlib.contextmanager
    def armed(self, label: str = "step", timeout: Optional[float] = None):
        t = self.timeout if timeout is None else float(timeout)
        entry = _Armed(label, t, self._clock() + t, threading.get_ident())
        with self._cond:
            if self._closed:
                raise RuntimeError("watchdog is closed")
            self._entries.append(entry)
            self._ensure_monitor()
            self._cond.notify_all()
        try:
            yield entry
        finally:
            with self._cond:
                if entry in self._entries:
                    self._entries.remove(entry)
                self._cond.notify_all()
                # backstop: deadline passed but the async exception was
                # not (or could not be) delivered — surface it here so an
                # expiry is never silent
                if entry.expired and not entry.delivered:
                    entry.delivered = True
                    raise StepTimeout(
                        f"{entry.label!r} exceeded the {t:.3g}s watchdog "
                        "deadline")

    # -- monitor -----------------------------------------------------------
    def _ensure_monitor(self) -> None:
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor = threading.Thread(
                target=self._run, name="ptpu-watchdog", daemon=True)
            self._monitor.start()

    def _run(self) -> None:
        with self._cond:
            while not self._closed:
                live = [e for e in self._entries if not e.expired]
                if not live:
                    self._cond.wait()
                    continue
                now = self._clock()
                nxt = min(e.deadline for e in live)
                if nxt > now:
                    self._cond.wait(timeout=min(nxt - now, 1.0))
                    continue
                for entry in [e for e in live if e.deadline <= now]:
                    self._fire(entry)

    def _fire(self, entry: _Armed) -> None:
        """Called with the condition held: expire one armed section."""
        entry.expired = True
        self.timeouts += 1
        stacks = dump_all_stacks(first=entry.thread_id)
        vlog(0, "watchdog: %r missed its deadline — thread stacks:\n%s",
             entry.label, stacks)
        entry.delivered = _async_raise(entry.thread_id, StepTimeout)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# -- process-global watchdog (guarded() arms through it) -------------------
_GLOBAL: Optional[Watchdog] = None
_GLOBAL_LOCK = threading.Lock()


def install_global(watchdog: Optional[Watchdog]) -> Optional[Watchdog]:
    """Register ``watchdog`` as the process-wide one (None uninstalls);
    returns the previous registration so callers can restore it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, watchdog
    return prev


def global_watchdog() -> Optional[Watchdog]:
    return _GLOBAL


def guarded(label: str, timeout: Optional[float] = None):
    """Arm the global watchdog (if any) around a blocking call site —
    a no-op context manager when no supervisor is active."""
    wd = global_watchdog()
    if wd is None:
        return contextlib.nullcontext()
    return wd.armed(label, timeout=timeout)
