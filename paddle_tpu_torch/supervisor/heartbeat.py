"""Per-worker heartbeats + staleness classification: the port's own copy
of ``paddle_tpu/supervisor/heartbeat.py``.

On an elastic pod, a worker that dies between checkpoints is invisible
to the storage layer — its last heartbeat is the only evidence.  Every
worker runs a :class:`HeartbeatWriter` that periodically writes a small
JSON beat file through the fsync'd ``utils/fsio`` seam (so the fault
harness can tear/fail heartbeat writes like any other durable write)
under ``<run_dir>/heartbeats/``; any process — the rank-0 supervisor,
the launcher, an external babysitter — runs a :class:`HeartbeatMonitor`
over the same directory and classifies the run:

    HEALTHY      every expected worker beat within ``stale_after``
    DEGRADED     someone is late (stale_after < age <= lost_after)
    LOST_WORKER  someone is gone (age > lost_after, or never appeared)

A launcher can poll this to act on membership loss (the JAX package's
``distributed/launch`` does; the port has no launcher yet), and the
run supervisor records every state transition in the post-mortem report.
The worker id defaults to the ``torch.distributed`` rank (0 without a
process group).

Env knob: ``PTPU_HEARTBEAT_SECS`` (default 10) seeds the beat interval;
staleness defaults to 3 intervals, loss to 3× staleness.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..framework.log import vlog
from ..utils import fsio

__all__ = ["RunState", "HeartbeatWriter", "HeartbeatMonitor",
           "heartbeat_dir"]

DEFAULT_INTERVAL_ENV = "PTPU_HEARTBEAT_SECS"
_BEAT_PREFIX = "worker-"
_BEAT_SUFFIX = ".hb.json"


class RunState:
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    LOST_WORKER = "lost-worker"


def default_interval() -> float:
    return float(os.environ.get(DEFAULT_INTERVAL_ENV, "10"))


def heartbeat_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "heartbeats")


def _beat_path(run_dir: str, worker_id: int) -> str:
    return os.path.join(heartbeat_dir(run_dir),
                        f"{_BEAT_PREFIX}{int(worker_id)}{_BEAT_SUFFIX}")


class HeartbeatWriter:
    """Writes this worker's beat file; ``start()`` spawns a daemon thread
    beating every ``interval`` seconds, and the training loop may call
    ``beat(step=...)`` directly after each step for a fresher signal."""

    def __init__(self, run_dir: str, worker_id: Optional[int] = None,
                 interval: Optional[float] = None, clock=time.time):
        from ..distributed import get_rank
        self.run_dir = run_dir
        # the torch.distributed rank (0 without a process group), where the
        # JAX package reads jax.process_index()
        self.worker_id = get_rank() if worker_id is None else int(worker_id)
        self.interval = (default_interval() if interval is None
                         else float(interval))
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # beat() runs on both the daemon thread and the training loop
        # (maybe_beat); the beat state is shared and lock-guarded
        self._lock = threading.Lock()
        self.beats = 0                          # guarded_by: _lock
        self._last_step: Optional[int] = None   # guarded_by: _lock
        self._last_beat = 0.0                   # guarded_by: _lock
        #: world generation stamped into every beat when set (elastic
        #: fleets: lets any reader spot a zombie from an older world)
        self.generation: Optional[int] = None

    @property
    def path(self) -> str:
        return _beat_path(self.run_dir, self.worker_id)

    def beat(self, step: Optional[int] = None) -> None:
        # held across the write too: a concurrent loop-beat and
        # thread-beat must not interleave payload vs counter bumps
        with self._lock:
            if step is not None:
                self._last_step = int(step)
            payload = {"worker": self.worker_id, "pid": os.getpid(),
                       "time": float(self._clock()),
                       "step": self._last_step,
                       "beats": self.beats}
            if self.generation is not None:
                payload["generation"] = int(self.generation)
            os.makedirs(heartbeat_dir(self.run_dir), exist_ok=True)
            try:
                fsio.atomic_write_bytes(
                    self.path, json.dumps(payload).encode("utf-8"))
                self.beats += 1
                self._last_beat = payload["time"]
            except OSError as e:
                # a failed beat must not kill the worker it describes; the
                # monitor sees staleness, which is the correct signal anyway
                vlog(0, "heartbeat: write to %s failed: %s", self.path, e)

    def maybe_beat(self, step: Optional[int] = None) -> bool:
        """Beat only when half an interval has passed — the training loop
        can call this every step without fsync'ing every step."""
        with self._lock:
            if step is not None:
                self._last_step = int(step)  # freshest step even when skipping
            if float(self._clock()) - self._last_beat < self.interval / 2.0:
                return False
        self.beat(step)
        return True

    def start(self) -> "HeartbeatWriter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ptpu-heartbeat", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        self.beat()
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class HeartbeatMonitor:
    """Classifies run health from the beat files under ``run_dir``.

    ``expected``: worker count the run was launched with (``None`` means
    "whoever has ever beaten") — a worker that never wrote a beat within
    ``lost_after`` of monitor construction counts as lost.  An elastic
    fleet passes a *set of member ids* instead and updates it
    on every resize (``set_expected``): beats from retired workers'
    stale files stop counting against the run's health.
    """

    def __init__(self, run_dir: str, stale_after: Optional[float] = None,
                 lost_after: Optional[float] = None,
                 expected=None, clock=time.time,
                 report=None):
        self.run_dir = run_dir
        base = default_interval()
        self.stale_after = (3.0 * base if stale_after is None
                            else float(stale_after))
        self.lost_after = (3.0 * self.stale_after if lost_after is None
                           else float(lost_after))
        self.expected = expected
        self._clock = clock
        self.report = report
        self._born = float(clock())
        self._last_state: Optional[str] = None

    def _read_beats(self) -> Dict[int, Dict[str, Any]]:
        hb_dir = heartbeat_dir(self.run_dir)
        beats: Dict[int, Dict[str, Any]] = {}
        if not os.path.isdir(hb_dir):
            return beats
        for name in os.listdir(hb_dir):
            if not (name.startswith(_BEAT_PREFIX)
                    and name.endswith(_BEAT_SUFFIX)):
                continue
            try:
                payload = json.loads(
                    fsio.read_bytes(os.path.join(hb_dir, name)))
                beats[int(payload["worker"])] = payload
            except (OSError, ValueError, KeyError):
                continue  # torn/garbled beat reads as "no beat" → stale
        return beats

    def set_expected(self, expected) -> None:
        """Adopt a new membership (count or id set) — the elastic
        reconciler calls this on every resize."""
        self.expected = expected

    def _expected_ids(self):
        if self.expected is None:
            return None
        if isinstance(self.expected, int):
            return set(range(self.expected))
        return {int(w) for w in self.expected}

    def poll(self) -> Dict[str, Any]:
        """One classification pass → ``{"state", "workers", "stale",
        "lost", "missing"}``; records a ``run_state`` event on every
        transition."""
        now = float(self._clock())
        beats = self._read_beats()
        expected_ids = self._expected_ids()
        if expected_ids is not None:
            # a retired member's beat file outlives it; only current
            # members can make the run stale/lost
            beats = {w: p for w, p in beats.items() if w in expected_ids}
        stale, lost = [], []
        for wid, payload in beats.items():
            age = now - float(payload.get("time", 0.0))
            if age > self.lost_after:
                lost.append(wid)
            elif age > self.stale_after:
                stale.append(wid)
        missing = []
        if expected_ids is not None:
            unseen = expected_ids - set(beats)
            # an expected worker that has NEVER beaten is only lost once
            # the monitor has waited long enough for a first beat
            if now - self._born > self.lost_after:
                missing = sorted(unseen)
            elif now - self._born > self.stale_after:
                stale.extend(sorted(unseen))
        if lost or missing:
            state = RunState.LOST_WORKER
        elif stale:
            state = RunState.DEGRADED
        else:
            state = RunState.HEALTHY
        detail = {"state": state, "workers": sorted(beats),
                  "stale": sorted(stale), "lost": sorted(lost),
                  "missing": missing}
        if state != self._last_state:
            vlog(0 if state != RunState.HEALTHY else 1,
                 "heartbeat: run state %s → %s (stale=%s lost=%s "
                 "missing=%s)", self._last_state, state, stale, lost,
                 missing)
            if self.report is not None:
                self.report.record("run_state", **detail)
            self._last_state = state
        return detail
