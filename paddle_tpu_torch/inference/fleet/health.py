"""Flap-resistant fleet health control: the port's own copy of
``paddle_tpu/inference/fleet/health.py``.

A census that is only healthy or dead lets one *flapping* replica
(intermittent ConnectionErrors from a half-wedged worker) bounce in and
out of the dispatch set, and every bounce costs a failover plus a retry
storm against a fleet that is already degraded.  Two primitives stop
that:

- :class:`CircuitBreaker` — per-replica failure-rate hysteresis:

      closed ──N failures in window──▶ open
        ▲  ▲                            │ backoff elapses
        │  └───── probe succeeds ── half-open
        │                                │ probe fails
        └────────────────────────────────┴──▶ open (backoff doubles)

  A replica whose breaker is open is *flapping*: excluded from
  dispatch candidates (and surfaced as a ``flapping`` census state)
  without being declared dead — its in-flight streams keep polling,
  and one half-open probe per backoff window checks for recovery.
  Consecutive trips double the backoff (hysteresis), so a replica
  that recovers only to flap again is probed ever less eagerly.

- :class:`RetryBudget` — a process-wide token bucket
  (``PTPU_FLEET_RETRY_BUDGET`` capacity, ``PTPU_FLEET_RETRY_REFILL_PER_S``
  refill): every dispatch retry and failover re-dispatch costs one
  token; the first attempt of a fresh submission is free.  When the
  bucket is dry, new submissions degrade to load-shed
  (:class:`..router.FleetOverloaded`) and failovers defer to the next
  pump instead of hammering the fleet — retries can never outnumber
  capacity + refill·time, which is what "no retry storm" means.

Both take an injectable clock so drills run on fake time.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Optional

__all__ = ["BREAKER_FAILURES_ENV", "BREAKER_WINDOW_SECS_ENV",
           "BREAKER_BACKOFF_SECS_ENV", "RETRY_BUDGET_ENV",
           "RETRY_REFILL_ENV", "default_breaker_failures",
           "default_breaker_window_secs", "default_breaker_backoff_secs",
           "default_retry_budget", "default_retry_refill_per_s",
           "CircuitBreaker", "RetryBudget", "get_retry_budget",
           "reset_retry_budget"]

BREAKER_FAILURES_ENV = "PTPU_FLEET_BREAKER_FAILURES"
BREAKER_WINDOW_SECS_ENV = "PTPU_FLEET_BREAKER_WINDOW_SECS"
BREAKER_BACKOFF_SECS_ENV = "PTPU_FLEET_BREAKER_BACKOFF_SECS"
RETRY_BUDGET_ENV = "PTPU_FLEET_RETRY_BUDGET"
RETRY_REFILL_ENV = "PTPU_FLEET_RETRY_REFILL_PER_S"

_BACKOFF_CAP_MULT = 16               # consecutive-trip backoff ceiling


def default_breaker_failures() -> int:
    return int(os.environ.get(BREAKER_FAILURES_ENV, "5"))


def default_breaker_window_secs() -> float:
    return float(os.environ.get(BREAKER_WINDOW_SECS_ENV, "10"))


def default_breaker_backoff_secs() -> float:
    return float(os.environ.get(BREAKER_BACKOFF_SECS_ENV, "2"))


def default_retry_budget() -> int:
    return int(os.environ.get(RETRY_BUDGET_ENV, "64"))


def default_retry_refill_per_s() -> float:
    return float(os.environ.get(RETRY_REFILL_ENV, "8"))


class CircuitBreaker:
    """Failure-rate hysteresis for one replica.

    ``record_failure()`` / ``record_success()`` feed it transport
    outcomes; ``allow()`` answers "may I send this replica new work?"
    — and performs the open → half-open transition when the backoff
    has elapsed (granting exactly ONE probe per window).

    ``on_transition(prev, new, breaker)`` — when given — fires on every
    state change; the router uses it to emit ``fleet.breaker`` timeline
    records and flip the ``flapping`` census state.
    """

    def __init__(self, failures: Optional[int] = None,
                 window_secs: Optional[float] = None,
                 backoff_secs: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        self.failures = int(failures if failures is not None
                            else default_breaker_failures())
        self.window_secs = float(window_secs if window_secs is not None
                                 else default_breaker_window_secs())
        self.backoff_secs = float(backoff_secs if backoff_secs is not None
                                  else default_breaker_backoff_secs())
        self.clock = clock
        self.on_transition = on_transition
        self.state = "closed"            # closed | open | half_open
        self.trips = 0                   # lifetime open transitions
        self._consecutive_trips = 0      # resets on a closed recovery
        self._recent: Deque[float] = deque()
        self._opened_at: Optional[float] = None
        self._probe_out = False

    def _transition(self, new: str) -> None:
        prev, self.state = self.state, new
        if prev != new and self.on_transition is not None:
            self.on_transition(prev, new, self)

    def _prune(self, now: float) -> None:
        while self._recent and now - self._recent[0] > self.window_secs:
            self._recent.popleft()

    def current_backoff(self) -> float:
        mult = min(_BACKOFF_CAP_MULT,
                   2 ** max(0, self._consecutive_trips - 1))
        return self.backoff_secs * mult

    # -- outcomes ----------------------------------------------------------
    def record_failure(self) -> None:
        now = float(self.clock())
        if self.state == "half_open":
            # the probe failed: reopen, and back off harder
            self._probe_out = False
            self._consecutive_trips += 1
            self.trips += 1
            self._opened_at = now
            self._recent.clear()
            self._transition("open")
            return
        self._recent.append(now)
        self._prune(now)
        if self.state == "closed" and len(self._recent) >= self.failures:
            self._consecutive_trips += 1
            self.trips += 1
            self._opened_at = now
            self._recent.clear()
            self._transition("open")

    def record_success(self) -> None:
        if self.state == "half_open":
            self._probe_out = False
            self._consecutive_trips = 0
            self._recent.clear()
            self._transition("closed")
        elif self.state == "closed":
            # healthy traffic ages failures out via the window; nothing
            # else to do — hysteresis lives in the trip/backoff path
            self._prune(float(self.clock()))

    # -- gating ------------------------------------------------------------
    def allow(self) -> bool:
        """True when this replica may receive new work right now.  In
        ``open``, flips to ``half_open`` once the backoff elapses and
        grants a single probe; further calls say no until the probe
        resolves."""
        if self.state == "closed":
            return True
        now = float(self.clock())
        if self.state == "open":
            opened = now if self._opened_at is None else self._opened_at
            if now - opened >= self.current_backoff():
                self._probe_out = True
                self._transition("half_open")
                return True
            return False
        # half_open: one probe at a time
        if not self._probe_out:
            self._probe_out = True
            return True
        return False

    def snapshot(self) -> dict:
        return {"state": self.state, "trips": self.trips,
                "recent_failures": len(self._recent),
                "backoff_secs": self.current_backoff()}


class RetryBudget:
    """Process-wide retry token bucket.

    ``try_acquire()`` refills by ``refill_per_s`` × elapsed (capped at
    ``capacity``) and spends one token when available.  ``spent`` /
    ``denied`` make "total retries bounded by the budget" directly
    assertable in drills.
    """

    def __init__(self, capacity: Optional[int] = None,
                 refill_per_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity if capacity is not None
                              else default_retry_budget())
        self.refill_per_s = float(
            refill_per_s if refill_per_s is not None
            else default_retry_refill_per_s())
        self.clock = clock
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._last = float(clock())
        self.spent = 0
        self.denied = 0

    def _refill(self, now: float) -> None:
        self._tokens = min(self.capacity, self._tokens
                           + (now - self._last) * self.refill_per_s)
        self._last = now

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            self._refill(float(self.clock()))
            if self._tokens >= n:
                self._tokens -= n
                self.spent += n
                return True
            self.denied += n
            return False

    def available(self) -> float:
        with self._lock:
            self._refill(float(self.clock()))
            return self._tokens

    def snapshot(self) -> dict:
        return {"capacity": self.capacity, "available": self.available(),
                "refill_per_s": self.refill_per_s, "spent": self.spent,
                "denied": self.denied}


_budget_lock = threading.Lock()
_global_budget: Optional[RetryBudget] = None


def get_retry_budget() -> RetryBudget:
    """The process-wide bucket every router shares by default — retry
    pressure is a *fleet* property, not a per-router one."""
    global _global_budget
    with _budget_lock:
        if _global_budget is None:
            _global_budget = RetryBudget()
        return _global_budget


def reset_retry_budget() -> None:
    """Drop the process-wide bucket (tests)."""
    global _global_budget
    with _budget_lock:
        _global_budget = None
