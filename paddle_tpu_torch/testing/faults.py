"""Serving fault injectors: the port's own copy of the serving half of
``paddle_tpu/testing/faults.py``.

- :func:`hang` / :func:`slow_call` — an interruptible stall (a hung or a
  slow-but-alive step) for the watchdog drills;
- :class:`poison_request` — plugs into ``ServingEngine(step_fault=...)``
  and poisons one request's step (raise / NaN logits / hang), so the
  quarantine, NaN-guard and watchdog paths are drillable without real
  hardware faults;
- :class:`expire_clock` — a hand-advanced clock for deadline drills.

and the fleet half:

- :class:`kill_replica` — SIGKILL one fleet worker subprocess, optionally
  gated on a ``when()`` predicate the drill polls, so "kill replica 0
  once stream X has 3 accepted tokens" is deterministic;
- :class:`drop_dispatch` — plugs into ``Router.dispatch_fault`` and fails
  the first N dispatch attempts with ``ConnectionError``, driving the
  retry-with-backoff and exhaustion paths without a real network;
- :class:`flaky_replica` — a *live* replica's transport fails / stalls
  intermittently (seeded): alive and healthy by census, yet a fraction
  of its calls raise ``ConnectionError`` — the circuit-breaker and
  retry-budget drill.

The injectors are the JAX package's, so one drill script drives either
engine or fleet the same way.  (The JAX module's ``fast_retries`` swaps
checkpoint and ``framework.io`` retry policies the port does not have
yet.)
"""
from __future__ import annotations

import functools
import os
import random
import signal as _signal
import time
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["hang", "slow_call", "poison_request", "expire_clock",
           "kill_replica", "drop_dispatch", "flaky_replica"]


def hang(seconds: float, interval: float = 0.01) -> None:
    """Block for ``seconds`` in short interruptible slices — a simulated
    hung step.  Unlike one long ``time.sleep`` this yields a bytecode
    boundary every ``interval``, so the watchdog's async ``StepTimeout``
    lands promptly instead of after the full hang."""
    deadline = time.monotonic() + float(seconds)
    while time.monotonic() < deadline:
        time.sleep(interval)


def slow_call(fn: Callable, seconds: float) -> Callable:
    """Wrap ``fn`` to stall (interruptibly) for ``seconds`` before every
    call — slow-but-alive, the case a watchdog must NOT fire on when the
    deadline is generous enough (and a slow ``on_token`` consumer, which
    delays only its own stream)."""
    @functools.wraps(fn)
    def slowed(*args, **kwargs):
        hang(seconds)
        return fn(*args, **kwargs)
    return slowed


class poison_request:
    """Step-fault injector for the ServingEngine quarantine drill: plug
    into ``ServingEngine(step_fault=...)``; the engine calls it as
    ``fault(engine, kind, request_ids, logits)`` on every executed step —
    bisection probes included — with the step's logits on the host.

    ``target`` is a request id (str) or a submit-order index (int,
    resolved lazily against ``engine._submit_order``).  Modes:

    - ``"raise"`` — raise a RuntimeError whenever the target is in the
      batch (re-fires on every probe subset containing the target, which
      is what lets the engine's bisection converge on it);
    - ``"nan"`` — overwrite the target's logits row with NaN (the
      silent-corruption shape the NaN guard must catch);
    - ``"hang"`` — stall interruptibly for ``seconds`` (watchdog drill);
      fires at most ``count`` times (default 1) since the target stays in
      the batch after hang recovery.

    ``kinds`` restricts the injector to ``"prefill"`` and / or
    ``"decode"`` steps.  ``fired`` counts activations."""

    def __init__(self, target, mode: str = "raise",
                 seconds: float = 1.0, count: Optional[int] = None,
                 kinds: Tuple[str, ...] = ("prefill", "decode")):
        if mode not in ("raise", "nan", "hang"):
            raise ValueError(f"unknown poison mode {mode!r}")
        self.target = target
        self.mode = mode
        self.seconds = float(seconds)
        self.count = (1 if mode == "hang" else None) \
            if count is None else int(count)
        self.kinds = tuple(kinds)
        self.fired = 0

    def _target_id(self, engine) -> Optional[str]:
        if isinstance(self.target, str):
            return self.target
        order = engine._submit_order
        idx = int(self.target)
        return order[idx] if 0 <= idx < len(order) else None

    def __call__(self, engine, kind: str, request_ids, logits):
        if kind not in self.kinds:
            return None
        rid = self._target_id(engine)
        if rid is None or rid not in request_ids:
            return None
        if self.count is not None and self.fired >= self.count:
            return None
        self.fired += 1
        if self.mode == "raise":
            raise RuntimeError(f"injected poisoned step ({rid})")
        if self.mode == "hang":
            hang(self.seconds)
            return None
        out = np.array(logits, copy=True)
        out[request_ids.index(rid)] = np.nan
        return out


class expire_clock:
    """Controllable clock for deadline drills: pass as
    ``ServingEngine(clock=...)``, then ``advance(secs)`` to expire
    deadlines without real waiting.  Starts at ``start`` (default 1000.0
    — any fixed epoch; deadline math is all relative)."""

    def __init__(self, start: float = 1000.0):
        self.now = float(start)

    def advance(self, seconds: float) -> float:
        self.now += float(seconds)
        return self.now

    def __call__(self) -> float:
        return self.now


# ---------------------------------------------------------------------------
# fleet injectors
# ---------------------------------------------------------------------------
class kill_replica:
    """SIGKILL one fleet worker subprocess, deterministically.

    ``target`` is anything with a live process: a ``ReplicaManager``
    plus ``index``, an ``HttpReplica`` (its ``.process``), a
    ``subprocess.Popen``, or a bare pid.  With ``when`` (a no-arg
    predicate) the drill polls ``maybe()`` in its pump loop and the
    kill fires exactly once, the first time the predicate holds —
    e.g. ``when=lambda: len(journal.tokens) >= 3`` pins "die
    mid-stream after 3 accepted tokens".  Calling the injector
    directly fires unconditionally.

    >>> k = kill_replica(manager, index=0,
    ...                  when=lambda: len(j.tokens) >= 3)
    >>> while router.pump() > 0:
    ...     k.maybe()
    >>> k.fired
    1
    """

    def __init__(self, target, index: Optional[int] = None,
                 sig: int = _signal.SIGKILL,
                 when: Optional[Callable[[], bool]] = None):
        self.target = target
        self.index = index
        self.sig = sig
        self.when = when
        self.fired = 0

    def _pid(self) -> int:
        t = self.target
        if isinstance(t, int):
            return t
        if self.index is not None and hasattr(t, "replicas"):
            t = t.replicas[self.index]          # ReplicaManager slot
        proc = getattr(t, "process", t)          # HttpReplica -> Popen
        return int(proc.pid)

    def __call__(self) -> int:
        """Fire now; returns the killed pid."""
        pid = self._pid()
        os.kill(pid, self.sig)
        t = self.target
        if self.index is not None and hasattr(t, "replicas"):
            t.replicas[self.index].process.wait(timeout=10)
            t.poll_states()
        self.fired += 1
        return pid

    def maybe(self) -> bool:
        """Fire once when ``when()`` first holds; True if it fired."""
        if self.fired or (self.when is not None and not self.when()):
            return False
        self()
        return True


class drop_dispatch:
    """Router-visible network fault: assigned to
    ``Router.dispatch_fault``, it raises ``ConnectionError`` for the
    first ``count`` dispatch attempts (optionally only toward
    ``replica_id``), then passes everything — the deterministic way to
    drill retry-with-backoff and ``DispatchExhausted``.

    >>> router.dispatch_fault = drop_dispatch(count=2)
    >>> router.submit(...)      # two retries burned, third attempt lands
    """

    def __init__(self, count: int, replica_id: Optional[int] = None):
        self.count = int(count)
        self.replica_id = replica_id
        self.fired = 0

    def __call__(self, replica_id: int, record) -> None:
        if self.replica_id is not None and replica_id != self.replica_id:
            return
        if self.fired >= self.count:
            return
        self.fired += 1
        raise ConnectionError(
            f"injected dispatch drop {self.fired}/{self.count} "
            f"(replica {replica_id}, request "
            f"{record.get('request_id')!r})")


class flaky_replica:
    """Intermittent transport faults on a LIVE replica.

    Unlike :class:`kill_replica`, the replica keeps running and its
    ``healthz`` stays 200 — only the router-facing transport methods
    (``submit`` / ``poll`` / ``serving_stats``) are wrapped so that a
    seeded fraction of calls raise ``ConnectionError`` (``error_rate``)
    and/or stall (``latency_ms``).  That is exactly the *flapping*
    regime: the binary census says healthy, yet every few calls storm
    the retry path — the scenario the circuit breaker + retry budget
    must absorb.

    ``target`` is a ``ReplicaManager``/``LocalReplicaManager`` plus
    ``index``, or a replica object directly.  ``when`` (no-arg
    predicate, like ``kill_replica``) gates injection per call, so
    "start flaking once stream X has 2 tokens" is deterministic.
    Restores the original methods on ``stop()`` / context exit.

    >>> with flaky_replica(manager, index=1, error_rate=0.3,
    ...                    seed=7) as flake:
    ...     router.run(timeout=30)
    >>> flake.injected_errors > 0
    True
    """

    METHODS = ("submit", "poll", "serving_stats")

    def __init__(self, target, index: Optional[int] = None,
                 error_rate: float = 0.0, latency_ms: float = 0.0,
                 seed: int = 0,
                 when: Optional[Callable[[], bool]] = None,
                 sleep=time.sleep):
        if index is not None and hasattr(target, "replicas"):
            target = target.replicas[index]     # manager slot
        self.replica = target
        self.error_rate = float(error_rate)
        self.latency_ms = float(latency_ms)
        self.when = when
        self.rng = random.Random(seed)
        self._sleep = sleep
        self.calls = 0
        self.injected_errors = 0
        self.injected_delays = 0
        self._saved: dict = {}
        self._install()

    _MISSING = object()   # name was class-level, not an instance attr

    def _install(self) -> None:
        for name in self.METHODS:
            orig = getattr(self.replica, name)
            self._saved[name] = self.replica.__dict__.get(
                name, self._MISSING)

            def wrapper(*a, _orig=orig, _name=name, **kw):
                return self._intercept(_orig, _name, *a, **kw)

            setattr(self.replica, name, wrapper)

    def _intercept(self, orig, name, *a, **kw):
        self.calls += 1
        if self.when is None or self.when():
            if self.latency_ms > 0:
                self.injected_delays += 1
                self._sleep(self.latency_ms / 1e3)
            if self.rng.random() < self.error_rate:
                self.injected_errors += 1
                raise ConnectionError(
                    f"injected flake #{self.injected_errors} "
                    f"({name} on replica "
                    f"{getattr(self.replica, 'replica_id', '?')})")
        return orig(*a, **kw)

    def stop(self) -> None:
        """Restore the wrapped transport (idempotent)."""
        for name, prev in self._saved.items():
            if prev is self._MISSING:
                delattr(self.replica, name)   # class method shows again
            else:
                setattr(self.replica, name, prev)
        self._saved = {}

    def __enter__(self) -> "flaky_replica":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
