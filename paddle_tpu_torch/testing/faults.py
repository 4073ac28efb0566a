"""Serving fault injectors: the port's own copy of the serving half of
``paddle_tpu/testing/faults.py``.

- :func:`hang` / :func:`slow_call` — an interruptible stall (a hung or a
  slow-but-alive step) for the watchdog drills;
- :class:`poison_request` — plugs into ``ServingEngine(step_fault=...)``
  and poisons one request's step (raise / NaN logits / hang), so the
  quarantine, NaN-guard and watchdog paths are drillable without real
  hardware faults;
- :class:`expire_clock` — a hand-advanced clock for deadline drills.

The injectors are the JAX package's, so one drill script drives either
engine the same way.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["hang", "slow_call", "poison_request", "expire_clock"]


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
