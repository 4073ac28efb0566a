"""Per-request tracing, the emitting half: the port's own copy of
``paddle_tpu/observability/requesttrace.py:1-252``.

A request carries a ``trace_id`` (:func:`mint_trace_id`; a router passes
its own) from submission through preemption, drain / resume and the
callback thread, and the engine emits ``trace.span`` records
(:func:`emit_span`, the batch-level :func:`emit_decode_span` and
:func:`emit_stall_span`) onto whatever sinks the registry carries.  The
records are the JAX package's, field for field, so its assembler reads
the port's streams.

Knobs: ``PTPU_TRACE_REQUESTS`` (default on; "0" disables minting, so no
spans are emitted anywhere), ``PTPU_TRACE_SAMPLE`` (fraction of requests
traced, deterministic per ``request_id`` hash — no RNG, so a
re-dispatched request keeps its sampling decision).
"""
from __future__ import annotations

import functools
import os
import time
import uuid
import zlib
from typing import Optional, Sequence, Tuple

__all__ = ["TRACE_REQUESTS_ENV", "TRACE_SAMPLE_ENV", "COMPONENT_BUCKETS",
           "tracing_enabled", "sample_fraction", "sampled", "mint_trace_id",
           "emit_span", "emit_decode_span", "emit_stall_span",
           "component_bucket", "emission_cost"]

TRACE_REQUESTS_ENV = "PTPU_TRACE_REQUESTS"
TRACE_SAMPLE_ENV = "PTPU_TRACE_SAMPLE"

#: component → attribution bucket for breakdowns and the doctor's
#: ``tail_latency`` verdict.  Recompute components absorb their induced
#: re-queue / re-dispatch time so the verdict names the cause.
COMPONENT_BUCKETS = {
    "queue": "queue",
    "dispatch": "dispatch",
    "retry_backoff": "retry_backoff",
    "prefill": "prefill",
    "decode": "decode",
    "failover": "failover_recompute",
    "failover_recompute": "failover_recompute",
    "migration": "migration",
    "migration_recompute": "migration",
    "preempt": "preempt_recompute",
    "preempt_recompute": "preempt_recompute",
    "quarantine": "quarantine",
    "callback": "callback",
    "stall": "stall",
    "deliver": "deliver",
}


# -- trace context ---------------------------------------------------------
def tracing_enabled() -> bool:
    """``PTPU_TRACE_REQUESTS`` gate — default on."""
    return os.environ.get(TRACE_REQUESTS_ENV, "1").lower() not in (
        "0", "false", "no", "off")


def sample_fraction() -> float:
    """``PTPU_TRACE_SAMPLE`` in [0, 1]; default 1.0 (trace everything)."""
    try:
        frac = float(os.environ.get(TRACE_SAMPLE_ENV, "1"))
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, frac))


def sampled(request_id: str) -> bool:
    """Deterministic per-request sampling decision: a stable hash of
    the request id against the sample fraction, so the same request
    keeps its decision across re-dispatch/recovery and across
    processes (no RNG, no shared state)."""
    frac = sample_fraction()
    if frac >= 1.0:
        return True
    if frac <= 0.0:
        return False
    h = zlib.crc32(str(request_id).encode("utf-8")) & 0xFFFFFFFF
    return (h / float(0xFFFFFFFF)) < frac


def mint_trace_id(request_id: str) -> Optional[str]:
    """A fresh trace id for ``request_id``, or ``None`` when tracing
    is disabled or the request falls outside the sample."""
    if not tracing_enabled() or not sampled(request_id):
        return None
    return uuid.uuid4().hex[:16]


def component_bucket(component: str) -> str:
    return COMPONENT_BUCKETS.get(component, component)


# -- emission --------------------------------------------------------------
class _EmissionCost:
    """Wall-clock accounting of the span-emission hot path (record
    construction + sink writes).  Off by default — when enabled, every
    ``emit_*`` call below adds its duration here, giving a direct
    measurement of what tracing costs the serving loop: at
    millisecond-scale steps, A/B run differencing has a noise floor far
    above the cost, while direct accounting resolves microseconds.
    Single accumulator, no lock — intended for single-threaded
    harnesses, not production concurrency."""

    def __init__(self) -> None:
        self.enabled = False
        self.seconds = 0.0
        self.count = 0

    def start(self) -> None:
        self.enabled = True
        self.seconds = 0.0
        self.count = 0

    def stop(self) -> None:
        self.enabled = False

    def add(self, dt: float) -> None:
        self.seconds += dt
        self.count += 1


#: process-wide emission-cost meter (see :class:`_EmissionCost`)
emission_cost = _EmissionCost()


def _costed(fn):
    """Route a function through :data:`emission_cost` when metering is
    on; zero-branch passthrough otherwise."""
    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        if not emission_cost.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            emission_cost.add(time.perf_counter() - t0)
    return wrap


@_costed
def emit_span(registry, trace_id: Optional[str], request_id: str,
              name: str, component: str, t0: float, t1: float,
              proc: str, **fields) -> None:
    """One ``trace.span`` record; no-op when the request is untraced.
    ``t0``/``t1`` are wall-clock (comparable across processes on one
    host — the fleet is single-host by construction)."""
    if trace_id is None:
        return
    t0 = float(t0)
    t1 = float(t1)
    registry.emit("trace.span", trace_id=trace_id,
                  request_id=request_id, name=str(name),
                  component=str(component), t0=t0, t1=t1,
                  dur_ms=max(0.0, t1 - t0) * 1e3, proc=str(proc),
                  **fields)


@_costed
def emit_decode_span(registry, requests: Sequence[Tuple[str, Optional[str]]],
                     residents: int, t0: float, t1: float,
                     proc: str) -> None:
    """One batch-level decode span.  ``requests`` lists the *traced*
    residents as ``(request_id, trace_id)``; ``residents`` counts every
    resident (traced or not) so the assembler's amortized share stays
    honest under partial sampling."""
    traced = [[str(r), t] for r, t in requests if t is not None]
    if not traced:
        return
    t0 = float(t0)
    t1 = float(t1)
    registry.emit("trace.span", name="decode_batch", component="decode",
                  t0=t0, t1=t1, dur_ms=max(0.0, t1 - t0) * 1e3,
                  proc=str(proc), residents=max(1, int(residents)),
                  requests=traced)


@_costed
def emit_stall_span(registry, requests: Sequence[Tuple[str, Optional[str]]],
                    t0: float, t1: float, proc: str,
                    component: str = "stall", cause: str = "") -> None:
    """One batch-level stall span: residents that were live on the
    engine but NOT served by this step (the scheduler ran someone
    else's prefill, a recompute, a quarantine bisect).  Unlike the
    amortized decode share, every stalled request experiences the
    *full* step duration, so ``residents`` stays 1.  ``component``
    names the cause when the serving step was induced work (a failover
    re-prefill's head-of-line stall is failover cost, not bad luck)."""
    t0 = float(t0)
    t1 = float(t1)
    if t1 <= t0:
        return
    traced = [[str(r), t] for r, t in requests if t is not None]
    if not traced:
        return
    registry.emit("trace.span", name="stall", component=str(component),
                  t0=t0, t1=t1, dur_ms=(t1 - t0) * 1e3, proc=str(proc),
                  residents=1, requests=traced, cause=str(cause))
