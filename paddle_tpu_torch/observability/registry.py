"""Process-wide metrics registry: the port's own copy of ``paddle_tpu/
observability/registry.py``.

Three instrument kinds, one namespace:

- :class:`Counter` — monotone float, ``inc(n)``;
- :class:`Gauge` — last-value-wins, ``set(v)``;
- :class:`Histogram` — exact count/sum/min/max plus a bounded reservoir
  (algorithm R) for percentiles, so a million observations cost a fixed
  few KB.

Instruments accumulate always; *event records* reach sinks only through
:meth:`MetricsRegistry.emit`, which returns at once when no sink is
attached.  The process-global registry (:func:`get_registry`) attaches a
JSONL :class:`~paddle_tpu_torch.observability.sinks.MetricsWriter` when
``PTPU_METRICS_DIR`` is set (``<dir>/worker-<rank>.jsonl``).
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "split_labels"]

METRICS_DIR_ENV = "PTPU_METRICS_DIR"


def split_labels(name: str) -> "tuple[str, Dict[str, str]]":
    """Split an instrument name into ``(base, labels)``.

    Labels ride as a name suffix by convention —
    ``collective.all_reduce.ms[axis=dp,n=8]`` →
    ``("collective.all_reduce.ms", {"axis": "dp", "n": "8"})`` — so the
    registry itself stays label-agnostic.  Unlabeled names come back
    with an empty dict; every reader that aggregates a metric family
    must parse through this helper so labeled and legacy-unlabeled
    series sum without double-counting.
    """
    if not name.endswith("]"):
        return name, {}
    i = name.find("[")
    if i < 0:
        return name, {}
    base, body = name[:i], name[i + 1:-1]
    labels: Dict[str, str] = {}
    for part in body.split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k.strip()] = v.strip()
    return base, labels


class Counter:
    """Monotone counter.  ``inc()`` is hot-path safe (< 1 µs/call)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value instrument (run state, lr scale, live MFU...)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Exact count/sum/min/max + bounded reservoir for percentiles.

    The reservoir is algorithm R: every observation has ``max_samples/n``
    probability of being retained, so percentile estimates stay unbiased
    while memory stays fixed regardless of run length.
    """

    __slots__ = ("name", "max_samples", "_lock", "_samples", "count",
                 "sum", "min", "max", "_rng")

    def __init__(self, name: str, max_samples: int = 512,
                 seed: Optional[int] = None):
        self.name = name
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self._samples[j] = v

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
            s = sorted(self._samples)

        def pct(p):
            if not s:
                return None
            return s[min(len(s) - 1,
                         max(0, int(round(p / 100.0 * (len(s) - 1)))))]

        return {"type": "histogram", "count": count, "sum": total,
                "min": lo, "max": hi,
                "mean": (total / count) if count else None,
                "p50": pct(50), "p90": pct(90), "p99": pct(99)}


class MetricsRegistry:
    """Name → instrument map plus the sink fan-out.

    ``emit(kind, **fields)`` stamps a wall-clock ``ts`` and hands the
    record to every attached sink; with no sink it is a two-instruction
    no-op, which is what lets every layer emit unconditionally.
    """

    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._sinks: List[Any] = []
        self._clock = clock

    # -- instruments -------------------------------------------------------
    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 512) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    # -- sinks -------------------------------------------------------------
    def add_sink(self, sink) -> Any:
        """Attach a sink (``write(record)`` / ``flush()`` / ``close()``).
        Sinks with a ``bind(registry)`` hook get this registry for
        snapshot-style output (Prometheus, stderr summaries)."""
        bind = getattr(sink, "bind", None)
        if bind is not None:
            bind(self)
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink, close: bool = True) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
        if close:
            sink.close()

    @property
    def sinks(self) -> List[Any]:
        with self._lock:
            return list(self._sinks)

    # -- events ------------------------------------------------------------
    def emit(self, kind: str, ts: Optional[float] = None, **fields) -> None:
        """Push one event record to every sink (no-op with no sinks)."""
        sinks = self._sinks
        if not sinks:
            return
        record = {"ts": float(self._clock() if ts is None else ts),
                  "kind": str(kind)}
        record.update(fields)
        for sink in list(sinks):
            try:
                sink.write(record)
            except Exception as e:
                # a broken sink must never take the run down with it
                from ..framework.log import vlog
                vlog(0, "observability: sink %r dropped a record: %s",
                     type(sink).__name__, e)

    def flush(self) -> None:
        for sink in self.sinks:
            try:
                sink.flush()
            except Exception as e:
                from ..framework.log import vlog
                vlog(0, "observability: sink %r flush failed: %s",
                     type(sink).__name__, e)

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{name: instrument snapshot} for every registered instrument."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def reset(self) -> None:
        """Drop every instrument (tests); sinks stay attached."""
        with self._lock:
            self._metrics.clear()


_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-global registry.  First call honors
    ``PTPU_METRICS_DIR``: when set, a JSONL
    :class:`~paddle_tpu_torch.observability.sinks.MetricsWriter` for this
    worker is attached under that directory."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
            metrics_dir = os.environ.get(METRICS_DIR_ENV)
            if metrics_dir:
                from .sinks import MetricsWriter
                try:
                    _global.add_sink(MetricsWriter(metrics_dir))
                except OSError as e:
                    from ..framework.log import vlog
                    vlog(0, "observability: cannot attach %s=%s: %s",
                         METRICS_DIR_ENV, metrics_dir, e)
        return _global
