"""Metric sinks: the port's own copy of ``paddle_tpu/observability/
sinks.py``.

- :class:`MetricsWriter` — the run-scoped JSONL stream,
  ``<dir>/worker-<i>.jsonl``, every byte through the fsync'd
  ``utils/fsio`` seam.  Buffered, and lossy-but-alive under I/O faults: a
  failed flush keeps the records for the next attempt, a full buffer
  drops the oldest and counts the drops.
- :class:`StderrSummary` — a periodic one-line run summary (step, step
  time, tokens/s, MFU, the non-zero counters) through the package logger;
- :class:`PrometheusTextfile` — a node_exporter textfile, rewritten
  atomically from a registry snapshot at most once an interval;
- :func:`render_prometheus` — every registered instrument in the
  Prometheus text exposition format, shared by the textfile and the
  status server's ``/metrics`` page, so the two are byte-identical;
- :func:`metrics_dir` — ``<run_dir>/metrics``, where a supervised run
  streams its records.

A sink is anything with ``write(record)`` / ``flush()`` / ``close()``; an
optional ``bind(registry)`` hook receives the registry on attach.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from ..framework.log import get_logger
from ..utils import fsio

__all__ = ["MetricsWriter", "StderrSummary", "PrometheusTextfile",
           "render_prometheus", "metrics_dir",
           "default_interval"]

INTERVAL_ENV = "PTPU_METRICS_INTERVAL"


def default_interval() -> float:
    return float(os.environ.get(INTERVAL_ENV, "30"))


def metrics_dir(run_dir: str) -> str:
    """Where a run's telemetry lives: ``<run_dir>/metrics``."""
    return os.path.join(run_dir, "metrics")


class MetricsWriter:
    """JSONL event sink: one ``{"ts", "kind", ...}`` object per line.

    ``directory`` is the metrics directory itself.  ``worker_id``
    defaults to the ``RANK`` environment variable (0 when unset; the
    ``torch.distributed`` launchers set it), so several processes shard
    into ``worker-0.jsonl`` / ``worker-1.jsonl`` / ... streams.
    """

    def __init__(self, directory: str, worker_id: Optional[int] = None,
                 flush_every: int = 32, flush_secs: Optional[float] = None,
                 max_buffered: int = 4096):
        if worker_id is None:
            worker_id = int(os.environ.get("RANK", "0"))
        os.makedirs(directory, exist_ok=True)
        self.worker_id = int(worker_id)
        self.path = os.path.join(directory,
                                 f"worker-{self.worker_id}.jsonl")
        self.flush_every = int(flush_every)
        self.flush_secs = (default_interval() if flush_secs is None
                           else float(flush_secs))
        self.max_buffered = int(max_buffered)
        self.dropped = 0
        self.written = 0
        self._buf: List[str] = []
        self._last_flush = time.monotonic()

    def write(self, record: Dict[str, Any]) -> None:
        self._buf.append(json.dumps(record, default=str))
        if len(self._buf) > self.max_buffered:
            # the stream is wedged (flushes failing) — stay alive, keep
            # the newest records, and account for the loss
            excess = len(self._buf) - self.max_buffered
            del self._buf[:excess]
            self.dropped += excess
        if (len(self._buf) >= self.flush_every
                or time.monotonic() - self._last_flush >= self.flush_secs):
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        payload = ("\n".join(self._buf) + "\n").encode("utf-8")
        n = len(self._buf)
        try:
            fsio.append_bytes(self.path, payload)
        except OSError as e:
            # keep the buffer for the next flush; telemetry is
            # best-effort by contract
            get_logger().warning(
                "observability: flush of %d records to %s failed: %s",
                n, self.path, e)
            self._last_flush = time.monotonic()
            return
        self.written += n
        del self._buf[:n]
        self._last_flush = time.monotonic()

    def close(self) -> None:
        self.flush()


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
# instrument-name label convention: "memory.bytes_in_use[device=tpu:0]"
# → metric paddle_tpu_memory_bytes_in_use{device="tpu:0"}
_PROM_LABELED = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<labels>[^\]]*)\]$")


class StderrSummary:
    """Periodic one-line run summary through the package logger.

    Tracks the latest ``step`` record it sees and, every ``interval``
    seconds, logs step/tokens-per-sec/MFU plus any counters — the
    glanceable "is this run healthy" line for a console tail.
    """

    def __init__(self, interval: Optional[float] = None):
        self.interval = (default_interval() if interval is None
                         else float(interval))
        self._registry = None
        self._last = 0.0
        self._last_step: Optional[Dict[str, Any]] = None
        self.emitted = 0

    def bind(self, registry) -> None:
        self._registry = registry

    def write(self, record: Dict[str, Any]) -> None:
        if record.get("kind") == "step":
            self._last_step = record
        now = time.monotonic()
        if now - self._last < self.interval:
            return
        self._last = now
        self._log_line()

    def _log_line(self) -> None:
        parts = []
        s = self._last_step
        if s is not None:
            parts.append(f"step={s.get('step')}")
            if s.get("step_time_ms") is not None:
                parts.append(f"step_ms={s['step_time_ms']:.1f}")
            if s.get("tokens_per_sec") is not None:
                parts.append(f"tok/s={s['tokens_per_sec']:.0f}")
            if s.get("mfu") is not None:
                parts.append(f"mfu={s['mfu']:.3f}")
        if self._registry is not None:
            snap = self._registry.snapshot()
            for name, m in snap.items():
                if m["type"] == "counter" and m["value"]:
                    parts.append(f"{name}={m['value']:g}")
        get_logger().info("metrics: %s", " ".join(parts) or "(no data)")
        self.emitted += 1

    def flush(self) -> None:
        self._log_line()

    def close(self) -> None:
        pass  # nothing buffered; the logger owns stderr


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
# instrument-name label convention: "memory.bytes_in_use[device=tpu:0]"
# → metric paddle_tpu_memory_bytes_in_use{device="tpu:0"}
_PROM_LABELED = re.compile(r"^(?P<base>[^\[\]]+)\[(?P<labels>[^\]]*)\]$")


def _prom_name(name: str) -> str:
    return "paddle_tpu_" + _PROM_BAD.sub("_", name)


def _prom_label_value(value: str) -> str:
    """Escape a label VALUE per the Prometheus text exposition format
    (backslash, double-quote, newline) — values pass through verbatim
    otherwise, unlike metric/label names which get sanitized."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_parse(name: str):
    """Split an instrument name into (prom metric name, label dict).
    Labels ride in a ``[k=v,k2=v2]`` suffix; names stay sanitized,
    values only escaped (a device label like ``tpu:0`` must survive)."""
    m = _PROM_LABELED.match(name)
    if not m:
        return _prom_name(name), {}
    labels = {}
    for part in m.group("labels").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[_PROM_BAD.sub("_", k.strip())] = v.strip()
    return _prom_name(m.group("base")), labels


def _prom_labels(labels: Dict[str, str], extra: Optional[Dict[str, Any]]
                 = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_prom_label_value(v)}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def render_prometheus(registry) -> str:
    """Every registered instrument in the Prometheus text exposition
    format: :class:`PrometheusTextfile` and the status server's
    ``/metrics`` page."""
    lines = []
    if registry is None:
        return ""
    typed = set()
    for name, m in registry.snapshot().items():
        pname, labels = _prom_parse(name)
        lb = _prom_labels(labels)
        if m["type"] == "counter":
            if pname not in typed:
                lines.append(f"# TYPE {pname} counter")
                typed.add(pname)
            lines.append(f"{pname}{lb} {m['value']:g}")
        elif m["type"] == "gauge":
            if m["value"] is None:
                continue
            if pname not in typed:
                lines.append(f"# TYPE {pname} gauge")
                typed.add(pname)
            lines.append(f"{pname}{lb} {m['value']:g}")
        else:  # histogram → summary (count/sum + quantile gauges)
            if pname not in typed:
                lines.append(f"# TYPE {pname} summary")
                typed.add(pname)
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                if m.get(key) is not None:
                    qlb = _prom_labels(labels, {"quantile": str(q)})
                    lines.append(f"{pname}{qlb} {m[key]:g}")
            lines.append(f"{pname}_sum{lb} {m['sum']:g}")
            lines.append(f"{pname}_count{lb} {m['count']:g}")
    return "\n".join(lines) + ("\n" if lines else "")


class PrometheusTextfile:
    """Textfile-collector exporter: rewrites ``path`` atomically with a
    snapshot of every instrument, at most once per ``interval`` seconds
    (plus on ``flush()``/``close()``).  Point node_exporter's
    ``--collector.textfile.directory`` at the parent directory."""

    def __init__(self, path: str, interval: Optional[float] = None):
        self.path = path
        self.interval = (default_interval() if interval is None
                         else float(interval))
        self._registry = None
        self._last = 0.0

    def bind(self, registry) -> None:
        self._registry = registry

    def write(self, record: Dict[str, Any]) -> None:
        if time.monotonic() - self._last < self.interval:
            return
        self.flush()

    def render(self) -> str:
        return render_prometheus(self._registry)

    def flush(self) -> None:
        self._last = time.monotonic()
        text = self.render()
        try:
            fsio.atomic_write_bytes(self.path, text.encode("utf-8"))
        except OSError as e:
            get_logger().warning(
                "observability: prometheus textfile %s failed: %s",
                self.path, e)

    def close(self) -> None:
        self.flush()
