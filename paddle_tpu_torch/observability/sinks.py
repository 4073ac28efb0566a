"""Metric sinks: the port's own copy of the parts of ``paddle_tpu/
observability/sinks.py`` that serving uses.

- :class:`MetricsWriter` — the run-scoped JSONL stream,
  ``<dir>/worker-<i>.jsonl``, every byte through the fsync'd
  ``utils/fsio`` seam.  Buffered, and lossy-but-alive under I/O faults: a
  failed flush keeps the records for the next attempt, a full buffer
  drops the oldest and counts the drops.
- :func:`render_prometheus` — every registered instrument in the
  Prometheus text exposition format (the ``/metrics`` page).

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

__all__ = ["MetricsWriter", "render_prometheus", "default_interval"]

INTERVAL_ENV = "PTPU_METRICS_INTERVAL"


def default_interval() -> float:
    return float(os.environ.get(INTERVAL_ENV, "30"))


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
    format: the status server's ``/metrics`` page."""
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
