"""Post-mortem event log for the run supervisor: the port's own copy of
``paddle_tpu/supervisor/report.py``.

Every health event the supervisor observes — watchdog timeout, skipped
batch, LR backoff, heartbeat staleness, checkpoint quarantine, rollback,
budget exhaustion — lands here as one JSON record, and the whole log is
flushed durably (``utils/fsio.atomic_write_bytes``) after each record, so
a run that dies mid-incident still leaves a readable account of what the
supervisor saw and did.  The report is the contract between the run and
whoever (human or launcher) has to decide what to do with its corpse.
"""
from __future__ import annotations

import json
import time
from collections import Counter
from typing import Any, Dict, List, Optional

from ..framework.log import vlog
from ..utils import fsio

__all__ = ["SupervisorReport"]


class SupervisorReport:
    """Append-only, durably flushed JSON event log.

    >>> report = SupervisorReport("run/supervisor_report.json")
    >>> report.record("watchdog_timeout", label="train_batch", seconds=300)
    >>> report.counts()["watchdog_timeout"]
    1

    ``path=None`` keeps the log in memory only (unit tests, dry runs).
    The ``record`` signature doubles as the generic event-sink callable
    other layers accept (``ElasticTrainState(event_sink=report.record)``).
    """

    def __init__(self, path: Optional[str] = None, clock=time.time):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._clock = clock

    def record(self, kind: str, **fields) -> Dict[str, Any]:
        event = {"kind": str(kind), "time": float(self._clock())}
        event.update(fields)
        self.events.append(event)
        vlog(1, "supervisor: event %s %s", kind, fields)
        self._mirror_to_metrics(event)
        self.flush()
        return event

    def _mirror_to_metrics(self, event: Dict[str, Any]) -> None:
        """Every supervisor event also lands on the telemetry timeline
        a ``supervisor.<kind>`` record through whatever sinks
        are attached — so one JSONL stream interleaves step breakdowns
        with watchdog fires, guard verdicts, heartbeat transitions and
        rollbacks — plus a counter per kind for dashboards."""
        try:
            from ..observability.registry import get_registry
            reg = get_registry()
            kind = event["kind"]
            reg.counter(f"supervisor.{kind}").inc()
            fields = {k: v for k, v in event.items()
                      if k not in ("kind", "time", "ts")}
            reg.emit(f"supervisor.{kind}", ts=event["time"], **fields)
        except Exception as e:
            # telemetry is best-effort; the durable report above is the
            # record of truth
            vlog(1, "supervisor: metrics mirror failed: %r", e)

    def flush(self) -> None:
        if self.path is None:
            return
        payload = json.dumps({"events": self.events}, indent=1,
                             default=str).encode("utf-8")
        try:
            fsio.atomic_write_bytes(self.path, payload)
        except OSError as e:
            # the report must never take the run down with it
            vlog(0, "supervisor: report flush to %s failed: %s",
                 self.path, e)

    def counts(self) -> Dict[str, int]:
        return dict(Counter(e["kind"] for e in self.events))

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["kind"] == kind]

    def summary(self) -> str:
        counts = self.counts()
        body = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        return f"supervisor report ({len(self.events)} events): {body or '—'}"

    @classmethod
    def load(cls, path: str) -> "SupervisorReport":
        report = cls(path=None)
        report.events = json.loads(fsio.read_bytes(path))["events"]
        report.path = path
        return report
