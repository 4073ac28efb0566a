"""Cross-worker metrics aggregation.

Each worker of a run streams ``<run_dir>/metrics/worker-<i>.jsonl``; the
launcher (or anyone, via ``python -m paddle_tpu_torch.observability.aggregate
<run_dir>``) merges them into ``<run_dir>/metrics/summary.json``: per-
worker and run-wide step-time percentiles, token totals, mean/max MFU,
and an event census (how many of each record kind, including the
supervisor events sharing the timeline) — the one file a dashboard or a
post-mortem reads first.

Torn trailing lines (a worker died mid-append) are skipped, not fatal:
the stream is JSONL precisely so a partial write costs one record.
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Dict, List, Optional

from ..framework.log import vlog
from ..utils import fsio
from .sinks import metrics_dir

__all__ = ["read_worker_stream", "StreamTail", "aggregate_run",
           "straggler_stats", "export_chrome_trace",
           "SCHEMA_VERSION", "KNOWN_SCHEMA_VERSIONS"]

_WORKER_RE = re.compile(r"^worker-(\d+)\.jsonl$")

# version of the record/summary schema this reader understands.  Records
# carry no schema_version (= v1) or one the reader knows; anything newer
# is skipped with drop accounting so old tooling stays usable against
# new runs (and vice versa) instead of mis-parsing them.
SCHEMA_VERSION = 1
KNOWN_SCHEMA_VERSIONS = (1,)


def _parse_stream_lines(text: str, drops: Dict[str, int]
                        ) -> List[Dict[str, Any]]:
    """The shared drop-tolerant JSONL line parser: torn/garbled lines and
    foreign ``schema_version`` records are skipped with accounting."""
    records: List[Dict[str, Any]] = []
    drops.setdefault("torn_lines", 0)
    drops.setdefault("unknown_schema", 0)
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            drops["torn_lines"] += 1
            continue  # torn tail from a mid-append death
        if not isinstance(rec, dict):
            drops["torn_lines"] += 1
            continue
        if rec.get("schema_version",
                   SCHEMA_VERSION) not in KNOWN_SCHEMA_VERSIONS:
            drops["unknown_schema"] += 1
            continue
        records.append(rec)
    return records


def read_worker_stream(path: str,
                       drops: Optional[Dict[str, int]] = None
                       ) -> List[Dict[str, Any]]:
    """Parse one worker JSONL file, skipping torn/garbled lines and
    records from a schema this reader doesn't know.

    ``drops``, when given, accumulates the loss accounting:
    ``torn_lines`` (unparseable — a mid-append death) and
    ``unknown_schema`` (valid JSON, foreign ``schema_version``)."""
    if drops is None:
        drops = {}
    drops.setdefault("torn_lines", 0)
    drops.setdefault("unknown_schema", 0)
    try:
        raw = fsio.read_bytes(path)
    except OSError:
        return []
    return _parse_stream_lines(raw.decode("utf-8", errors="replace"),
                               drops)


class StreamTail:
    """Incremental reader of one still-growing worker JSONL stream
    .

    Unlike :func:`read_worker_stream` this keeps a byte offset and only
    parses bytes appended since the last :meth:`poll` — and it never
    consumes past the last newline, so a line the writer is mid-append
    on is read complete on the NEXT poll instead of counting as torn.
    A shrunken file (rotation/truncation) resets the offset and rereads.
    """

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.drops: Dict[str, int] = {"torn_lines": 0,
                                      "unknown_schema": 0}

    def poll(self) -> List[Dict[str, Any]]:
        """Records appended since the previous poll (possibly empty)."""
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size < self.offset:   # truncated/rotated under us
                    self.offset = 0
                if size == self.offset:
                    return []
                f.seek(self.offset)
                chunk = f.read(size - self.offset)
        except OSError:
            return []
        # stop at the last complete line; a partial tail is not torn,
        # just not finished yet
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        self.offset += end + 1
        return _parse_stream_lines(
            chunk[:end].decode("utf-8", errors="replace"), self.drops)


def _pct(sorted_vals: List[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _step_stats(steps: List[Dict[str, Any]]) -> Dict[str, Any]:
    times = sorted(float(s["step_time_ms"]) for s in steps
                   if s.get("step_time_ms") is not None)
    mfus = [float(s["mfu"]) for s in steps if s.get("mfu") is not None]
    toks = [float(s["tokens"]) for s in steps
            if s.get("tokens") is not None]
    tps = [float(s["tokens_per_sec"]) for s in steps
           if s.get("tokens_per_sec") is not None]
    out: Dict[str, Any] = {"steps": len(steps)}
    if times:
        out["step_time_ms"] = {
            "mean": sum(times) / len(times), "min": times[0],
            "max": times[-1], "p50": _pct(times, 50),
            "p90": _pct(times, 90), "p99": _pct(times, 99)}
    if toks:
        out["total_tokens"] = sum(toks)
    if tps:
        out["tokens_per_sec_mean"] = sum(tps) / len(tps)
    if mfus:
        out["mfu"] = {"mean": sum(mfus) / len(mfus), "max": max(mfus),
                      "last": mfus[-1]}
    return out


def straggler_stats(workers: Dict[int, List[Dict[str, Any]]]
                    ) -> Optional[Dict[str, Any]]:
    """Cross-worker skew analysis.

    Aligns each worker's ``step`` records by step index and, for every
    step at least two workers reported, measures the **spread** — the
    slowest minus the fastest worker's ``step_time_ms``.  Returns
    ``p50``/``p99`` of the spread (absolute and relative to the median
    step time), plus the attribution: which worker was slowest how
    often, and each worker's mean step time.  ``None`` for runs with no
    alignable steps (single worker, or no step records)."""
    per_step: Dict[Any, Dict[int, float]] = {}
    for wid, records in workers.items():
        for r in records:
            if r.get("kind") != "step" or r.get("step") is None \
                    or r.get("step_time_ms") is None:
                continue
            # a worker that rolled back revisits a step; keep the last
            per_step.setdefault(r["step"], {})[wid] = float(
                r["step_time_ms"])
    aligned = {s: times for s, times in per_step.items()
               if len(times) >= 2}
    if not aligned:
        return None
    spreads, all_times = [], []
    slowest_count: Dict[int, int] = {}
    for _s, times in sorted(aligned.items(), key=lambda kv: str(kv[0])):
        vals = sorted(times.values())
        spreads.append(vals[-1] - vals[0])
        all_times.extend(vals)
        worst = max(times, key=lambda w: times[w])
        slowest_count[worst] = slowest_count.get(worst, 0) + 1
    spreads.sort()
    all_times.sort()
    median_step = _pct(all_times, 50) or 0.0
    p50, p99 = _pct(spreads, 50), _pct(spreads, 99)
    worker_means = {
        str(wid): (sum(t for times in aligned.values()
                       if wid in times for t in [times[wid]])
                   / max(1, sum(1 for times in aligned.values()
                                if wid in times)))
        for wid in workers}
    straggler = max(slowest_count, key=lambda w: slowest_count[w])
    return {
        "aligned_steps": len(aligned),
        "spread_ms": {"p50": p50, "p99": p99, "max": spreads[-1]},
        "relative_spread": {
            "p50": (p50 / median_step) if median_step else None,
            "p99": (p99 / median_step) if median_step else None},
        "median_step_ms": median_step,
        "slowest_counts": {str(w): c
                           for w, c in sorted(slowest_count.items())},
        "worker_mean_step_ms": worker_means,
        "straggler": straggler,
        "straggler_fraction": slowest_count[straggler] / len(aligned),
    }


def aggregate_run(run_dir: str,
                  out_path: Optional[str] = None) -> Optional[dict]:
    """Merge every ``worker-*.jsonl`` under ``<run_dir>/metrics`` into
    ``summary.json`` (atomic write through fsio).  Returns the summary
    dict, or None when the run produced no metrics at all."""
    mdir = metrics_dir(run_dir)
    if not os.path.isdir(mdir):
        return None
    workers: Dict[int, List[Dict[str, Any]]] = {}
    drops: Dict[str, int] = {}
    for name in sorted(os.listdir(mdir)):
        m = _WORKER_RE.match(name)
        if not m:
            continue
        workers[int(m.group(1))] = read_worker_stream(
            os.path.join(mdir, name), drops=drops)
    if not workers:
        return None

    all_records: List[Dict[str, Any]] = []
    per_worker: Dict[str, Any] = {}
    for wid, records in sorted(workers.items()):
        all_records.extend(records)
        steps = [r for r in records if r.get("kind") == "step"]
        kinds: Dict[str, int] = {}
        for r in records:
            k = str(r.get("kind"))
            kinds[k] = kinds.get(k, 0) + 1
        per_worker[str(wid)] = {"records": len(records),
                                "kinds": kinds,
                                **_step_stats(steps)}

    kinds_total: Dict[str, int] = {}
    for r in all_records:
        k = str(r.get("kind"))
        kinds_total[k] = kinds_total.get(k, 0) + 1
    ts = [float(r["ts"]) for r in all_records if "ts" in r]
    summary = {
        "schema_version": SCHEMA_VERSION,
        "run_dir": os.path.abspath(run_dir),
        "workers": sorted(workers),
        "records": len(all_records),
        "dropped": drops,
        "kinds": dict(sorted(kinds_total.items())),
        "supervisor_events": {k: v for k, v in sorted(kinds_total.items())
                              if k.startswith("supervisor.")},
        "time_range": ([min(ts), max(ts)] if ts else None),
        "overall": _step_stats(
            [r for r in all_records if r.get("kind") == "step"]),
        "per_worker": per_worker,
        "straggler": straggler_stats(workers),
    }
    out_path = out_path or os.path.join(mdir, "summary.json")
    fsio.atomic_write_bytes(
        out_path, json.dumps(summary, indent=1, default=str,
                             sort_keys=False).encode("utf-8"))
    vlog(1, "observability: aggregated %d workers → %s", len(workers),
         out_path)
    return summary


def _read_all_workers(run_dir: str
                      ) -> Dict[int, List[Dict[str, Any]]]:
    mdir = metrics_dir(run_dir)
    workers: Dict[int, List[Dict[str, Any]]] = {}
    if not os.path.isdir(mdir):
        return workers
    for name in sorted(os.listdir(mdir)):
        m = _WORKER_RE.match(name)
        if m:
            workers[int(m.group(1))] = read_worker_stream(
                os.path.join(mdir, name))
    return workers


def export_chrome_trace(run_dir: str,
                        out_path: Optional[str] = None) -> Optional[int]:
    """Merge every worker stream into ONE multi-process Chrome/Perfetto
    timeline.

    The per-process ``tracing.export_chrome_trace`` stamps everything
    with its own ``os.getpid()``, so naively concatenating worker
    streams collapses all processes onto whatever pid the reader runs
    as.  Here each ``worker-<i>.jsonl`` stream gets its own pid = i,
    announced with a ``process_name`` metadata event (label taken from
    the stream's own ``trace.span`` ``proc`` field — ``router`` for
    worker-0, ``replica-<k>`` for engine workers — falling back to
    ``worker-<i>``), and tracks within a process get ``thread_name``
    metadata: one track per request, plus a shared ``decode`` track for
    batch-level decode spans and a ``steps`` track for train/serve step
    records.  Timestamps are wall-clock µs, matching
    :func:`..requesttrace.chrome_trace_events`, so the two exports line
    up when opened together.

    Writes ``<run_dir>/metrics/trace.json`` unless ``out_path`` is
    given; returns the event count, or None when the run has no
    metrics."""
    workers = _read_all_workers(run_dir)
    if not workers:
        return None
    events: List[Dict[str, Any]] = []
    for wid, records in sorted(workers.items()):
        pid = wid
        proc = next((str(r["proc"]) for r in records
                     if str(r.get("kind", "")).startswith("trace.")
                     and r.get("proc")), None)
        label = proc or f"worker-{wid}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        tids: Dict[str, int] = {}

        def track(name: str, pid=pid, tids=tids) -> int:
            if name not in tids:
                tids[name] = len(tids) + 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tids[name],
                               "args": {"name": name}})
            return tids[name]

        for r in records:
            kind = r.get("kind")
            if kind == "trace.span":
                t0, dur = r.get("t0"), r.get("dur_ms")
                if t0 is None or dur is None:
                    continue
                if r.get("requests") is not None:   # batch decode span
                    tname = "decode"
                else:
                    tname = str(r.get("request_id")
                                or r.get("trace_id") or "spans")
                events.append({
                    "name": str(r.get("name")), "ph": "X",
                    "cat": str(r.get("component") or "span"),
                    "pid": pid, "tid": track(tname),
                    "ts": float(t0) * 1e6, "dur": float(dur) * 1e3,
                    "args": {k: r[k] for k in
                             ("trace_id", "component", "residents")
                             if r.get(k) is not None}})
            elif kind == "step" and r.get("ts") is not None \
                    and r.get("step_time_ms") is not None:
                dur = float(r["step_time_ms"])
                events.append({
                    "name": f"step {r.get('step', '?')}", "ph": "X",
                    "cat": "step", "pid": pid, "tid": track("steps"),
                    "ts": (float(r["ts"]) - dur / 1e3) * 1e6,
                    "dur": dur * 1e3,
                    "args": {k: r[k] for k in ("step", "tokens", "mfu")
                             if r.get(k) is not None}})
    out_path = out_path or os.path.join(metrics_dir(run_dir),
                                        "trace.json")
    fsio.atomic_write_bytes(
        out_path, json.dumps({"traceEvents": events,
                              "displayTimeUnit": "ms"}).encode("utf-8"))
    vlog(1, "observability: chrome trace %d events → %s", len(events),
         out_path)
    return len(events)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    chrome = None
    if "--chrome" in args:
        i = args.index("--chrome")
        try:
            chrome = args[i + 1]
        except IndexError:
            chrome = ""
        del args[i:i + 2]
    if len(args) != 1:
        print("usage: python -m paddle_tpu_torch.observability.aggregate "  # noqa: print
              "<run_dir> [--chrome out.json]", file=sys.stderr)
        return 2
    summary = aggregate_run(args[0])
    if summary is None:
        print(f"no metrics under {args[0]}", file=sys.stderr)  # noqa: print
        return 1
    if chrome is not None:
        n = export_chrome_trace(args[0], chrome or None)
        summary["chrome_trace_events"] = n
    print(json.dumps(summary, indent=1, default=str))  # noqa: print
    return 0


if __name__ == "__main__":
    sys.exit(main())
