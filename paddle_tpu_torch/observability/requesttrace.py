"""Per-request tracing: the port's own copy of
``paddle_tpu/observability/requesttrace.py``.

A request carries a ``trace_id`` (:func:`mint_trace_id`; a router passes
its own) from submission through preemption, drain / resume and the
callback thread, and the engine emits ``trace.span`` records
(:func:`emit_span`, the batch-level :func:`emit_decode_span` and
:func:`emit_stall_span`) onto whatever sinks the registry carries.  The
records are the JAX package's, field for field, so either package's
assembler reads either package's streams.

:class:`TraceAssembler` folds the ``trace.*`` records of any number of
per-process streams (and the fleet journal) into one waterfall per
request, with a coverage (the share of the request's window that its
spans explain) and a per-component breakdown; :func:`assemble_run` does
it for a run directory; :func:`tail_latency_attribution` names the
component the p99-slowest traces pay for beyond the median trace's
breakdown; :func:`export_chrome_trace` writes one Perfetto timeline.

CLI::

    python -m paddle_tpu_torch.observability.requesttrace <run_dir> \\
        [--out traces.json] [--chrome trace.json] [--json]

Knobs: ``PTPU_TRACE_REQUESTS`` (default on; "0" disables minting, so no
spans are emitted anywhere), ``PTPU_TRACE_SAMPLE`` (fraction of requests
traced, deterministic per ``request_id`` hash — no RNG, so a
re-dispatched request keeps its sampling decision).
"""
from __future__ import annotations

import functools
import json
import math
import os
import re
import time
import uuid
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils import fsio
from .aggregate import read_worker_stream

__all__ = ["TRACE_REQUESTS_ENV", "TRACE_SAMPLE_ENV", "COMPONENT_BUCKETS",
           "tracing_enabled", "sample_fraction", "sampled", "mint_trace_id",
           "emit_span", "emit_decode_span", "emit_stall_span",
           "component_bucket", "emission_cost", "TraceAssembler",
           "assemble_run", "tail_latency_attribution",
           "chrome_trace_events", "export_chrome_trace", "main"]

_WORKER_RE = re.compile(r"^worker-(\d+)\.jsonl$")

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


# -- assembly --------------------------------------------------------------
def _merged(intervals: List[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    """Union of ``[t0, t1]`` intervals as a sorted disjoint list."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def _merged_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``[t0, t1]`` intervals."""
    return sum(b - a for a, b in _merged(intervals))


def _residue_length(base: List[Tuple[float, float]],
                    minus: List[Tuple[float, float]]) -> float:
    """Length of union(base) NOT covered by union(minus)."""
    total = 0.0
    for a, b in _merged(base):
        cut = a
        for c, d in _merged(minus):
            if d <= cut:
                continue
            if c >= b:
                break
            if c > cut:
                total += c - cut
            cut = max(cut, min(d, b))
            if cut >= b:
                break
        if cut < b:
            total += b - cut
    return total


def _median(values: List[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class TraceAssembler:
    """Folds ``trace.request`` / ``trace.span`` / ``trace.request_end``
    records (from any number of per-process streams) into one waterfall
    per request.

    Feed it records in any order via :meth:`add_record` /
    :meth:`add_records`, optionally cross-check against the fleet WAL
    via :meth:`add_journal`, then :meth:`assemble`.
    """

    def __init__(self):
        self._open: Dict[str, Dict[str, Any]] = {}     # trace_id -> rec
        self._end: Dict[str, Dict[str, Any]] = {}
        self._spans: Dict[str, List[Dict[str, Any]]] = {}
        self._journal: Dict[str, Dict[str, Any]] = {}  # trace_id -> rec
        self.records_seen = 0

    # -- ingest ------------------------------------------------------------
    def add_record(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("kind")
        if kind == "trace.request":
            tid = rec.get("trace_id")
            if tid is None:
                return
            self.records_seen += 1
            prev = self._open.get(tid)
            if prev is None or float(rec.get("t0", math.inf)) < \
                    float(prev.get("t0", math.inf)):
                self._open[tid] = rec
        elif kind == "trace.request_end":
            tid = rec.get("trace_id")
            if tid is None:
                return
            self.records_seen += 1
            prev = self._end.get(tid)
            if prev is None or float(rec.get("t1", -math.inf)) > \
                    float(prev.get("t1", -math.inf)):
                self._end[tid] = rec
        elif kind == "trace.span":
            self.records_seen += 1
            if rec.get("requests") is not None:
                # batch-level span (decode_batch, stall): fan out to
                # every listed resident, amortizing over ``residents``
                # (1 for stalls — each stalled request eats the full
                # step)
                residents = max(1, int(rec.get("residents", 1)))
                dur = float(rec.get("dur_ms", 0.0))
                name = ("decode" if rec.get("name") == "decode_batch"
                        else str(rec.get("name")))
                comp = str(rec.get("component", name))
                for entry in rec.get("requests", []):
                    try:
                        rid, tid = entry[0], entry[1]
                    except (TypeError, IndexError):
                        continue
                    if tid is None:
                        continue
                    self._spans.setdefault(tid, []).append({
                        "name": name, "component": comp,
                        "request_id": rid,
                        "t0": float(rec.get("t0", 0.0)),
                        "t1": float(rec.get("t1", 0.0)),
                        "dur_ms": dur,
                        "amortized_ms": dur / residents,
                        "proc": rec.get("proc")})
            else:
                tid = rec.get("trace_id")
                if tid is None:
                    return
                self._spans.setdefault(tid, []).append({
                    "name": rec.get("name"),
                    "component": rec.get("component"),
                    "request_id": rec.get("request_id"),
                    "t0": float(rec.get("t0", 0.0)),
                    "t1": float(rec.get("t1", 0.0)),
                    "dur_ms": float(rec.get("dur_ms", 0.0)),
                    "amortized_ms": None,
                    "proc": rec.get("proc")})

    def add_records(self, records: Iterable[Dict[str, Any]]) -> None:
        for rec in records:
            self.add_record(rec)

    def add_journal(self, rec: Dict[str, Any]) -> None:
        """One recovered WAL stream (``JournalStore`` record shape)."""
        tid = rec.get("trace_id")
        if tid is not None:
            self._journal[tid] = rec

    # -- assemble ----------------------------------------------------------
    def _one(self, tid: str) -> Dict[str, Any]:
        spans = sorted(self._spans.get(tid, []),
                       key=lambda s: (s["t0"], s["t1"]))
        opened = self._open.get(tid)
        ended = self._end.get(tid)
        t0 = float(opened["t0"]) if opened is not None else (
            min((s["t0"] for s in spans), default=None))
        t1 = float(ended["t1"]) if ended is not None else (
            max((s["t1"] for s in spans), default=None))
        latency_ms = (t1 - t0) * 1e3 if (t0 is not None and
                                         t1 is not None) else None
        components: Dict[str, float] = {}
        intervals: List[Tuple[float, float]] = []
        deliver: List[Tuple[float, float]] = []
        for s in spans:
            a, b = s["t0"], s["t1"]
            if t0 is not None:
                a = max(a, t0)
            if t1 is not None:
                b = min(b, t1)
            bucket = component_bucket(s.get("component") or "other")
            if bucket == "deliver":
                # lowest-priority residue bucket: the router's
                # progress-observation window overlaps generation, so
                # it is charged only what no other span explains (poll
                # starvation, HTTP lag) — see below
                if b > a:
                    deliver.append((a, b))
                continue
            share = s["amortized_ms"] if s["amortized_ms"] is not None \
                else s["dur_ms"]
            components[bucket] = components.get(bucket, 0.0) + share
            if b > a:
                intervals.append((a, b))
        if deliver:
            residue = _residue_length(deliver, intervals) * 1e3
            if residue > 1e-6:
                components["deliver"] = residue
            intervals = intervals + deliver
        if latency_ms is not None and latency_ms > 0:
            coverage = min(1.0, _merged_length(intervals)
                           / ((t1 - t0) or 1.0))
        elif spans:
            coverage = 1.0 if latency_ms == 0.0 else 0.0
        else:
            coverage = 0.0
        request_id = None
        for src in (opened, ended):
            if src is not None and src.get("request_id") is not None:
                request_id = src["request_id"]
                break
        if request_id is None and spans:
            request_id = next((s["request_id"] for s in spans
                               if s.get("request_id") is not None), None)
        wal = self._journal.get(tid)
        return {"trace_id": tid, "request_id": request_id,
                "t0": t0, "t1": t1, "latency_ms": latency_ms,
                "complete": opened is not None and ended is not None,
                "reason": (ended or {}).get("reason"),
                "tokens": (ended or {}).get("tokens"),
                "spans": spans,
                "procs": sorted({s.get("proc") for s in spans
                                 if s.get("proc") is not None}),
                "components": {k: round(v, 3)
                               for k, v in sorted(components.items())},
                "coverage": round(coverage, 4),
                "wal": None if wal is None else {
                    "tokens": len(wal.get("tokens", [])),
                    "finished": bool(wal.get("finished")),
                    "reason": wal.get("reason")}}

    def assemble(self) -> Dict[str, Any]:
        """All traces plus integrity accounting.  A span whose
        ``trace_id`` has neither lifecycle record is an **orphan** —
        the continuity tests assert there are none."""
        ids = set(self._open) | set(self._end) | set(self._spans)
        traces = [self._one(tid) for tid in ids]
        traces.sort(key=lambda t: (t["t0"] is None, t["t0"] or 0.0))
        orphans = sorted(tid for tid in self._spans
                         if tid not in self._open and tid not in self._end)
        wal_ids = set(self._journal)
        return {"traces": traces,
                "complete": sum(1 for t in traces if t["complete"]),
                "orphan_spans": orphans,
                "wal_streams": len(wal_ids),
                "wal_matched": len(wal_ids & ids),
                "records_seen": self.records_seen}

    def from_records(self, records: Iterable[Dict[str, Any]]
                     ) -> Dict[str, Any]:
        self.add_records(records)
        return self.assemble()


def assemble_run(run_dir: str) -> Dict[str, Any]:
    """Merge ``<run_dir>/metrics/worker-*.jsonl`` (router = worker-0,
    replica *i* = worker-*i+1*) and the fleet WAL into per-request
    waterfalls."""
    from .sinks import metrics_dir
    asm = TraceAssembler()
    drops: Dict[str, int] = {}
    mdir = metrics_dir(run_dir)
    streams = 0
    try:
        listing = sorted(os.listdir(mdir))
    except OSError:
        listing = []
    for name in listing:
        if not _WORKER_RE.match(name):
            continue
        streams += 1
        asm.add_records(read_worker_stream(os.path.join(mdir, name),
                                           drops))
    # the fleet WAL cross-checks stream identity (and survives a
    # SIGKILLed metrics stream outright)
    from ..inference.fleet.journal import JournalStore, journal_dir
    jdir = journal_dir(run_dir)
    if os.path.isdir(jdir):
        store = JournalStore(run_dir)
        for name in sorted(os.listdir(jdir)):
            if not (name.endswith(".jsonl") or name.endswith(".jsonl.done")):
                continue
            rec = store._read_one(os.path.join(jdir, name),
                                  quarantine=False)
            if rec is not None:
                asm.add_journal(rec)
    out = asm.assemble()
    out["run_dir"] = run_dir
    out["streams"] = streams
    out["drops"] = drops
    return out


# -- tail attribution ------------------------------------------------------
def tail_latency_attribution(traces: List[Dict[str, Any]],
                             tail_pct: float = 99.0
                             ) -> Optional[Dict[str, Any]]:
    """Name the dominant component of the p99-slowest traces.

    Dominance is judged by **excess over the median trace's
    per-component breakdown**, not absolute share — decode dominates
    every healthy trace in absolute terms, so "what does the tail pay
    *extra* for" is the question that points at failover recompute,
    retry backoff or queueing.  Returns ``None`` with fewer than two
    complete traces (no tail to attribute)."""
    done = [t for t in traces
            if t.get("complete") and t.get("latency_ms") is not None]
    if len(done) < 2:
        return None
    lats = sorted(t["latency_ms"] for t in done)
    rank = max(1, int(math.ceil(tail_pct / 100.0 * len(lats))))
    thresh = lats[rank - 1]
    slow = [t for t in done if t["latency_ms"] >= thresh]
    rest = [t for t in done if t["latency_ms"] < thresh] or done
    comps = sorted({c for t in done for c in t["components"]})
    baseline = {c: _median([t["components"].get(c, 0.0) for t in rest])
                for c in comps}
    excess = {c: 0.0 for c in comps}
    for t in slow:
        for c in comps:
            excess[c] += max(0.0, t["components"].get(c, 0.0)
                             - baseline[c])
    if any(v > 0.0 for v in excess.values()):
        dominant = max(excess, key=lambda c: excess[c])
    else:
        # degenerate tail (all traces identical): largest absolute
        agg: Dict[str, float] = {}
        for t in slow:
            for c, v in t["components"].items():
                agg[c] = agg.get(c, 0.0) + v
        dominant = max(agg, key=lambda c: agg[c]) if agg else "unknown"
    return {"dominant": dominant,
            "p99_ms": round(thresh, 3),
            "median_ms": round(_median(lats), 3),
            "baseline": {c: round(v, 3) for c, v in baseline.items()},
            "excess": {c: round(v, 3) for c, v in excess.items()},
            "slow": [{"request_id": t["request_id"],
                      "trace_id": t["trace_id"],
                      "latency_ms": round(t["latency_ms"], 3),
                      "coverage": t["coverage"],
                      "components": t["components"]}
                     for t in sorted(slow,
                                     key=lambda t: -t["latency_ms"])]}


# -- chrome export ---------------------------------------------------------
def chrome_trace_events(traces: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
    """Perfetto/chrome://tracing events: one pid per fleet process
    (``process_name`` metadata), one tid per request
    (``thread_name`` = request id), every span an ``X`` duration event
    nested under its request's track in the process it ran in."""
    procs = sorted({s.get("proc") or "unknown"
                    for t in traces for s in t["spans"]})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    events: List[Dict[str, Any]] = []
    for proc, pid in pid_of.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": proc}})
    ordered = sorted(traces, key=lambda t: (t["t0"] is None,
                                            t["t0"] or 0.0))
    for tix, t in enumerate(ordered):
        tid = tix + 1
        label = str(t.get("request_id") or t["trace_id"])
        for pid in sorted({pid_of[s.get("proc") or "unknown"]
                           for s in t["spans"]}):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": label}})
        for s in t["spans"]:
            events.append({
                "name": s["name"], "ph": "X", "cat": s["component"],
                "pid": pid_of[s.get("proc") or "unknown"], "tid": tid,
                "ts": s["t0"] * 1e6,
                "dur": max(0.0, s["t1"] - s["t0"]) * 1e6,
                "args": {"trace_id": t["trace_id"],
                         "component": s["component"],
                         "amortized_ms": s["amortized_ms"]}})
    return events


def export_chrome_trace(path: str,
                        traces: List[Dict[str, Any]]) -> int:
    """Write the merged fleet timeline; returns the event count."""
    events = chrome_trace_events(traces)
    fsio.atomic_write_bytes(
        path, json.dumps({"traceEvents": events,
                          "displayTimeUnit": "ms"}).encode())
    return len(events)


# -- CLI -------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.requesttrace",
        description="Assemble per-request fleet traces from a run dir.")
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None,
                    help="write traces JSON here "
                         "(default <run_dir>/traces.json)")
    ap.add_argument("--chrome", default=None,
                    help="also write a chrome://tracing timeline here")
    ap.add_argument("--json", action="store_true",
                    help="print the full result as JSON")
    args = ap.parse_args(argv)
    result = assemble_run(args.run_dir)
    verdict = tail_latency_attribution(result["traces"])
    result["tail_latency"] = verdict
    out = args.out or os.path.join(args.run_dir, "traces.json")
    fsio.atomic_write_bytes(out, json.dumps(result, indent=2,
                                            sort_keys=True).encode())
    if args.chrome:
        export_chrome_trace(args.chrome, result["traces"])
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))  # noqa: print
    else:
        for t in result["traces"]:
            lat = ("%8.1fms" % t["latency_ms"]
                   if t["latency_ms"] is not None else "   (open)")
            print(f"{t['request_id'] or t['trace_id']:>12} {lat} "  # noqa: print
                  f"cov={t['coverage']:.2f} "
                  f"procs={','.join(t['procs'])} "
                  f"{t['components']}")
        print(f"{result['complete']}/{len(result['traces'])} complete, "  # noqa: print
              f"{len(result['orphan_spans'])} orphan span ids, "
              f"wal {result['wal_matched']}/{result['wal_streams']}")
        if verdict:
            print(f"tail_latency: dominant={verdict['dominant']} "  # noqa: print
                  f"p99={verdict['p99_ms']:.1f}ms "
                  f"median={verdict['median_ms']:.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
