"""Run doctor: post-run diagnosis of the silent MFU killers.  The
port's own copy of ``paddle_tpu/observability/doctor.py``: the rules are
pure functions of the worker-stream records, the same in both packages.

``python -m paddle_tpu_torch.observability.doctor <run_dir>`` reads everything
a run left behind — the per-worker JSONL timelines under
``<run_dir>/metrics/``, the cross-worker ``summary.json`` (recomputed if
stale/absent), and the supervisor's post-mortem reports — and emits a
ranked ``<run_dir>/diagnosis.json`` plus a human-readable report.

Diagnosis taxonomy (each finding carries a 0–100 severity and concrete
evidence lines):

- ``oom``            — a ``memory.oom`` postmortem record exists; the
                       watermark table names the fullest device.
- ``retrace_storm``  — ``compile.retrace_storm`` records (or a high
                       retrace count) name the function and the argument
                       whose signature churn forced the recompiles.
- ``hbm_creep``      — per-device ``bytes_in_use`` trends upward across
                       ``memory`` samples, or the peak watermark sits
                       near ``bytes_limit``.
- ``straggler``      — cross-worker step-time spread (p50/p99, from
                       :func:`aggregate.straggler_stats`) attributes the
                       consistently slowest worker, with per-worker
                       ``collective.<op>.ms`` evidence from each
                       worker's final ``metrics.snapshot`` record (a
                       straggler computes while its peers wait in the
                       collective).
- ``comm_bound``     — a ``collective.<op>.ms`` histogram's p50 exceeds
                       a configurable fraction (``PTPU_COMM_BOUND_FRAC``,
                       default 0.25) of the p50 step time: the run pays
                       more for moving bytes than the overlap can hide —
                       compress the dp sync or shard the weight update
                       (``distributed/comm``).
- ``comm_budget``    — the interconnect microscope's per-collective
                       sub-budget (bench rows) shows the
                       roofline's exposed-comm bucket dominating the
                       step; the verdict names the dominant (op, axis)
                       and its efficiency vs the ICI cost model.
- ``data_starved``   — data-wait dominates the step-time breakdown.
- ``unstable``       — the supervisor logged rollbacks / watchdog
                       timeouts / step failures (corroborating context,
                       ranked below the causes above).
- ``serve_poisoned`` — the serving engine quarantined request(s)
                       (``serve.quarantine`` records name the step kind
                       and error; durable records land under
                       ``<run_dir>/serve_quarantine/``).
- ``serve_deadline_misses`` — requests were evicted past their
                       deadline: the engine is underprovisioned for its
                       SLO (raise ``max_seqs`` / the KV pool, or shed
                       earlier).
- ``tail_latency``   — request traces name the dominant
                       component of the p99-slowest requests by excess
                       over the fleet-median breakdown (queue vs
                       retry/backoff vs prefill vs decode vs
                       failover-recompute vs preempt-recompute) — the
                       request-centric view of "why is p99 slow".

Verdicts are mirrored into ``supervisor_report.json`` (kind
``doctor.verdict``) so the run's one post-mortem file carries the
diagnosis too.

``check_compilation``, ``check_comm_bound``, ``check_mfu_gap`` and
``check_comm_budget`` read records the port does not emit yet (compile
tracking, collectives, roofline bench rows): on the port's own runs they
stay silent.  The JAX doctor's ``perf_regression`` and ``perf_trend``
rules read the bench's golden rows and ledger series, which the port does
not have yet; they come with the port's bench.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..framework.log import vlog
from ..utils import fsio
from .aggregate import (SCHEMA_VERSION, aggregate_run, read_worker_stream,
                        straggler_stats, _WORKER_RE)
from .registry import split_labels
from .sinks import metrics_dir

#: the interconnect microscope's name for comm time it could not pin to a
#: named collective (``paddle_tpu/observability/interconnect.py``)
UNATTRIBUTED = "(unattributed)"

__all__ = ["diagnose", "render_report", "main", "check_compilation",
           "check_memory", "check_straggler", "check_data_starved",
           "check_comm_bound", "check_supervisor",
           "check_integrity", "check_serving",
           "check_fleet", "check_fleet_flapping",
           "check_fleet_slo_burn", "check_tail_latency",
           "check_mfu_gap", "check_comm_budget"]

# tunables: thresholds a finding must clear before it is reported
RETRACE_WARN = 3            # retraces (not first compiles) per function
HBM_NEAR_LIMIT = 0.92       # peak/limit utilization
HBM_CREEP_FRAC = 0.05       # in_use growth first→last sample, fraction
STRAGGLER_REL_SPREAD = 0.2  # p99 spread / median step time
DATA_STARVED_FRAC = 0.3     # data_ms / step_time_ms
COMM_BOUND_FRAC = 0.25      # collective.<op>.ms p50 / step p50 (override
                            # with PTPU_COMM_BOUND_FRAC)
MFU_GAP_FRAC = 0.25         # dominant roofline gap sink / measured step
                            # (override with PTPU_MFU_GAP_FRAC)


def _finding(kind: str, severity: float, title: str,
             evidence: List[str], **data) -> Dict[str, Any]:
    return {"kind": kind, "severity": int(max(0, min(100, severity))),
            "title": title, "evidence": evidence, "data": data}


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"


def _read_workers(run_dir: str,
                  flight_workers: Optional[List[int]] = None
                  ) -> Dict[int, List[Dict[str, Any]]]:
    """Per-worker timelines: the JSONL streams, plus any crash flight
    bundles folded in — a worker whose stream tail was lost
    (buffered records died with the process) gets the ring the flight
    recorder dumped, deduped against what the stream did land."""
    mdir = metrics_dir(run_dir)
    workers: Dict[int, List[Dict[str, Any]]] = {}
    if os.path.isdir(mdir):
        for name in sorted(os.listdir(mdir)):
            m = _WORKER_RE.match(name)
            if m:
                workers[int(m.group(1))] = read_worker_stream(
                    os.path.join(mdir, name))
    from .flight import read_flight_bundles
    for wid, bundle in read_flight_bundles(run_dir).items():
        recs = [r for r in bundle.get("records", [])
                if isinstance(r, dict)]
        if not recs:
            continue
        stream = workers.setdefault(wid, [])
        seen = {(r.get("ts"), r.get("kind")) for r in stream}
        fresh = [r for r in recs
                 if (r.get("ts"), r.get("kind")) not in seen]
        if fresh:
            stream.extend(fresh)
            stream.sort(key=lambda r: r.get("ts") or 0.0)
            if flight_workers is not None:
                flight_workers.append(wid)
            vlog(1, "doctor: worker %d — %d records recovered from the "
                 "flight bundle", wid, len(fresh))
    return workers


def _read_supervisor_events(run_dir: str) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for name in ("supervisor_report.json", "launcher_report.json"):
        path = os.path.join(run_dir, name)
        try:
            payload = json.loads(fsio.read_bytes(path))
        except (OSError, ValueError):
            continue
        for e in payload.get("events", []):
            if isinstance(e, dict):
                events.append({**e, "_source": name})
    return events


# -- checks (each returns a list of findings) ------------------------------
def check_compilation(workers) -> List[Dict[str, Any]]:
    findings = []
    storms: Dict[str, Dict[str, Any]] = {}
    retraces: Dict[str, int] = {}
    culprit_freq: Dict[str, Dict[str, int]] = {}
    for wid, records in workers.items():
        for r in records:
            if r.get("kind") == "compile.retrace_storm":
                fn = str(r.get("function"))
                storms.setdefault(fn, {"count": 0, "worker": wid,
                                       "culprit": r.get("culprit")})
                storms[fn]["count"] += 1
                if r.get("culprit"):
                    storms[fn]["culprit"] = r["culprit"]
            elif r.get("kind") == "compile" and r.get("retrace"):
                fn = str(r.get("function"))
                retraces[fn] = retraces.get(fn, 0) + 1
                for c in r.get("changed") or []:
                    freq = culprit_freq.setdefault(fn, {})
                    freq[c["arg"]] = freq.get(c["arg"], 0) + 1
    for fn, info in storms.items():
        n = retraces.get(fn, info["count"])
        culprit = info["culprit"]
        if not culprit and culprit_freq.get(fn):
            culprit = max(culprit_freq[fn], key=culprit_freq[fn].get)
        detail = _culprit_detail(workers, fn, culprit)
        ev = [f"{info['count']} retrace storm(s) on {fn} "
              f"({n} retraces total)",
              f"offending argument: {culprit!r}"
              + (f" — {detail}" if detail else "")]
        findings.append(_finding(
            "retrace_storm", 60 + 10 * min(3, info["count"]),
            f"retrace storm in {fn} driven by argument {culprit!r}",
            ev, function=fn, retraces=n, storms=info["count"],
            argument=culprit))
    for fn, n in retraces.items():
        if fn in storms or n < RETRACE_WARN:
            continue
        culprit = (max(culprit_freq[fn], key=culprit_freq[fn].get)
                   if culprit_freq.get(fn) else None)
        findings.append(_finding(
            "retrace_storm", 40 + 5 * min(6, n),
            f"{n} retraces of {fn} (most-changed argument {culprit!r})",
            [f"{n} retraces beyond the first compile",
             f"signature churn concentrated in {culprit!r}"],
            function=fn, retraces=n, storms=0, argument=culprit))
    return findings


def _culprit_detail(workers, fn: str, culprit) -> Optional[str]:
    """One concrete shape transition for the evidence line."""
    if culprit is None:
        return None
    for records in workers.values():
        for r in records:
            if r.get("kind") != "compile" or r.get("function") != fn:
                continue
            for c in r.get("changed") or []:
                if c["arg"] == culprit and c.get("detail"):
                    return c["detail"]
    return None


def check_memory(workers) -> List[Dict[str, Any]]:
    findings = []
    series: Dict[str, List[Dict[str, Any]]] = {}
    oom: Optional[Dict[str, Any]] = None
    for records in workers.values():
        for r in records:
            if r.get("kind") == "memory":
                for dev, row in (r.get("devices") or {}).items():
                    series.setdefault(dev, []).append(row)
            elif r.get("kind") == "memory.oom":
                oom = r
    if oom is not None:
        devices = oom.get("devices") or {}
        fullest = max(devices,
                      key=lambda d: devices[d].get("utilization", 0),
                      default=None)
        ev = [f"memory.oom postmortem at step {oom.get('step')}: "
              f"{oom.get('error') or 'allocator error'}"]
        if fullest:
            row = devices[fullest]
            ev.append(
                f"fullest device {fullest}: "
                f"{_fmt_bytes(row.get('bytes_in_use', 0))} in use / "
                f"{_fmt_bytes(row.get('bytes_limit', 0))} limit "
                f"(peak {_fmt_bytes(row.get('peak_bytes_in_use', 0))})")
        findings.append(_finding(
            "oom", 95, f"device OOM (fullest device: {fullest})", ev,
            step=oom.get("step"), device=fullest))
    for dev, rows in series.items():
        in_use = [r["bytes_in_use"] for r in rows if "bytes_in_use" in r]
        limit = next((r["bytes_limit"] for r in rows
                      if r.get("bytes_limit")), None)
        peak = max((r.get("peak_bytes_in_use", 0) for r in rows),
                   default=0)
        if limit and peak / limit >= HBM_NEAR_LIMIT:
            findings.append(_finding(
                "hbm_creep", 70 + 20 * min(1.0, peak / limit - 0.9) / 0.1,
                f"HBM watermark near limit on {dev}",
                [f"peak {_fmt_bytes(peak)} of {_fmt_bytes(limit)} limit "
                 f"({peak / limit:.1%})"],
                device=dev, peak=peak, limit=limit))
        elif len(in_use) >= 3 and in_use[0] > 0:
            growth = (in_use[-1] - in_use[0]) / in_use[0]
            # monotone-ish creep, not one transient spike
            rising = sum(b >= a for a, b in zip(in_use, in_use[1:]))
            if growth >= HBM_CREEP_FRAC and rising >= 0.7 * (len(in_use) - 1):
                findings.append(_finding(
                    "hbm_creep", 35 + 100 * min(0.4, growth),
                    f"HBM usage creeping on {dev} (+{growth:.1%})",
                    [f"bytes_in_use {_fmt_bytes(in_use[0])} → "
                     f"{_fmt_bytes(in_use[-1])} across "
                     f"{len(in_use)} samples"],
                    device=dev, growth=growth, samples=len(in_use)))
    return findings


def _collective_skew_evidence(workers, straggler: int) -> List[str]:
    """Compare per-worker collective histograms from the final
    ``metrics.snapshot`` records: a straggler shows *less* collective
    wait than its peers (they wait for it)."""
    per_worker: Dict[int, Dict[str, float]] = {}
    for wid, records in workers.items():
        snap = next((r for r in reversed(records)
                     if r.get("kind") == "metrics.snapshot"), None)
        if not snap:
            continue
        # aggregate across the label family  so one op's wait is not
        # split across its axes — sum the sums, sum the counts
        sums: Dict[str, List[float]] = {}
        for name, m in (snap.get("snapshot") or {}).items():
            base, _labels = split_labels(name)
            if (base.startswith("collective.") and base.endswith(".ms")
                    and isinstance(m, dict) and m.get("count")):
                agg = sums.setdefault(base, [0.0, 0.0])
                agg[0] += float(m.get("sum") or 0.0)
                agg[1] += float(m["count"])
        per_worker[wid] = {op: s / c for op, (s, c) in sums.items() if c}
    if len(per_worker) < 2:
        return []
    ev = []
    ops = sorted({op for d in per_worker.values() for op in d})
    best_op, best_gap = None, 0.0
    for op in ops:
        vals = {w: d[op] for w, d in per_worker.items() if op in d}
        if straggler not in vals or len(vals) < 2:
            continue
        others = [v for w, v in vals.items() if w != straggler]
        gap = (sum(others) / len(others)) - vals[straggler]
        if gap > best_gap:
            best_op, best_gap = op, gap
    if best_op is not None and best_gap > 0:
        op_label = best_op[len("collective."):-len(".ms")]
        ev.append(
            f"peers wait in {op_label}: mean {best_gap:.1f}ms longer "
            f"than worker {straggler} (the straggler computes while "
            f"the fleet blocks)")
    return ev


def check_straggler(workers, summary=None) -> List[Dict[str, Any]]:
    stats = (summary or {}).get("straggler") or straggler_stats(workers)
    if not stats:
        return []
    rel = (stats.get("relative_spread") or {}).get("p99")
    if rel is None or rel < STRAGGLER_REL_SPREAD:
        return []
    wid = stats["straggler"]
    frac = stats["straggler_fraction"]
    means = stats.get("worker_mean_step_ms") or {}
    ev = [f"p99 cross-worker step spread "
          f"{stats['spread_ms']['p99']:.1f}ms = {rel:.0%} of the "
          f"median step ({stats['median_step_ms']:.1f}ms) across "
          f"{stats['aligned_steps']} aligned steps",
          f"worker {wid} slowest on {frac:.0%} of aligned steps"]
    if means:
        ev.append("mean step ms per worker: " + ", ".join(
            f"w{w}={m:.1f}" for w, m in sorted(means.items())))
    ev += _collective_skew_evidence(workers, wid)
    sev = 50 + 40 * min(1.0, rel) * frac
    return [_finding(
        "straggler", sev,
        f"worker {wid} is a straggler ({frac:.0%} of steps, "
        f"p99 spread {rel:.0%} of step time)",
        ev, worker=wid, fraction=frac, relative_spread_p99=rel,
        spread_ms=stats["spread_ms"])]


def check_data_starved(workers) -> List[Dict[str, Any]]:
    data_ms, step_ms = [], []
    for records in workers.values():
        for r in records:
            if r.get("kind") == "step" and r.get("step_time_ms"):
                step_ms.append(float(r["step_time_ms"]))
                data_ms.append(float(r.get("data_ms") or 0.0))
    if len(step_ms) < 3:
        return []
    frac = sum(data_ms) / max(1e-9, sum(step_ms))
    if frac < DATA_STARVED_FRAC:
        return []
    return [_finding(
        "data_starved", 30 + 50 * min(1.0, frac),
        f"data pipeline starving the device ({frac:.0%} of step time)",
        [f"data-wait is {frac:.0%} of total step time across "
         f"{len(step_ms)} steps"], fraction=frac)]


def check_comm_bound(workers, frac: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
    """a collective whose p50 latency eats more than ``frac``
    of the p50 step time makes the run *communication-bound*.  Works on
    any window of records (live monitor included): step p50 comes from
    ``step`` records in the window, falling back to the ``step.time_ms``
    histogram in the final ``metrics.snapshot``; collective p50s come
    from the snapshot's ``collective.<op>.ms`` histograms."""
    if frac is None:
        frac = float(os.environ.get("PTPU_COMM_BOUND_FRAC",
                                    COMM_BOUND_FRAC))
    findings = []
    worst: Dict[str, Dict[str, Any]] = {}
    for wid, records in workers.items():
        step_ms = sorted(float(r["step_time_ms"]) for r in records
                         if r.get("kind") == "step"
                         and r.get("step_time_ms"))
        snap = next((r for r in reversed(records)
                     if r.get("kind") == "metrics.snapshot"), None)
        snapshot = (snap or {}).get("snapshot") or {}
        step_p50 = (step_ms[len(step_ms) // 2] if step_ms
                    else (snapshot.get("step.time_ms") or {}).get("p50"))
        if not step_p50:
            continue
        for name, m in snapshot.items():
            # accept both the labeled family
            # (collective.<op>.ms[axis=..,n=..]) and the legacy
            # unlabeled name; each family member is judged on its own
            # p50 and only the worst per op is kept, so labels never
            # double-count an op's wait
            base, labels = split_labels(name)
            if not (base.startswith("collective.") and base.endswith(".ms")
                    and isinstance(m, dict) and m.get("count")):
                continue
            p50 = m.get("p50")
            if p50 is None or p50 < frac * step_p50:
                continue
            op = base[len("collective."):-len(".ms")]
            cur = worst.get(op)
            if cur is None or p50 / step_p50 > cur["ratio"]:
                worst[op] = {"worker": wid, "p50_ms": p50,
                             "step_p50_ms": step_p50,
                             "ratio": p50 / step_p50,
                             "count": int(m["count"]),
                             "axis": labels.get("axis")}
    for op, info in sorted(worst.items(), key=lambda kv: -kv[1]["ratio"]):
        axis_note = (f" on axis {info['axis']}" if info.get("axis")
                     else "")
        findings.append(_finding(
            "comm_bound", 45 + 45 * min(1.0, info["ratio"]),
            f"communication-bound: {op} p50 is {info['ratio']:.0%} of "
            f"the step time" + axis_note,
            [f"collective.{op}.ms p50 {info['p50_ms']:.1f}ms vs step "
             f"p50 {info['step_p50_ms']:.1f}ms on worker "
             f"{info['worker']} ({info['count']} calls; threshold "
             f"{frac:.0%})",
             "compress the dp gradient sync (CommConfig dtype=int8/"
             "bfloat16) or shard the weight update (ShardedOptimizer) — "
             "see docs/ARCHITECTURE.md 'Communication'"],
            op=op, **{k: v for k, v in info.items() if k != "op"}))
    return findings


def check_supervisor(events) -> List[Dict[str, Any]]:
    if not events:
        return []
    counts: Dict[str, int] = {}
    for e in events:
        k = str(e.get("kind"))
        counts[k] = counts.get(k, 0) + 1
    bad = {k: v for k, v in counts.items()
           if k in ("rollback", "watchdog_timeout", "step_failure",
                    "guard_rollback", "worker_lost", "budget_exhausted")}
    if not bad:
        return []
    total = sum(bad.values())
    ev = [f"{v}× {k}" for k, v in sorted(bad.items())]
    return [_finding(
        "unstable", 25 + 5 * min(10, total),
        "supervisor intervened during the run",
        ev, events=bad)]


def check_integrity(events) -> List[Dict[str, Any]]:
    """State-integrity verdicts: ``desync`` when replicas
    voted a digest mismatch, ``sdc_suspect`` when a replay audit pinned
    the damage outside the computed path (hardware SDC signature)."""
    findings: List[Dict[str, Any]] = []
    desyncs = [e for e in events if e.get("kind") == "integrity.desync"]
    audits = [e for e in events if e.get("kind") == "integrity.audit"]
    heals = [e for e in events if e.get("kind") == "integrity.heal"]
    sdc = [e for e in audits if e.get("verdict") == "sdc_suspect"]
    nondet = [e for e in audits if e.get("verdict") == "nondeterminism"]
    if sdc:
        ev = [f"replay audit at step {e.get('step')}: replays agree "
              f"({e.get('replay')}) but live state reads {e.get('live')} "
              "— damaged outside the computed path" for e in sdc[:4]]
        ev.append("suspect the device: re-run the burn-in "
                  "(tools/burnin), cordon the host if it reproduces")
        findings.append(_finding(
            "sdc_suspect", 80 + 5 * min(4, len(sdc)),
            f"{len(sdc)} replay audit(s) indict silent data corruption",
            ev, audits=len(sdc)))
    if desyncs:
        suspects: Dict[str, int] = {}
        for e in desyncs:
            for w in (e.get("suspects") or []):
                suspects[str(w)] = suspects.get(str(w), 0) + 1
        healed: Dict[str, int] = {}
        for h in heals:
            a = str(h.get("action"))
            healed[a] = healed.get(a, 0) + 1
        ev = [f"{len(desyncs)}× digest mismatch across replicas "
              f"(steps {sorted(set(e.get('step') for e in desyncs))})"]
        if suspects:
            ev.append("suspect worker(s) by majority vote: " + ", ".join(
                f"worker {w} ({n}×)" for w, n in sorted(suspects.items())))
        if any(e.get("ambiguous") for e in desyncs):
            ev.append("at least one split had no majority (ambiguous) — "
                      "both sides were rolled back")
        if nondet:
            ev.append(f"{len(nondet)} replay audit(s) reproduced "
                      "DIFFERENT digests from identical inputs — "
                      "software nondeterminism, not hardware")
        if healed:
            ev.append("healing actions: " + ", ".join(
                f"{n}× {a}" for a, n in sorted(healed.items())))
        findings.append(_finding(
            "desync", 60 + 5 * min(6, len(desyncs)),
            "replica state digests diverged during the run",
            ev, count=len(desyncs), suspects=suspects))
    return findings


def check_serving(workers) -> List[Dict[str, Any]]:
    """Serving-resilience verdicts: ``serve_poisoned`` when
    the engine quarantined requests (each left a ``serve.quarantine``
    timeline record naming the step kind and error), and
    ``serve_deadline_misses`` when requests were evicted past their
    deadline — sustained misses mean the engine is underprovisioned for
    its SLO, not that requests are broken."""
    findings: List[Dict[str, Any]] = []
    quarantines: List[Dict[str, Any]] = []
    misses: List[Dict[str, Any]] = []
    for recs in workers.values():
        for r in recs:
            k = r.get("kind")
            if k == "serve.quarantine":
                quarantines.append(r)
            elif k == "serve.deadline_miss":
                misses.append(r)
    if quarantines:
        errors: Dict[str, int] = {}
        for q in quarantines:
            e = str(q.get("error"))
            errors[e] = errors.get(e, 0) + 1
        ev = [f"{q.get('request_id')}: {q.get('step_kind')} step — "
              f"{q.get('error')}" for q in quarantines[:4]]
        ev.append("durable records under "
                  "<run_dir>/serve/replica-<i>/quarantine/; every "
                  "co-batched request completed token-exact")
        findings.append(_finding(
            "serve_poisoned", 55 + 5 * min(6, len(quarantines)),
            f"{len(quarantines)} request(s) quarantined as poisoned",
            ev, count=len(quarantines), errors=errors))
    if misses:
        ttft = sum(1 for m in misses if m.get("miss") == "ttft")
        ev = [f"{len(misses)}× deadline eviction "
              f"({ttft} before first token)"]
        ev.append("requests: " + ", ".join(
            str(m.get("request_id")) for m in misses[:6]))
        ev.append("sustained misses = engine underprovisioned for the "
                  "SLO: raise max_seqs / the KV pool, or shed earlier")
        findings.append(_finding(
            "serve_deadline_misses", 30 + 5 * min(8, len(misses)),
            f"{len(misses)} request(s) evicted past their deadline",
            ev, count=len(misses), ttft_misses=ttft))
    return findings


def check_fleet(workers) -> List[Dict[str, Any]]:
    """Serving-fleet verdict: ``fleet_failover`` when the
    router re-homed live streams off a dead replica.  Failover itself
    is the system WORKING — clients saw nothing — but a replica died,
    and dying replicas are the thing to fix, so the verdict names the
    dead replicas and how many streams each failover moved."""
    findings: List[Dict[str, Any]] = []
    failovers: List[Dict[str, Any]] = []
    deaths: List[Dict[str, Any]] = []
    for recs in workers.values():
        for r in recs:
            k = r.get("kind")
            if k == "fleet.failover":
                failovers.append(r)
            elif (k == "fleet.replica_state"
                  and r.get("state") == "dead"):
                deaths.append(r)
    if not failovers:
        return findings
    by_replica: Dict[str, int] = {}
    for f in failovers:
        src = str(f.get("from_replica"))
        by_replica[src] = by_replica.get(src, 0) + 1
    ev = [f"{f.get('request_id')}: replica {f.get('from_replica')} -> "
          f"{f.get('to_replica')} ({f.get('why')}, "
          f"{f.get('accepted_tokens')} tokens journaled)"
          for f in failovers[:4]]
    ev.append("streams re-entered via the recompute-prefill path — "
              "completions stay token-exact (journaled prompt + "
              "accepted tokens re-admitted as pending tail)")
    if deaths:
        ev.append("replica deaths observed: " + ", ".join(
            f"replica {d.get('replica')}" for d in deaths[:6]))
    findings.append(_finding(
        "fleet_failover", 50 + 5 * min(6, len(failovers)),
        f"{len(failovers)} stream failover(s) off dead replica(s) "
        f"{sorted(by_replica)}",
        ev, count=len(failovers), by_replica=by_replica,
        deaths=len(deaths)))
    return findings


def check_fleet_flapping(workers) -> List[Dict[str, Any]]:
    """Flap verdict: ``fleet_flapping`` when a replica's
    circuit breaker tripped — the replica is alive by census but its
    transport fails intermittently.  The verdict names each flapping
    replica with its trip count, and escalates when the retry budget
    had to shed or defer work (the storm the breaker exists to
    prevent was actually knocking)."""
    findings: List[Dict[str, Any]] = []
    trips: Dict[str, int] = {}
    reopened: Dict[str, int] = {}
    budget_sheds = 0
    deferred = 0
    for recs in workers.values():
        for r in recs:
            k = r.get("kind")
            if k == "fleet.breaker" and r.get("state") == "open":
                rep = str(r.get("replica"))
                trips[rep] = trips.get(rep, 0) + 1
                if r.get("prev") == "half_open":
                    reopened[rep] = reopened.get(rep, 0) + 1
            elif k == "fleet.shed" and r.get("why") == "retry_budget":
                budget_sheds += 1
            elif k == "fleet.deferred":
                deferred += 1
    if not trips:
        return findings
    total = sum(trips.values())
    ev = [f"replica {rep}: breaker opened {n}× "
          + (f"({reopened[rep]}× from a failed half-open probe)"
             if rep in reopened else "(first trip)")
          for rep, n in sorted(trips.items())]
    ev.append("flapping ≠ dead: the replica answers /healthz but its "
              "transport fails intermittently — check its host before "
              "restarting it")
    if budget_sheds or deferred:
        ev.append(f"retry-budget pressure: {budget_sheds} submission(s) "
                  f"degraded to load-shed, {deferred} failover "
                  f"re-dispatch(es) deferred — the fleet was absorbing "
                  f"a retry storm")
    findings.append(_finding(
        "fleet_flapping",
        45 + 5 * min(5, total) + (10 if budget_sheds else 0),
        f"replica(s) {sorted(trips)} flapping "
        f"({total} breaker trip(s))",
        ev, trips=trips, reopened=reopened,
        budget_sheds=budget_sheds, deferred=deferred))
    return findings


def check_fleet_slo_burn(workers) -> List[Dict[str, Any]]:
    """Autoscaler verdict: ``fleet_slo_burn`` when the SLO
    burn-rate loop had to act.  Scale-ups that stayed under the
    ceiling are the system working (low severity, still worth a row —
    capacity was bought); ``blocked_at_max`` is the one operators page
    on: the SLO kept burning and the autoscaler had nothing left to
    give."""
    findings: List[Dict[str, Any]] = []
    ups: List[Dict[str, Any]] = []
    blocked: List[Dict[str, Any]] = []
    for recs in workers.values():
        for r in recs:
            if r.get("kind") != "fleet.autoscale":
                continue
            if r.get("action") == "up":
                ups.append(r)
            elif r.get("action") == "blocked_at_max":
                blocked.append(r)
    if not ups and not blocked:
        return findings
    ev = [f"scale-up to {u.get('target')} replicas "
          f"(burn {u.get('burn')}): {u.get('why')}" for u in ups[:4]]
    ev += [f"BLOCKED at {b.get('replicas')} replicas "
           f"(burn {b.get('burn')}): {b.get('why')}"
           for b in blocked[:4]]
    if blocked:
        ev.append("the fleet hit PTPU_FLEET_MAX while the SLO still "
                  "burned — raise the ceiling or shed earlier")
    findings.append(_finding(
        "fleet_slo_burn",
        (70 + 5 * min(4, len(blocked))) if blocked
        else 20 + 5 * min(4, len(ups)),
        (f"SLO burn exhausted the fleet ceiling "
         f"({len(blocked)} blocked-at-max event(s))") if blocked
        else f"SLO burn drove {len(ups)} scale-up(s)",
        ev, scale_ups=len(ups), blocked_at_max=len(blocked)))
    return findings


def check_tail_latency(workers) -> List[Dict[str, Any]]:
    """Request-trace verdict: assemble every ``trace.*``
    record in the window into per-request waterfalls and name the
    dominant component of the p99-slowest ones.  Severity scales with
    how far the tail sits above the median — a tail that is just the
    median again is healthy dispersion, not a finding."""
    from .requesttrace import TraceAssembler, tail_latency_attribution
    merged: List[Dict[str, Any]] = []
    for recs in workers.values():
        merged.extend(r for r in recs
                      if str(r.get("kind", "")).startswith("trace."))
    if not merged:
        return []
    result = TraceAssembler().from_records(merged)
    att = tail_latency_attribution(result["traces"])
    if att is None:
        return []
    p99, med = att["p99_ms"], att["median_ms"]
    ratio = p99 / med if med > 0 else 1.0
    if ratio < 1.2:
        return []                     # flat tail — nothing to attribute
    dom = att["dominant"]
    worst = att["slow"][0] if att["slow"] else {}
    ev = [f"p99 {p99:.1f}ms vs median {med:.1f}ms ({ratio:.1f}x) over "
          f"{result['complete']} complete trace(s)",
          f"dominant excess component: {dom} "
          f"(+{att['excess'].get(dom, 0.0):.1f}ms over the median "
          f"breakdown across the slow set)"]
    if worst:
        ev.append(f"slowest: {worst.get('request_id')} "
                  f"{worst.get('latency_ms'):.1f}ms, breakdown "
                  f"{worst.get('components')}")
    ev.append("waterfalls: python -m "
              "paddle_tpu_torch.observability.requesttrace <run_dir>")
    return [_finding(
        "tail_latency", 30 + 30 * min(1.0, (ratio - 1.2) / 3.0),
        f"p99 latency dominated by {dom} ({ratio:.1f}x the median)",
        ev, dominant=dom, p99_ms=p99, median_ms=med,
        excess=att["excess"], slow=att["slow"][:4],
        orphan_spans=len(result["orphan_spans"]))]


def check_mfu_gap(workers) -> List[Dict[str, Any]]:
    """MFU-microscope verdict: ``bench.row`` records carry a
    slim roofline gap budget; when one named sink eats more than
    ``PTPU_MFU_GAP_FRAC`` (default 0.25) of the measured step, the doctor
    names it.  ``unknown_device`` and ``residual`` get honest wording —
    they mean the microscope could not attribute, not that the step is
    fine.  A synthetic drill row (``injected``) is flagged as such so the
    CI assertion and a human reading the report both see it is staged."""
    frac = float(os.environ.get("PTPU_MFU_GAP_FRAC", MFU_GAP_FRAC))
    newest: Dict[str, Dict[str, Any]] = {}
    for records in workers.values():
        for r in records:
            if r.get("kind") != "bench.row":
                continue
            roof = r.get("roofline")
            if not isinstance(roof, dict) or not isinstance(
                    roof.get("buckets_ms"), dict):
                continue
            name = str(r.get("scenario"))
            prev = newest.get(name)
            if prev is None or (r.get("ts") or 0) >= (prev.get("ts") or 0):
                newest[name] = r
    findings = []
    for name in sorted(newest):
        r = newest[name]
        roof = r["roofline"]
        buckets = roof["buckets_ms"]
        measured = float(roof.get("measured_step_ms") or 0.0)
        if measured <= 0:
            continue
        dom = roof.get("dominant_sink")
        dom_ms = float(buckets.get(dom, 0.0) or 0.0) if dom else 0.0
        share = dom_ms / measured
        if dom is None or dom == "mxu" or share <= frac:
            continue
        cov = roof.get("coverage")
        if dom == "unknown_device":
            what = ("device kind is not in the roofline table — the "
                    "whole compute phase is unattributable (fix: add "
                    "the device to observability.mfu.DEVICE_SPECS)")
        elif dom == "residual":
            what = ("time the roofline model cannot explain — treat "
                    "the rest of this budget as a lower bound, not a "
                    "diagnosis")
        else:
            what = {
                "memory_bound": "HBM-bandwidth-bound ops dominate — the "
                                "MXU is waiting on memory",
                "comm": "exposed (unoverlapped) collectives dominate",
                "host": "host-side data/readback gaps dominate",
                "padding": "batch/sequence padding burns the largest "
                           "share of compute",
            }.get(dom, dom)
        ev = [f"dominant gap sink: {dom} {dom_ms:.2f}ms of "
              f"{measured:.2f}ms measured ({share:.0%}, threshold "
              f"{frac:.0%})",
              "buckets: " + ", ".join(
                  f"{k}={float(v or 0.0):.2f}ms"
                  for k, v in buckets.items())]
        if cov is not None:
            ev.append(f"model coverage {float(cov):.0%} "
                      "(1 - |residual|/measured)")
        if roof.get("injected"):
            ev.append("NOTE: synthetic drill — this gap was injected "
                      "via PTPU_ROOFLINE_TEST_INFLATE")
        ev.append("full budget: python -m "
                  "paddle_tpu.observability.roofline")
        findings.append(_finding(
            "mfu_gap", 25 + 40 * min(1.0, (share - frac) / 0.5),
            f"{name}: MFU gap dominated by {dom} "
            f"({share:.0%} of the step) — {what}",
            ev, scenario=name, dominant=dom, share=share,
            measured_step_ms=measured, coverage=cov,
            injected=bool(roof.get("injected")),
            mfu=r.get("mfu")))
    return findings


def check_comm_budget(workers, frac: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
    """Interconnect-microscope verdict: ``bench.row`` records
    carry a slim per-collective sub-budget of the roofline's exposed-comm
    bucket.  When that bucket eats more than ``PTPU_COMM_BOUND_FRAC``
    (default 0.25) of the measured step — or a synthetic drill entry was
    injected — the doctor names the dominant (op, axis) and its
    efficiency vs the ICI cost model.  When ``(unattributed)`` holds the
    largest share the wording is honest: the microscope saw exposed comm
    time it could not pin to a named collective (trace-time observation
    sees jitted collectives once per trace, not per step)."""
    if frac is None:
        frac = float(os.environ.get("PTPU_COMM_BOUND_FRAC",
                                    COMM_BOUND_FRAC))
    newest: Dict[str, Dict[str, Any]] = {}
    for records in workers.values():
        for r in records:
            if r.get("kind") != "bench.row":
                continue
            ic = r.get("interconnect")
            if not isinstance(ic, dict) or not isinstance(
                    ic.get("entries"), list):
                continue
            name = str(r.get("scenario"))
            prev = newest.get(name)
            if prev is None or (r.get("ts") or 0) >= (prev.get("ts") or 0):
                newest[name] = r
    findings = []
    for name in sorted(newest):
        r = newest[name]
        ic = r["interconnect"]
        roof = r.get("roofline") or {}
        measured = float(roof.get("measured_step_ms") or 0.0)
        bucket = float(ic.get("comm_bucket_ms") or 0.0)
        injected = ic.get("injected")
        share = bucket / measured if measured > 0 else 0.0
        if not injected and (measured <= 0 or share <= frac):
            continue
        entries = [e for e in ic["entries"]
                   if isinstance(e, dict) and e.get("op")]
        attributed = [e for e in entries if e["op"] != UNATTRIBUTED]
        unatt = next((float(e.get("measured_ms") or 0.0) for e in entries
                      if e["op"] == UNATTRIBUTED), 0.0)
        dom = max(attributed,
                  key=lambda e: float(e.get("measured_ms") or 0.0),
                  default=None)
        dom_ms = float(dom.get("measured_ms") or 0.0) if dom else 0.0
        ev = [f"exposed-comm bucket {bucket:.2f}ms of {measured:.2f}ms "
              f"measured ({share:.0%}, threshold {frac:.0%})"]
        if dom is not None and dom_ms >= unatt and dom_ms > 0:
            op = dom["op"]
            axis = dom.get("axis") or "?"
            eff = dom.get("efficiency")
            what = f"{op}[axis={axis}]"
            line = (f"dominant collective: {what} {dom_ms:.2f}ms "
                    f"({dom.get('participants') or '?'} participants)")
            if isinstance(dom.get("modeled_ms"), (int, float)):
                line += f", ICI-modeled wire time {dom['modeled_ms']:.3f}ms"
            if isinstance(eff, (int, float)):
                line += f", efficiency vs modeled {eff:.0%}"
            ev.append(line)
            data_op, data_axis, data_eff = op, dom.get("axis"), eff
        else:
            what = UNATTRIBUTED
            ev.append(
                f"largest share is {UNATTRIBUTED} ({unatt:.2f}ms): comm "
                "time the per-collective counters did not capture — a "
                "lower bound on the exposed collectives, not a diagnosis")
            data_op, data_axis, data_eff = UNATTRIBUTED, None, None
        if isinstance(ic.get("overlapped_ms"), (int, float)):
            ev.append(f"estimated overlapped (hidden) comm: "
                      f"{ic['overlapped_ms']:.2f}ms")
        if injected:
            ev.append("NOTE: synthetic drill — this entry was injected "
                      "via PTPU_INTERCONNECT_TEST_INFLATE")
        ev.append("full sub-budget: python -m "
                  "paddle_tpu.observability.interconnect")
        findings.append(_finding(
            "comm_budget",
            25 + 40 * min(1.0, max(0.0, share - frac) / 0.5),
            f"{name}: exposed comm dominated by {what} "
            f"({share:.0%} of the step)",
            ev, scenario=name, op=data_op, axis=data_axis,
            efficiency=data_eff, share=share, comm_bucket_ms=bucket,
            unattributed_ms=unatt, injected=injected,
            degraded=bool(ic.get("degraded"))))
    return findings


def diagnose(run_dir: str, write: bool = True) -> Optional[Dict[str, Any]]:
    """Run every check against ``run_dir``; returns the diagnosis dict
    (findings ranked most-severe first) or ``None`` when the run left no
    telemetry at all.  ``write=True`` also lands
    ``<run_dir>/diagnosis.json`` (atomic) and mirrors the verdicts into
    the supervisor report."""
    flight_workers: List[int] = []
    workers = _read_workers(run_dir, flight_workers=flight_workers)
    if not workers:
        return None
    # the cross-worker summary: reuse a fresh one, else recompute.  It is
    # built from the JSONL streams only — when flight bundles recovered a
    # lost tail, the in-memory `workers` view is the richer one, so the
    # checks below get that and the summary only seeds straggler stats.
    summary = aggregate_run(run_dir)
    if flight_workers:
        summary = None  # recompute skew over the recovered timelines
    events = _read_supervisor_events(run_dir)
    findings: List[Dict[str, Any]] = []
    findings += check_memory(workers)           # oom outranks everything
    findings += check_compilation(workers)
    findings += check_straggler(workers, summary)
    findings += check_data_starved(workers)
    findings += check_comm_bound(workers)
    findings += check_integrity(events)
    findings += check_serving(workers)
    findings += check_fleet(workers)
    findings += check_fleet_flapping(workers)
    findings += check_fleet_slo_burn(workers)
    findings += check_tail_latency(workers)
    findings += check_mfu_gap(workers)
    findings += check_comm_budget(workers)
    findings += check_supervisor(events)
    findings.sort(key=lambda f: (-f["severity"], f["kind"]))
    diagnosis = {
        "schema_version": SCHEMA_VERSION,
        "run_dir": os.path.abspath(run_dir),
        "workers": sorted(workers),
        "flight_workers": sorted(flight_workers),
        "records": sum(len(r) for r in workers.values()),
        "supervisor_events": len(events),
        "healthy": not findings,
        "findings": findings,
    }
    if write:
        fsio.atomic_write_bytes(
            os.path.join(run_dir, "diagnosis.json"),
            json.dumps(diagnosis, indent=1, default=str).encode("utf-8"))
        _mirror_to_supervisor(run_dir, findings)
    return diagnosis


def _mirror_to_supervisor(run_dir: str,
                          findings: List[Dict[str, Any]]) -> None:
    """Append one ``doctor.verdict`` event per finding to the run's
    supervisor report, so the post-mortem file carries the diagnosis."""
    path = os.path.join(run_dir, "supervisor_report.json")
    if not os.path.exists(path):
        return
    try:
        from ..supervisor.report import SupervisorReport
        report = SupervisorReport.load(path)
        for f in findings:
            report.record("doctor.verdict", verdict=f["kind"],
                          severity=f["severity"], title=f["title"])
        if not findings:
            report.record("doctor.verdict", verdict="healthy",
                          severity=0, title="no findings")
    except (OSError, ValueError, KeyError) as e:
        vlog(0, "doctor: could not mirror verdicts into %s: %s", path, e)


def render_report(diagnosis: Dict[str, Any]) -> str:
    """The human-readable half of the diagnosis."""
    lines = [f"run doctor — {diagnosis['run_dir']}",
             f"workers: {len(diagnosis['workers'])}, "
             f"records: {diagnosis['records']}, "
             f"supervisor events: {diagnosis['supervisor_events']}"]
    if diagnosis.get("flight_workers"):
        lines.append(
            "flight-recorder evidence recovered for worker(s): "
            + ", ".join(str(w) for w in diagnosis["flight_workers"]))
    if diagnosis["healthy"]:
        lines.append("no findings — the run looks healthy.")
        return "\n".join(lines)
    lines.append(f"{len(diagnosis['findings'])} finding(s), "
                 "most severe first:")
    for i, f in enumerate(diagnosis["findings"], 1):
        lines.append(f"  {i}. [{f['severity']:3d}] {f['kind']}: "
                     f"{f['title']}")
        for ev in f["evidence"]:
            lines.append(f"       - {ev}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    if len(args) != 1:
        print("usage: python -m paddle_tpu_torch.observability.doctor "  # noqa: print
              "[--json] <run_dir>", file=sys.stderr)
        return 2
    diagnosis = diagnose(args[0])
    if diagnosis is None:
        print(f"no telemetry under {args[0]} — nothing to "  # noqa: print
              "diagnose", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(diagnosis, indent=1, default=str))  # noqa: print
    else:
        print(render_report(diagnosis))  # noqa: print
    return 0


if __name__ == "__main__":
    sys.exit(main())
