"""Serving-fleet drills: a replica fleet behind the router, killed,
upgraded, crashed and autoscaled under load, with token-exactness proved
against an uninterrupted single-engine reference.  The port's
counterpart of ``examples/serve_fleet.py``.

    python -m paddle_tpu_torch.inference.fleet.drills --sigkill_drill
        spawn 2 engine workers, push concurrent streams, SIGKILL one
        replica after streams have accepted tokens, and check: every
        client completes, every completion is token-identical to a
        single uninterrupted engine, ``fleet.failovers`` >= 1, and the
        surviving replica's KV allocator leak report is clean.

    ... --rolling_upgrade
        same fleet + load, then drain each replica in turn while the
        router migrates its spilled streams and the manager respawns
        it — zero dropped or truncated streams, and /statusz's fleet
        census shows every replica healthy again at the end.

    ... --router_crash_drill
        a child process runs a journaling router over ragged streams,
        the parent SIGKILLs the *router* mid-stream (the workers survive
        as orphans), and a fresh ``Router(recover=run_dir)`` built from
        the journal directory alone must finish every stream
        token-identical to the reference — with zero replica restarts
        and no live journal files left behind.

    ... --autoscale_drill
        on fake time: a queue burst must scale the fleet up, continued
        burn at the ceiling must record ``blocked_at_max``, and a fully
        idle window must drain + retire back down — every transition a
        ``fleet.autoscale`` record, and the burst's streams still
        token-exact.

    ... --trace_drill
        per-request waterfalls survive a replica SIGKILL: each worker
        writes its own metrics stream, the router's spans go to
        worker-0, and after replica 0 is killed mid-stream every victim's
        trace must stitch across both replicas, every request must
        assemble into exactly one trace with coverage >= 0.95 and no
        orphan span, and both ``tail_latency_attribution`` and the
        doctor must name failover recompute as what the p99 tail pays
        for beyond the median.

Each drill takes a model spec (the worker's: seed, GPTConfig kwargs,
engine kwargs) and a device; at the command line the spec is a tiny GPT
and ``--device`` defaults to ``cuda`` (``--device cpu`` runs the plain
PyTorch versions on the CPU).  Each returns its evidence dict, which the
command line prints as one JSON line, and raises on any violated
invariant, so a smoke can run it.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ...framework.errors import enforce
from ...observability.monitor import StatusServer
from ...observability.registry import MetricsRegistry
from ...testing import faults
from .autoscaler import FleetAutoscaler, ServingSLO
from .replica import (HttpReplica, LocalReplicaManager, ReplicaManager,
                      _child_env)
from .router import Router
from .worker import build_model

__all__ = ["SPEC", "PROMPTS", "DrillFailed", "reference_outputs",
           "check_exact", "start_fleet", "sigkill_drill", "rolling_upgrade",
           "router_crash_drill", "autoscale_drill", "trace_drill",
           "TRACE_SPEC", "TRACE_PROMPTS", "TRACE_MAX_NEW", "main"]

SPEC = {"seed": 7,
        "config": {"vocab_size": 32, "hidden_size": 32, "num_layers": 2,
                   "num_heads": 2, "ffn_hidden_size": 64,
                   "max_position_embeddings": 64, "hidden_dropout": 0.0,
                   "attention_dropout": 0.0},
        "engine": {"max_seqs": 4}}
PROMPTS = [[1, 2, 3 + i] for i in range(6)]


class DrillFailed(AssertionError):
    """A drill's invariant did not hold."""


def _require(cond: bool, msg: str) -> None:
    enforce(cond, msg, exc=DrillFailed)


def _on(spec: Dict[str, Any], device: Optional[str]) -> Dict[str, Any]:
    out = dict(spec)
    if device is not None:
        out["device"] = device
    return out


def reference_outputs(spec: Dict[str, Any], prompts: Sequence[Sequence[int]],
                      max_new: int) -> List[List[int]]:
    """What an uninterrupted single engine produces for ``prompts``."""
    from ..engine import ServingEngine
    ref = ServingEngine(build_model(spec), registry=MetricsRegistry(),
                        **spec.get("engine", {}))
    return ref.generate(prompts, max_new_tokens=max_new)


def check_exact(what: str, got: List[List[int]], want: List[List[int]],
                 explain: Optional[Callable[[int, List[int]], None]]
                 ) -> int:
    """Count token-exact streams; every stream that is not is passed to
    ``explain(index, tokens)`` first, then the drill fails naming the
    first one and its first differing position."""
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    for i in bad:
        if explain is not None:
            explain(i, got[i])
    if bad:
        i = bad[0]
        pos = next((j for j, (a, b) in enumerate(zip(got[i], want[i]))
                    if a != b), min(len(got[i]), len(want[i])))
        _require(False, f"{what}: only {len(got) - len(bad)}/{len(got)} "
                 f"streams token-exact; stream {i} first differs at token "
                 f"{pos}")
    return len(got)


def start_fleet(spec: Dict[str, Any], run_dir: str, journal: bool = False,
                registry=None):
    reg = registry if registry is not None else MetricsRegistry()
    mgr = ReplicaManager(spec, replicas=2, registry=reg, run_dir=run_dir)
    mgr.start()
    router = Router(mgr.replicas, manager=mgr, registry=reg,
                    run_dir=run_dir if journal else None)
    return reg, mgr, router


def sigkill_drill(run_dir: str, spec: Dict[str, Any] = SPEC,
                  prompts: Sequence[Sequence[int]] = PROMPTS,
                  max_new: int = 40, *, device: Optional[str] = None,
                  reference: Optional[List[List[int]]] = None,
                  registry=None, explain=None,
                  on_start: Optional[Callable] = None) -> Dict[str, Any]:
    """Kill replica 0 (SIGKILL) once it holds an unfinished stream with 2
    or more accepted tokens.  ``on_start(manager)`` runs once the workers
    are up; ``reference`` defaults to :func:`reference_outputs`."""
    spec = _on(spec, device)
    t0 = time.perf_counter()
    reg, mgr, router = start_fleet(spec, run_dir, registry=registry)
    try:
        if on_start is not None:
            on_start(mgr)
        rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        kill = faults.kill_replica(
            mgr, index=0,
            when=lambda: any(
                len(j.tokens) >= 2 for j in router.journals.values()
                if j.replica_id == 0 and not j.finished))
        deadline = time.monotonic() + 120
        while not kill.fired and time.monotonic() < deadline:
            router.pump()
            kill.maybe()
            time.sleep(0.01)
        _require(kill.fired == 1, "kill predicate never held")
        at_kill = [{"replica": router.journals[r].replica_id,
                    "accepted": len(router.journals[r].tokens),
                    "finished": router.journals[r].finished} for r in rids]
        _require(mgr.poll_states()[0] == "dead", "replica 0 not dead")
        outs = [router.collect(r, timeout=120) for r in rids]
        if reference is None:
            reference = reference_outputs(spec, prompts, max_new)
        exact = check_exact("sigkill", [o["tokens"] for o in outs],
                             reference, explain)
        _require(router.failovers >= 1, "no failover observed")
        survivor = router.replicas[1].serving_stats()
        _require(survivor["kv_blocks"]["leaked"] == 0, str(survivor))
        page = StatusServer(registry=reg, router=router).statusz()
        _require(page["fleet"]["states"].get("dead") == 1,
                 f"statusz states {page['fleet']['states']}")
        return {"drill": "sigkill", "streams": len(prompts),
                "token_exact": exact, "failovers": router.failovers,
                "kill_fired": kill.fired, "at_kill": at_kill,
                "survivor_leaked_blocks": survivor["kv_blocks"]["leaked"],
                "statusz_states": page["fleet"]["states"],
                "wall_s": time.perf_counter() - t0}
    finally:
        mgr.stop()


def rolling_upgrade(run_dir: str, spec: Dict[str, Any] = SPEC,
                    prompts: Sequence[Sequence[int]] = PROMPTS,
                    max_new: int = 48, *, device: Optional[str] = None,
                    reference: Optional[List[List[int]]] = None,
                    registry=None, explain=None) -> Dict[str, Any]:
    """Drain and respawn each replica in turn under load."""
    spec = _on(spec, device)
    t0 = time.perf_counter()
    reg, mgr, router = start_fleet(spec, run_dir, registry=registry)
    try:
        rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        router.pump()
        migrated = router.rolling_upgrade(timeout_per_replica=0.05)
        states = mgr.poll_states()
        _require(all(s == "healthy" for s in states.values()), str(states))
        outs = [router.collect(r, timeout=120) for r in rids]
        dropped = sum(len(o["tokens"]) != max_new for o in outs)
        _require(dropped == 0, f"{dropped} truncated streams")
        if reference is None:
            reference = reference_outputs(spec, prompts, max_new)
        exact = check_exact("rolling_upgrade",
                             [o["tokens"] for o in outs], reference,
                             explain)
        page = StatusServer(registry=reg, router=router).statusz()
        _require(page["fleet"]["states"].get("healthy") == 2,
                 f"statusz states {page['fleet']['states']}")
        _require(page["fleet"]["restarts"] == 2 and mgr.restarts == 2,
                 f"{mgr.restarts} restarts")
        return {"drill": "rolling_upgrade", "streams": len(prompts),
                "dropped": dropped, "token_exact": exact,
                "migrated": migrated, "restarts": mgr.restarts,
                "statusz_states": page["fleet"]["states"],
                "wall_s": time.perf_counter() - t0}
    finally:
        mgr.stop()


_READY_FILE = "crash_child_ready.json"
_INPUT_FILE = "crash_child_input.json"


def _ragged(max_new: int, n: int) -> List[int]:
    """Ragged stream lengths ending at ``max_new``, 4 tokens apart."""
    return [max_new - 4 * (n - 1 - i) for i in range(n)]


def _crash_child(run_dir: str) -> None:
    """The victim: a journaling router that admits the ragged streams,
    pumps until every journal holds accepted tokens, then parks and
    waits for the parent's SIGKILL.  No cleanup — that is the point."""
    with open(os.path.join(run_dir, _INPUT_FILE)) as f:
        inp = json.load(f)
    reg, mgr, router = start_fleet(inp["spec"], run_dir, journal=True)
    rids = [router.submit(p, max_new_tokens=n)
            for p, n in zip(inp["prompts"], inp["max_new"])]
    deadline = time.monotonic() + 120
    while (any(len(j.tokens) < 2 for j in router.journals.values())
           and time.monotonic() < deadline):
        router.pump()
        time.sleep(0.01)
    _require(all(len(j.tokens) >= 2 for j in router.journals.values()),
             "streams never accepted tokens")
    ready = {"streams": [{"request_id": r, "max_new": n}
                         for r, n in zip(rids, inp["max_new"])],
             "accepted": [len(router.journals[r].tokens) for r in rids],
             "workers": [{"replica": i, "port": rep.port,
                          "pid": rep.process.pid}
                         for i, rep in enumerate(mgr.replicas)]}
    path = os.path.join(run_dir, _READY_FILE)
    with open(path + ".tmp", "w") as f:
        json.dump(ready, f)
    os.replace(path + ".tmp", path)     # atomic: parent sees all or nothing
    while True:                          # hold streams mid-flight
        time.sleep(1)


def _gone(pid: int) -> bool:
    """True once ``pid`` has exited (a zombie whose parent died counts:
    nothing will reap it if the host's init does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return False


def _reap_workers(workers) -> None:
    """Shut down the orphaned worker processes the drill left behind."""
    for w in workers:
        HttpReplica(w["replica"], w["port"]).stop()
    deadline = time.monotonic() + 15
    for w in workers:
        while not _gone(w["pid"]) and time.monotonic() < deadline:
            time.sleep(0.05)
        if not _gone(w["pid"]):
            try:
                os.kill(w["pid"], signal.SIGKILL)
            except ProcessLookupError:
                pass


def router_crash_drill(run_dir: str, spec: Dict[str, Any] = SPEC,
                       prompts: Sequence[Sequence[int]] = PROMPTS,
                       max_new: int = 60, *, device: Optional[str] = None,
                       reference: Optional[List[List[int]]] = None,
                       registry=None, explain=None) -> Dict[str, Any]:
    """SIGKILL a journaling router (a child process) mid-stream and
    finish every stream from its journal in a fresh router.  Stream i
    asks for ``max_new - 4 * (n - 1 - i)`` tokens; ``reference`` holds
    ``max_new`` tokens a stream (its prefixes are the ragged ones)."""
    spec = _on(spec, device)
    t0 = time.perf_counter()
    ragged = _ragged(max_new, len(prompts))
    _require(min(ragged) > 2, f"ragged lengths {ragged} too short")
    with open(os.path.join(run_dir, _INPUT_FILE), "w") as f:
        json.dump({"spec": spec, "prompts": [list(p) for p in prompts],
                   "max_new": ragged}, f)
    child = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.fleet.drills",
         "--_crash_child", run_dir],
        stdout=subprocess.DEVNULL, env=_child_env())
    ready_path = os.path.join(run_dir, _READY_FILE)
    info = None
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ready_path):
            _require(child.poll() is None, "router child died before "
                     f"ready (rc={child.returncode})")
            _require(time.monotonic() < deadline, "router child never ready")
            time.sleep(0.02)
        with open(ready_path) as f:
            info = json.load(f)
        # SIGKILL the router — no atexit, no drain, no journal flush
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=10)
        for w in info["workers"]:        # workers must have survived
            _require(not _gone(w["pid"]), f"worker {w} died with the router")
        reg = registry if registry is not None else MetricsRegistry()
        replicas = [HttpReplica(w["replica"], w["port"])
                    for w in info["workers"]]
        router = Router(replicas, registry=reg, recover=run_dir)
        rec = dict(router.recovered)
        _require(rec["streams"] == len(info["streams"]), str(rec))
        _require(rec["reattached"] + rec["redispatched"] >= 1, str(rec))
        outs = [router.collect(s["request_id"], timeout=120)
                for s in info["streams"]]
        if reference is None:
            reference = reference_outputs(spec, prompts, max_new)
        exact = check_exact(
            "router_crash", [o["tokens"] for o in outs],
            [reference[i][:s["max_new"]]
             for i, s in enumerate(info["streams"])], explain)
        leaked = 0
        for w, replica in zip(info["workers"], replicas):
            # the original pid: never restarted
            _require(not _gone(w["pid"]), f"worker {w} restarted")
            leaked += replica.serving_stats()["kv_blocks"]["leaked"]
        _require(leaked == 0, f"{leaked} KV blocks leaked across the crash")
        _require(router.store.live_count() == 0,
                 "live journal files left after every stream finished")
        return {"drill": "router_crash", "streams": len(prompts),
                "token_exact": exact, "recovered": rec,
                "accepted_at_crash": info["accepted"],
                "worker_restarts": 0, "leaked_blocks": leaked,
                "journal_live": router.store.live_count(),
                "journal_drops": dict(router.store.drops),
                "wall_s": time.perf_counter() - t0}
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        if info is not None:
            _reap_workers(info["workers"])


def autoscale_drill(run_dir: str, spec: Dict[str, Any] = SPEC,
                    prompts: Sequence[Sequence[int]] = PROMPTS,
                    max_new: int = 8, *, device: Optional[str] = None,
                    reference: Optional[List[List[int]]] = None
                    ) -> Dict[str, Any]:
    """Scale an in-process fleet up under a burst, record
    ``blocked_at_max`` at the ceiling, and scale down once idle."""
    from ..engine import ServingEngine

    spec = _on(spec, device)
    t0 = time.perf_counter()
    reg = MetricsRegistry()
    records: List[Dict[str, Any]] = []

    class _Capture:
        def write(self, r):
            records.append(r)

        def flush(self):
            pass

        def close(self):
            pass

    reg.add_sink(_Capture())

    def factory(i):
        return ServingEngine(build_model(spec), registry=reg,
                             **spec.get("engine", {}))

    clk = {"t": 0.0}
    mgr = LocalReplicaManager(factory, replicas=1, registry=reg)
    router = Router(mgr.replicas, manager=mgr, registry=reg)
    scaler = FleetAutoscaler(
        mgr, router=router, slo=ServingSLO(queue_depth=2.0),
        min_replicas=1, max_replicas=2, window_secs=10.0,
        cooldown_secs=5.0, registry=reg, clock=lambda: clk["t"])

    def tick_until(action, limit=60):
        for _ in range(limit):
            clk["t"] += 1.0
            if scaler.step() == action:
                return
        _require(False, f"autoscaler never chose {action!r}: "
                 f"{scaler.stats()}")

    # burst: the streams against 1 replica — queue SLO burns -> scale up
    rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
    tick_until("up")
    _require(len(scaler.active_ids()) == 2, str(mgr.poll_states()))
    # still burning at the ceiling -> the page-worthy record, not a spawn
    tick_until("blocked_at_max")
    _require(len(scaler.active_ids()) == 2, str(mgr.poll_states()))
    # drain the burst; a fully idle window -> drain + retire back down
    router.run(timeout=120)
    tick_until("down")
    states = mgr.poll_states()
    _require(sum(1 for s in states.values() if s == "retired") == 1,
             str(states))
    _require(len(scaler.active_ids()) == 1, str(states))
    outs = [router.collect(r, timeout=10) for r in rids]
    if reference is None:
        reference = reference_outputs(spec, prompts, max_new)
    exact = check_exact("autoscale", [o["tokens"] for o in outs],
                         reference, None)
    scale_records = [r for r in records if r["kind"] == "fleet.autoscale"]
    actions = [r["action"] for r in scale_records]
    for want in ("up", "blocked_at_max", "down"):
        _require(want in actions, f"no fleet.autoscale {want!r}: {actions}")
    for r in scale_records:              # the timeline schema operators page on
        for field in ("action", "replicas", "target", "burn", "idle",
                      "why", "slo"):
            _require(field in r, f"{field} missing from {r}")
    active_end = len(scaler.active_ids())
    mgr.stop()
    return {"drill": "autoscale", "streams": len(prompts),
            "token_exact": exact, "actions": actions,
            "active_end": active_end, "scaler": scaler.stats()["actions"],
            "wall_s": time.perf_counter() - t0}


# the JAX example's prompts, with longer ragged streams (160..216 tokens,
# hence the longer position table): replica 0 dies only once the router
# has polled its first tokens, after all eight submissions, and the
# victims' recompute and requeue behind the survivor must still be most
# of a stream, however fast the card (or the CPU) decodes a tiny model
TRACE_SPEC = {**SPEC, "config": {**SPEC["config"],
                                 "max_position_embeddings": 256}}
TRACE_PROMPTS = [[1, 2, 3 + i % 6, 4 + i % 3] for i in range(8)]
TRACE_MAX_NEW = [160 + 8 * i for i in range(8)]


def trace_drill(run_dir: str, spec: Dict[str, Any] = TRACE_SPEC,
                prompts: Sequence[Sequence[int]] = TRACE_PROMPTS,
                max_new: Sequence[int] = TRACE_MAX_NEW, *,
                device: Optional[str] = None) -> Dict[str, Any]:
    """Two traced workers, replica 0 SIGKILLed once it holds an
    unfinished stream with 2 or more accepted tokens; then the run
    directory alone must give one complete trace a request (coverage >=
    0.95, no orphan span, a victim stitched across both replicas) and a
    tail verdict of ``failover_recompute`` from the attribution and the
    doctor.  Every stream must also be token-exact against one
    uninterrupted engine."""
    from ...observability import doctor, requesttrace
    from ...observability.sinks import MetricsWriter, metrics_dir

    spec = _on(spec, device)
    t0 = time.perf_counter()
    mdir = metrics_dir(run_dir)
    reg = MetricsRegistry()
    # the router's spans go to worker-0; each engine worker writes its
    # own stream (worker-<i+1>) through PTPU_METRICS_DIR, flushed a
    # record at a time, so the SIGKILL victim's spans survive
    writer = reg.add_sink(MetricsWriter(mdir, worker_id=0, flush_every=1))
    mgr = ReplicaManager(spec, replicas=2, registry=reg, run_dir=run_dir,
                         env={"PTPU_METRICS_DIR": mdir,
                              "PTPU_TRACE_REQUESTS": "1"})
    mgr.start()
    router = Router(mgr.replicas, manager=mgr, registry=reg,
                    run_dir=run_dir)       # journaled: the WAL cross-check
    try:
        # warm every replica directly (least-loaded dispatch can pile all
        # warmup onto one replica): ``"trace_id": None`` is an explicit
        # not-traced decision, so warmup streams never enter the assembly
        for i, rep in enumerate(mgr.replicas):
            warm = [f"warm-{i}-{w}" for w in range(4)]
            for rid in warm:
                rep.submit({"request_id": rid, "prompt": [1, 2, 3, 4],
                            "output": [], "max_new_tokens": 4,
                            "eos_token_id": None, "preemptions": 0,
                            "trace_id": None})
            for rid in warm:
                deadline = time.monotonic() + 120
                while not rep.poll(rid, start=0)["finished"]:
                    _require(time.monotonic() < deadline,
                             f"warmup stream {rid} never finished")
                    time.sleep(0.01)
        rids = [router.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        dispatched = [router.journals[r].replica_id for r in rids]
        kill = faults.kill_replica(
            mgr, index=0,
            when=lambda: any(
                len(j.tokens) >= 2 for j in router.journals.values()
                if j.replica_id == 0 and not j.finished))
        deadline = time.monotonic() + 120
        while not kill.fired and time.monotonic() < deadline:
            router.pump()
            kill.maybe()
            time.sleep(0.01)
        _require(kill.fired == 1, "kill predicate never held")
        outs = [router.collect(r, timeout=120) for r in rids]
        _require(router.failovers >= 1, "no failover observed")
    finally:
        mgr.stop()
    reg.remove_sink(writer)                # flush and close worker-0
    # greedy streams are prefixes of each other's longer runs
    ref = reference_outputs(spec, prompts, max(max_new))
    want = [r[:n] for r, n in zip(ref, max_new)]
    exact = check_exact("trace", [o["tokens"] for o in outs], want, None)

    t_asm = time.perf_counter()
    result = requesttrace.assemble_run(run_dir)
    assemble_s = time.perf_counter() - t_asm
    traces = result["traces"]
    _require(len(traces) == len(rids),
             f"{len(traces)} traces for {len(rids)} requests")
    _require({t["request_id"] for t in traces} == set(rids),
             "assembled request ids do not match the submitted set")
    _require(result["complete"] == len(rids), str(result["complete"]))
    _require(not result["orphan_spans"], str(result["orphan_spans"]))
    stitched = [t for t in traces
                if {"replica-0", "replica-1"} <= set(t["procs"])]
    _require(bool(stitched), "no trace stitched across both replicas")
    min_cov = min(t["coverage"] for t in traces)
    _require(min_cov >= 0.95, f"trace coverage floor {min_cov:.1%} < 95%")
    attrib = requesttrace.tail_latency_attribution(traces)
    _require(attrib is not None
             and attrib["dominant"] == "failover_recompute", str(attrib))
    t_doc = time.perf_counter()
    diagnosis = doctor.diagnose(run_dir)
    diagnose_s = time.perf_counter() - t_doc
    tail = [f for f in diagnosis["findings"] if f["kind"] == "tail_latency"]
    _require(bool(tail), "doctor produced no tail_latency verdict (p99 "
             f"{attrib['p99_ms']} ms, median {attrib['median_ms']} ms; "
             f"streams dispatched to replicas {dispatched}, latencies "
             f"{[round(t['latency_ms'], 1) for t in traces]} ms)")
    _require(tail[0]["data"]["dominant"] == "failover_recompute",
             str(tail[0]))
    return {"drill": "trace", "streams": len(rids), "token_exact": exact,
            "traces": len(traces), "complete": result["complete"],
            "stitched_across_replicas": len(stitched),
            "coverage_min": round(min_cov, 4),
            "orphan_spans": len(result["orphan_spans"]),
            "wal_matched": result["wal_matched"],
            "tail_dominant": attrib["dominant"],
            "tail_p99_ms": attrib["p99_ms"],
            "tail_median_ms": attrib["median_ms"],
            "dispatched": dispatched,
            "doctor_severity": tail[0]["severity"],
            "assemble_s": assemble_s, "diagnose_s": diagnose_s,
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--sigkill_drill", action="store_true")
    ap.add_argument("--rolling_upgrade", action="store_true")
    ap.add_argument("--router_crash_drill", action="store_true")
    ap.add_argument("--autoscale_drill", action="store_true")
    ap.add_argument("--trace_drill", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--_crash_child", metavar="RUN_DIR", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args._crash_child:
        _crash_child(args._crash_child)
        return 0
    drills = {"sigkill_drill": sigkill_drill,
              "rolling_upgrade": rolling_upgrade,
              "router_crash_drill": router_crash_drill,
              "autoscale_drill": autoscale_drill,
              "trace_drill": trace_drill}
    picked = [name for name in drills if getattr(args, name)]
    if len(picked) != 1:
        ap.error("pick one of --sigkill_drill, --rolling_upgrade, "
                 "--router_crash_drill, --autoscale_drill, --trace_drill")
    import tempfile
    with tempfile.TemporaryDirectory() as run_dir:
        evidence = drills[picked[0]](run_dir, device=args.device)
    print(json.dumps(evidence))  # noqa: print — the drill's evidence line
    return 0


if __name__ == "__main__":
    sys.exit(main())
