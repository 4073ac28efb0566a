"""Fleet router: queue-aware dispatch with token-exact failover, the
port's own copy of ``paddle_tpu/inference/fleet/router.py``.

The router owns a set of replicas (any mix of
:class:`..replica.LocalReplica` / ``HttpReplica``) and gives clients one
durable stream per request, surviving replica death, clean drains,
rolling upgrades and its *own* death.

Mechanics:

- **Dispatch** — least-loaded by each replica's ``/statusz`` serving
  section (``queue_depth + waiting + running``); a stream with a
  ``session`` key is affine to the replica already serving that
  session (KV/prefix locality), unless that replica left the healthy
  set.  Dispatch failures retry with bounded exponential backoff
  (``PTPU_FLEET_RETRY_MAX`` × ``PTPU_FLEET_RETRY_BACKOFF_MS``) across
  the healthy set; exhaustion raises :class:`DispatchExhausted`
  naming every replica tried.
- **Admission** — the engine's load-shed at fleet level: when total
  queued work across healthy replicas exceeds
  ``PTPU_FLEET_SHED_QUEUE_DEPTH``, new submissions raise
  :class:`FleetOverloaded` (the caller's 429).
- **Token-exact failover** — the router journals every stream's
  prompt and accepted tokens.  ``pump()`` polls new tokens into the
  journal; when a replica dies mid-stream (SIGKILL — no spill file),
  the survivors' journal entries are re-submitted to a healthy
  replica as spill-format records (``output`` = accepted tokens), so
  the engine's recompute-prefill path rebuilds the KV and greedy
  decoding continues **token-exact** — the same seam ``resume()``
  uses.  A replica that drains cleanly hands its ``spilled_records``
  to the router, which migrates them identically.
- **Crash-safe journal** — with a ``run_dir``, every journal mutation
  is written ahead to ``<run_dir>/fleet/journal/`` through the fsync'd
  :class:`.journal.JournalStore`.  ``Router(recover=run_dir)`` rebuilds
  every stream from the directory alone: streams a live replica still
  owns are *re-attached* (polling resumes at the journaled offset);
  orphans are *re-dispatched* through ``admit_record`` — either way the
  client's tokens stay exact across a router SIGKILL with zero replica
  restarts.
- **Flap resistance** — a per-replica
  :class:`.health.CircuitBreaker` turns intermittent transport
  failures into a ``flapping`` census state (excluded from dispatch,
  probed after backoff) instead of failover churn, and every retry /
  failover re-dispatch spends the process-wide
  :class:`.health.RetryBudget`; a dry bucket degrades new work to
  load-shed and defers failovers to the next pump — no retry storms.
- **Rolling upgrade** — :meth:`rolling_upgrade` drains one replica at
  a time (migrating its spill), lets the manager respawn it, waits
  healthy, and moves on; in-flight streams never drop.

Counters: ``fleet.dispatch``, ``fleet.retries``, ``fleet.failovers``,
``fleet.migrations``, ``fleet.shed``, ``fleet.deferred``,
``fleet.recovered``; gauges ``fleet.streams`` and the manager's
``fleet.replicas[state=...]`` census (``flapping`` included).  The
router is host code over the replica protocol: nothing here touches a
device, and the same router drives engines on the card or on the CPU.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from ...framework.errors import enforce
from ...framework.log import vlog
from ...observability import requesttrace
from .health import CircuitBreaker, get_retry_budget
from .journal import JournalStore

__all__ = ["RETRY_MAX_ENV", "RETRY_BACKOFF_MS_ENV",
           "SHED_QUEUE_DEPTH_ENV", "default_retry_max",
           "default_retry_backoff_ms", "default_shed_queue_depth",
           "FleetOverloaded", "DispatchExhausted", "StreamJournal",
           "Router"]

RETRY_MAX_ENV = "PTPU_FLEET_RETRY_MAX"
RETRY_BACKOFF_MS_ENV = "PTPU_FLEET_RETRY_BACKOFF_MS"
SHED_QUEUE_DEPTH_ENV = "PTPU_FLEET_SHED_QUEUE_DEPTH"

#: seconds a stream's coalesced "deliver" span may stay open before
#: the router flushes it (finish always flushes).  Bounds both the
#: span-emission rate on the pump hot path and the deliver coverage a
#: router crash can lose.
DELIVER_FLUSH_S = 0.25


def default_retry_max() -> int:
    return int(os.environ.get(RETRY_MAX_ENV, "3"))


def default_retry_backoff_ms() -> float:
    return float(os.environ.get(RETRY_BACKOFF_MS_ENV, "50"))


def default_shed_queue_depth() -> int:
    return int(os.environ.get(SHED_QUEUE_DEPTH_ENV, "64"))


def _pctl(values, p: float) -> Optional[float]:
    """Nearest-rank percentile over a small sample; None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(len(ordered) * p / 100.0))
    return float(ordered[idx])


class FleetOverloaded(RuntimeError):
    """Fleet-level admission refusal (every replica is past the shed
    threshold, the aggregate queue is, or the retry budget is dry) —
    the client's 429."""


class DispatchExhausted(RuntimeError):
    """Dispatch retries exhausted; the message names every replica
    tried so operators see the blast radius, not just the last error."""


class StreamJournal:
    """One client stream's durable record: the prompt plus every token
    the router has accepted — exactly the spill-format record a fresh
    engine re-admits token-exactly on failover."""

    def __init__(self, request_id: str, prompt: Sequence[int],
                 max_new_tokens: int, eos_token_id: Optional[int],
                 session: Optional[str] = None,
                 trace_id: Optional[str] = None):
        self.request_id = request_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.session = session
        self.tokens: List[int] = []     # accepted (journaled) tokens
        self.finished = False
        self.reason: Optional[str] = None
        self.replica_id: Optional[int] = None
        self.failovers = 0
        # request tracing: the fleet-wide trace context plus
        # the router-side (client-observed) clock marks.  All wall
        # clock — spans must compare across processes on this host.
        self.trace_id = trace_id
        self.resume_why: Optional[str] = None   # stamps re-dispatches
        self.submit_wall: float = time.time()
        self.first_token_wall: Optional[float] = None
        self.last_token_wall: Optional[float] = None
        self.last_progress_wall: Optional[float] = None
        self.end_wall: Optional[float] = None
        self.ttft_ms: Optional[float] = None
        # start of the not-yet-emitted "deliver" stretch.  Deliver
        # spans chain contiguously poll-to-poll, so the router
        # coalesces them and flushes one span per ~DELIVER_FLUSH_S
        # (or at finish) — same interval union as per-poll emission
        # at a fraction of the hot-path emit cost.
        self.deliver_open_wall: Optional[float] = None
        # router-observed per-component milliseconds (the /statusz
        # slow_requests breakdown; the full waterfall needs the
        # assembler)
        self.components: Dict[str, float] = {}

    def record(self) -> Dict[str, Any]:
        """Spill-format record re-admitting this stream mid-flight.
        ``trace_id`` carries the trace context across the process
        boundary; ``resume_why`` tells the receiving engine what to
        attribute the recompute-prefill to."""
        out = {"request_id": self.request_id,
               "prompt": list(self.prompt),
               "output": list(self.tokens),
               "max_new_tokens": self.max_new_tokens,
               "eos_token_id": self.eos_token_id,
               "preemptions": 0,
               "trace_id": self.trace_id}
        if self.resume_why is not None:
            out["resume_why"] = self.resume_why
        return out


class Router:
    """Dispatch + journal + failover over a replica set.

    ``replicas`` maps replica_id → client.  ``manager`` (optional,
    a :class:`..replica.ReplicaManager`) supplies the subprocess
    census for ``poll_states``-driven liveness; without one the
    router probes ``alive()`` itself (the in-process form).

    ``run_dir`` switches on the crash-safe write-ahead journal;
    ``recover`` (a run_dir) additionally rebuilds every stream from
    the journal directory before serving.  ``retry_budget`` overrides
    the process-wide bucket (tests); ``breaker_kw`` overrides the
    per-replica breaker knobs (``failures`` / ``window_secs`` /
    ``backoff_secs`` / ``clock``)."""

    def __init__(self, replicas, *, manager=None, registry=None,
                 retry_max: Optional[int] = None,
                 retry_backoff_ms: Optional[float] = None,
                 shed_queue_depth: Optional[int] = None,
                 run_dir: Optional[str] = None,
                 recover: Optional[str] = None,
                 retry_budget=None,
                 breaker_kw: Optional[Dict[str, Any]] = None,
                 sleep=time.sleep):
        if isinstance(replicas, dict):
            self.replicas = dict(replicas)
        else:
            self.replicas = {r.replica_id: r for r in replicas}
        enforce(self.replicas, "router needs at least one replica")
        self.manager = manager
        self._registry = registry
        self.retry_max = int(retry_max if retry_max is not None
                             else default_retry_max())
        self.retry_backoff_ms = float(
            retry_backoff_ms if retry_backoff_ms is not None
            else default_retry_backoff_ms())
        self.shed_queue_depth = int(
            shed_queue_depth if shed_queue_depth is not None
            else default_shed_queue_depth())
        self._sleep = sleep
        self.journals: Dict[str, StreamJournal] = {}
        self._sessions: Dict[str, int] = {}   # session -> replica_id
        self._ids = 0
        self.dispatch_fault = None   # seam: fn(replica_id, record) pre-send
        self.failovers = 0
        self.migrations = 0
        # flap resistance
        self.budget = (retry_budget if retry_budget is not None
                       else get_retry_budget())
        self._breaker_kw = dict(breaker_kw or {})
        self.breakers: Dict[int, CircuitBreaker] = {}
        # crash-safe journal
        if recover is not None:
            run_dir = recover
        self.store = (JournalStore(run_dir) if run_dir is not None
                      else None)
        self.recovered = {"streams": 0, "reattached": 0,
                          "redispatched": 0, "finished": 0}
        # client-observed latency tails: measured at the
        # router, so queueing / retries / failover recompute are all
        # inside the number — the gap to the engine-local serve.* SLO
        # histograms is itself the signal
        self._ttft_ms: Deque[float] = deque(maxlen=512)
        self._tpot_ms: Deque[float] = deque(maxlen=512)
        self._recent: Deque[Dict[str, Any]] = deque(maxlen=64)
        if recover is not None:
            self._recover()

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ...observability.registry import get_registry
        return get_registry()

    def _span(self, journal: StreamJournal, name: str, component: str,
              t0: float, t1: float, **fields) -> None:
        """Emit one router-side trace span and fold its duration into
        the journal's component breakdown (the /statusz table works
        even when the stream is unsampled)."""
        bucket = requesttrace.component_bucket(component)
        journal.components[bucket] = (journal.components.get(bucket, 0.0)
                                      + max(0.0, t1 - t0) * 1e3)
        requesttrace.emit_span(self._reg(), journal.trace_id,
                               journal.request_id, name, component,
                               t0, t1, "router", **fields)

    # -- replica set -------------------------------------------------------
    def _available_ids(self) -> List[int]:
        """Replicas dispatch may consider: healthy, plus flapping ones
        (their breaker gates per-candidate — the half-open probe must
        be dispatchable or an open breaker could never close)."""
        if self.manager is not None:
            states = self.manager.poll_states()
            self.replicas = {i: r for i, r
                             in enumerate(self.manager.replicas)}
            return [i for i, s in states.items()
                    if s in ("healthy", "flapping")]
        return [i for i, r in self.replicas.items() if r.alive()
                and r.healthz()[0] == 200]

    def _breaker(self, rid: int) -> CircuitBreaker:
        br = self.breakers.get(rid)
        if br is None:
            def on_transition(prev, new, b, _rid=rid):
                self._on_breaker(_rid, prev, new, b)
            br = CircuitBreaker(on_transition=on_transition,
                                **self._breaker_kw)
            self.breakers[rid] = br
        return br

    def _on_breaker(self, rid: int, prev: str, new: str,
                    breaker: CircuitBreaker) -> None:
        reg = self._reg()
        reg.emit("fleet.breaker", replica=rid, prev=prev, state=new,
                 trips=breaker.trips,
                 backoff_secs=breaker.current_backoff())
        flapping = new in ("open", "half_open")
        if self.manager is not None:
            self.manager.set_flapping(rid, flapping)
        else:
            census = "flapping" if flapping else "healthy"
            reg.emit("fleet.replica_state", replica=rid,
                     prev=("healthy" if flapping else "flapping"),
                     state=census)
            reg.gauge("fleet.replicas[state=flapping]").set(float(
                sum(1 for b in self.breakers.values()
                    if b.state in ("open", "half_open"))))
        if new == "open":
            reg.counter("fleet.breaker_trips").inc()
        vlog(0, "fleet: replica %d breaker %s -> %s (backoff %.1fs)",
             rid, prev, new, breaker.current_backoff())

    def _load(self, replica) -> float:
        """Queue-aware load score from the replica's serving stats;
        unreachable replicas sort last."""
        try:
            s = replica.serving_stats()
        except ConnectionError:
            return float("inf")
        return (float(s.get("queue_depth", 0)) + float(s.get("waiting", 0))
                + float(s.get("running", 0)))

    def _pick(self, session: Optional[str],
              healthy: List[int]) -> List[int]:
        """Candidate order: session-affine replica first (when still
        healthy), then the rest least-loaded."""
        ranked = sorted(healthy,
                        key=lambda i: (self._load(self.replicas[i]), i))
        if session is not None:
            aff = self._sessions.get(session)
            if aff in ranked:
                ranked.remove(aff)
                ranked.insert(0, aff)
        return ranked

    def fleet_depth(self, healthy: List[int]) -> float:
        """Aggregate queued work over reachable replicas (an
        unreachable probe is unknown load, not infinite load — it must
        not flip admission to shed on one dropped packet)."""
        loads = [self._load(self.replicas[i]) for i in healthy]
        return sum(x for x in loads if x != float("inf"))

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, journal: StreamJournal, fresh: bool = True,
                  since: Optional[float] = None) -> Optional[int]:
        """Send ``journal``'s record to the best replica, retrying with
        backoff across the healthy set.  The first attempt of a fresh
        submission is free; every further send spends the retry
        budget.  Returns the replica id — or, for non-fresh work
        (failover / recovery re-dispatch), None when dispatch must be
        deferred to a later pump (budget dry, nowhere to send).

        Fresh submissions fail loudly instead: a dry budget raises
        :class:`FleetOverloaded` (degrade to load-shed), exhaustion
        raises :class:`DispatchExhausted`.  ``since`` starts the first
        dispatch span earlier than now: a submission's span opens at the
        submit, so the journal write before it is inside the trace's
        covered time."""
        reg = self._reg()
        tried: List[str] = []
        backoff = self.retry_backoff_ms / 1e3
        first_free = fresh
        # trace attribution: a failover/migration re-dispatch is that
        # component's cost, not generic "dispatch"; backoff sleeps get
        # their own segments so nothing is double-counted
        comp = {"failover": "failover",
                "migration": "migration"}.get(journal.resume_why,
                                              "dispatch")
        seg0 = time.time() if since is None else since
        for attempt in range(self.retry_max + 1):
            healthy = self._available_ids()
            for rid in self._pick(journal.session, healthy):
                replica = self.replicas[rid]
                breaker = self._breaker(rid)
                if not breaker.allow():
                    tried.append(f"replica-{rid}: breaker "
                                 f"{breaker.state}")
                    continue
                if first_free:
                    first_free = False
                elif not self.budget.try_acquire():
                    if fresh:
                        reg.counter("fleet.shed").inc()
                        reg.emit("fleet.shed", why="retry_budget",
                                 request_id=journal.request_id)
                        raise FleetOverloaded(
                            f"{journal.request_id}: retry budget dry "
                            f"({self.budget.snapshot()}) — degrading "
                            f"to load-shed")
                    reg.counter("fleet.deferred").inc()
                    reg.emit("fleet.deferred",
                             request_id=journal.request_id,
                             why="retry_budget")
                    self._span(journal, "dispatch", comp, seg0,
                               time.time(), deferred=True)
                    return None
                try:
                    if self.dispatch_fault is not None:
                        self.dispatch_fault(rid, journal.record())
                    replica.submit(journal.record())
                except ConnectionError as e:
                    breaker.record_failure()
                    tried.append(f"replica-{rid}: {e}")
                    continue
                breaker.record_success()
                journal.replica_id = rid
                if journal.session is not None:
                    self._sessions[journal.session] = rid
                if self.store is not None:
                    self.store._append(journal.request_id,
                                       {"kind": "disp", "replica": rid,
                                        "trace_id": journal.trace_id})
                reg.counter("fleet.dispatch").inc()
                reg.emit("fleet.dispatch", request_id=journal.request_id,
                         replica=rid, attempt=attempt,
                         resumed_at=len(journal.tokens),
                         trace_id=journal.trace_id)
                now = time.time()
                self._span(journal, "dispatch", comp, seg0, now,
                           replica=rid, attempt=attempt)
                journal.last_progress_wall = now
                journal.resume_why = None
                return rid
            if attempt < self.retry_max:
                reg.counter("fleet.retries").inc()
                now = time.time()
                self._span(journal, "dispatch", comp, seg0, now,
                           attempt=attempt)
                self._sleep(backoff)
                seg0 = time.time()
                self._span(journal, "retry_backoff", "retry_backoff",
                           now, seg0, attempt=attempt)
                backoff *= 2
        if not fresh:
            reg.counter("fleet.deferred").inc()
            reg.emit("fleet.deferred", request_id=journal.request_id,
                     why="; ".join(tried[-3:]) or "no replica available")
            return None
        raise DispatchExhausted(
            f"{journal.request_id}: dispatch failed after "
            f"{self.retry_max + 1} attempts across replicas "
            f"{sorted(self.replicas)} — " + ("; ".join(tried[-6:])
                                             or "no healthy replica"))

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               request_id: Optional[str] = None,
               eos_token_id: Optional[int] = None,
               session: Optional[str] = None) -> str:
        """Admit one client stream: journal it (durably, with a
        ``run_dir``), then dispatch.  Raises :class:`FleetOverloaded`
        past the fleet shed threshold or on a dry retry budget."""
        healthy = self._available_ids()
        depth = self.fleet_depth(healthy)
        if not healthy or depth > self.shed_queue_depth:
            self._reg().counter("fleet.shed").inc()
            self._reg().emit("fleet.shed", why="queue_depth",
                             depth=depth, healthy=len(healthy))
            raise FleetOverloaded(
                f"fleet admission closed: {len(healthy)} healthy "
                f"replicas, aggregate depth {depth:.0f} > "
                f"{self.shed_queue_depth}")
        if request_id is None:
            # recovered journals may already hold fleet-N names — the
            # counter restarts at 0 after a crash, the streams did not
            while f"fleet-{self._ids}" in self.journals:
                self._ids += 1
            request_id = f"fleet-{self._ids}"
            self._ids += 1
        enforce(request_id not in self.journals,
                f"duplicate request id {request_id!r}")
        journal = StreamJournal(request_id, prompt, max_new_tokens,
                                eos_token_id, session=session,
                                trace_id=requesttrace.mint_trace_id(
                                    request_id))
        self.journals[request_id] = journal
        if self.store is not None:
            # write-ahead: the stream exists durably before dispatch
            self.store.open(request_id, journal.prompt, max_new_tokens,
                            eos_token_id, session=session,
                            trace_id=journal.trace_id)
        if journal.trace_id is not None:
            # lifecycle open: the client-observed window starts here —
            # before dispatch, so a refusal still closes to a complete
            # trace instead of leaking orphan spans
            self._reg().emit("trace.request", trace_id=journal.trace_id,
                             request_id=request_id,
                             t0=journal.submit_wall,
                             prompt_len=len(journal.prompt),
                             proc="router")
        self._reg().gauge("fleet.streams").set(float(len(
            [j for j in self.journals.values() if not j.finished])))
        try:
            self._dispatch(journal, fresh=True, since=journal.submit_wall)
        except (FleetOverloaded, DispatchExhausted):
            # the client saw a refusal — no ghost stream may linger
            if journal.trace_id is not None:
                self._reg().emit("trace.request_end",
                                 trace_id=journal.trace_id,
                                 request_id=request_id, t1=time.time(),
                                 reason="shed", tokens=0, proc="router")
            del self.journals[request_id]
            if self.store is not None:
                self.store.discard(request_id)
            raise
        return request_id

    # -- recovery -----------------------------------------------------------
    def _probe_owner(self, journal: StreamJournal,
                     prefer: Optional[int]) -> Optional[int]:
        """Find a replica that still owns ``journal`` (router crashed,
        replicas survived): last-dispatched first, then the rest."""
        order = [i for i in ([prefer] if prefer is not None else [])
                 if i in self.replicas]
        order += [i for i in self._available_ids() if i not in order]
        for rid in order:
            try:
                self.replicas[rid].poll(journal.request_id,
                                        start=len(journal.tokens))
            except Exception:   # unknown rid / unreachable — not ours
                continue
            return rid
        return None

    def _recover(self) -> None:
        """Rebuild every stream from the journal directory: re-attach
        to a replica that still runs it, or re-dispatch the journal
        record through the ``admit_record`` recompute-prefill seam."""
        reg = self._reg()
        for rec in self.store.recover():
            rid = rec["request_id"]
            journal = StreamJournal(rid, rec["prompt"],
                                    rec["max_new_tokens"],
                                    rec["eos_token_id"],
                                    session=rec["session"],
                                    trace_id=rec.get("trace_id"))
            journal.tokens = list(rec["tokens"])
            # the trace window survives the router crash: latency is
            # still measured from the journaled open, not the restart
            if rec.get("opened_ts") is not None:
                journal.submit_wall = float(rec["opened_ts"])
            self.journals[rid] = journal
            self.recovered["streams"] += 1
            if rec["finished"]:
                journal.finished = True
                journal.reason = rec["reason"]
                self.recovered["finished"] += 1
                self.store.retire(rid, rec["reason"])
                continue
            owner = self._probe_owner(journal, rec.get("replica"))
            if owner is not None:
                journal.replica_id = owner
                if journal.session is not None:
                    self._sessions[journal.session] = owner
                self.recovered["reattached"] += 1
            else:
                # orphaned (its replica died with the router): replay
                # the journal record; None = deferred to pump().  The
                # recompute this forces is failover cost.
                journal.resume_why = "failover"
                if self._dispatch(journal, fresh=False) is not None:
                    self.recovered["redispatched"] += 1
        if self.recovered["streams"]:
            reg.counter("fleet.recovered").inc(self.recovered["streams"])
        reg.emit("fleet.recover", **self.recovered)
        self._reg().gauge("fleet.streams").set(float(len(
            [j for j in self.journals.values() if not j.finished])))
        vlog(0, "fleet: recovered %d streams (%d reattached, %d "
             "redispatched, %d already finished)",
             self.recovered["streams"], self.recovered["reattached"],
             self.recovered["redispatched"], self.recovered["finished"])

    # -- streaming / failover ---------------------------------------------
    def _poll_journal(self, journal: StreamJournal) -> bool:
        """Pull new tokens for one live stream into its journal; True
        when progress or completion was observed.  ConnectionError
        propagates — pump() turns it into failover."""
        replica = self.replicas[journal.replica_id]
        out = replica.poll(journal.request_id, start=len(journal.tokens))
        new = [int(t) for t in out["tokens"]]
        now = time.time()
        if new or out["finished"]:
            # client-observed delivery: the stretch since the router
            # last saw progress on this stream.  Generation overlaps
            # it, so the assembler charges "deliver" only the residue
            # no other span covers (poll starvation, HTTP lag) —
            # emitted straight to the registry, NOT folded into the
            # journal's component table, which tracks exclusive time.
            # Consecutive stretches chain contiguously, so they are
            # coalesced and flushed at finish or every DELIVER_FLUSH_S
            # (bounding what a router crash can lose).
            if journal.deliver_open_wall is None:
                journal.deliver_open_wall = (journal.last_progress_wall
                                             or journal.submit_wall)
            if (out["finished"]
                    or now - journal.deliver_open_wall >= DELIVER_FLUSH_S):
                requesttrace.emit_span(self._reg(), journal.trace_id,
                                       journal.request_id, "deliver",
                                       "deliver",
                                       journal.deliver_open_wall, now,
                                       "router")
                journal.deliver_open_wall = now
        if new:
            if self.store is not None:
                # write-ahead: tokens are durable before they count
                self.store.append_tokens(journal.request_id, new)
            journal.tokens.extend(new)
            reg = self._reg()
            if journal.first_token_wall is None:
                journal.first_token_wall = now
                ttft = (now - journal.submit_wall) * 1e3
                journal.ttft_ms = ttft
                reg.histogram("fleet.ttft_ms").observe(ttft)
                self._ttft_ms.append(ttft)
            elif journal.last_token_wall is not None:
                # client-observed inter-token time, split evenly over
                # the tokens this poll surfaced
                per_tok = ((now - journal.last_token_wall)
                           / len(new)) * 1e3
                for _ in new:
                    reg.histogram("fleet.tpot_ms").observe(per_tok)
                    self._tpot_ms.append(per_tok)
            journal.last_token_wall = now
            journal.last_progress_wall = now
        if out["finished"]:
            journal.finished = True
            journal.reason = out.get("reason")
            journal.end_wall = now
            if self.store is not None:
                self.store.retire(journal.request_id, journal.reason)
            if journal.trace_id is not None:
                self._reg().emit("trace.request_end",
                                 trace_id=journal.trace_id,
                                 request_id=journal.request_id,
                                 t1=now, reason=journal.reason,
                                 tokens=len(journal.tokens),
                                 proc="router")
            self._recent.append(self._slow_row(journal, now))
        return bool(new) or journal.finished

    def _failover(self, journal: StreamJournal, why: str) -> None:
        """Re-home one live stream: re-submit its journal record (the
        accepted-token tail rides along) to a healthy replica.  May
        leave the stream undispatched (budget/candidate starvation) —
        the next pump retries."""
        reg = self._reg()
        dead = journal.replica_id
        journal.failovers += 1
        self.failovers += 1
        journal.replica_id = None
        if (journal.session is not None
                and self._sessions.get(journal.session) == dead):
            del self._sessions[journal.session]
        # detection gap: from the stream's last observed progress to
        # the moment the router noticed the replica was gone — the
        # first component of the failover's latency cost
        t_detect = time.time()
        self._span(journal, "failover_detect", "failover",
                   journal.last_progress_wall or t_detect, t_detect,
                   from_replica=dead)
        journal.resume_why = "failover"
        rid = self._dispatch(journal, fresh=False)
        reg.counter("fleet.failovers").inc()
        reg.emit("fleet.failover", request_id=journal.request_id,
                 from_replica=dead, to_replica=rid, why=why,
                 accepted_tokens=len(journal.tokens),
                 trace_id=journal.trace_id)
        vlog(0, "fleet: failover %s replica %s -> %s (%s, %d tokens "
             "accepted)", journal.request_id, dead, rid, why,
             len(journal.tokens))

    def pump(self) -> int:
        """One router turn: step in-process replicas, poll every live
        stream's tokens into its journal, and fail over streams whose
        replica died.  Returns the number of live streams remaining."""
        for replica in self.replicas.values():
            try:
                replica.pump()
            except ConnectionError:
                pass                  # liveness handled per-stream below
        live = [j for j in self.journals.values() if not j.finished]
        for journal in live:
            if journal.replica_id is None:
                # deferred failover/recovery: quiet budgeted retry
                self._dispatch(journal, fresh=False)
                continue
            replica = self.replicas.get(journal.replica_id)
            gone = getattr(replica, "gone", None)
            if gone is not None and gone():
                # signalled or exited: fail over without a call that a
                # dying worker's open socket would hold for its timeout
                self._breaker(journal.replica_id).record_failure()
                self._failover(journal, "replica died (process signalled "
                               "or exited)")
                continue
            try:
                self._poll_journal(journal)
            except ConnectionError as e:
                replica = self.replicas.get(journal.replica_id)
                breaker = self._breaker(journal.replica_id)
                if replica is not None and replica.alive():
                    # transient — the replica is up.  Feed the breaker
                    # instead of raising: enough of these in a window
                    # and the replica is flapping, and only THEN do its
                    # streams move (churn costs more than patience).
                    breaker.record_failure()
                    if breaker.state == "closed":
                        continue
                    self._failover(journal,
                                   f"replica flapping ({e})")
                    continue
                breaker.record_failure()
                self._failover(journal, f"replica died ({e})")
        remaining = [j for j in self.journals.values() if not j.finished]
        self._reg().gauge("fleet.streams").set(float(len(remaining)))
        return len(remaining)

    def collect(self, request_id: str,
                timeout: Optional[float] = None) -> Dict[str, Any]:
        """Pump until ``request_id`` finishes; return its journal
        record (tokens are the journaled, failover-stable stream)."""
        journal = self.journals.get(request_id)
        enforce(journal is not None, f"unknown stream {request_id!r}")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not journal.finished:
            enforce(deadline is None or time.monotonic() < deadline,
                    f"{request_id}: fleet stream not finished after "
                    f"{timeout}s (replica={journal.replica_id}, "
                    f"accepted={len(journal.tokens)})")
            self.pump()
            if not journal.finished:
                self._sleep(0.002)
        return {"request_id": request_id,
                "tokens": list(journal.tokens),
                "finish_reason": journal.reason,
                "replica_id": journal.replica_id,
                "failovers": journal.failovers}

    def run(self, timeout: Optional[float] = None) -> None:
        """Pump until every journaled stream finishes."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self.pump() > 0:
            enforce(deadline is None or time.monotonic() < deadline,
                    f"fleet streams not drained after {timeout}s")
            self._sleep(0.002)

    # -- drain / rolling upgrade -------------------------------------------
    def drain_replica(self, rid: int,
                      timeout: Optional[float] = None) -> int:
        """Gracefully drain one replica and migrate its spilled
        streams to the rest of the fleet; returns the migration
        count.  The replica ends ``stopped`` — restart it via the
        manager before re-adding."""
        if self.manager is not None:
            # the manager may have spawned slots since construction
            # (autoscaler scale-up) — refresh before indexing
            self.replicas = {i: r for i, r
                             in enumerate(self.manager.replicas)}
        replica = self.replicas[rid]
        report = replica.drain(timeout=timeout)
        migrated = 0
        by_rid = {j.request_id: j for j in self.journals.values()}
        for rec in report.get("spilled_records", []):
            journal = by_rid.get(rec["request_id"])
            if journal is None or journal.finished:
                continue
            # trust the engine's record — it may hold tokens a poll
            # never fetched; both prefixes agree (greedy decode)
            if len(rec.get("output", [])) > len(journal.tokens):
                ahead = [int(t) for t in
                         rec["output"][len(journal.tokens):]]
                if self.store is not None:
                    self.store.append_tokens(journal.request_id, ahead)
                journal.tokens.extend(ahead)
            journal.replica_id = None
            if (journal.session is not None
                    and self._sessions.get(journal.session) == rid):
                del self._sessions[journal.session]
            now = time.time()
            self._span(journal, "migration_wait", "migration",
                       journal.last_progress_wall or now, now,
                       from_replica=rid)
            journal.resume_why = "migration"
            self._dispatch(journal, fresh=True)
            migrated += 1
            self.migrations += 1
            self._reg().counter("fleet.migrations").inc()
        # finished-on-drain streams: pull their final tokens before the
        # replica goes away entirely
        for journal in self.journals.values():
            if journal.replica_id == rid and not journal.finished:
                try:
                    self._poll_journal(journal)
                except ConnectionError:
                    pass
        self._reg().emit("fleet.drain", replica=rid, migrated=migrated,
                         finished=report.get("finished"))
        return migrated

    def rolling_upgrade(self,
                        timeout_per_replica: Optional[float] = None
                        ) -> Dict[int, int]:
        """Drain + respawn every replica one at a time while the rest
        of the fleet absorbs the load; returns replica_id → migrated
        stream count.  Requires a manager (subprocess fleet)."""
        enforce(self.manager is not None,
                "rolling_upgrade() needs a ReplicaManager")
        migrated: Dict[int, int] = {}
        for rid in sorted(self.replicas):
            if self.manager.states.get(rid) in ("dead", "retired"):
                continue
            migrated[rid] = self.drain_replica(
                rid, timeout=timeout_per_replica)
            self.manager.restart(rid)
            self.replicas[rid] = self.manager.replicas[rid]
            self.breakers.pop(rid, None)   # fresh worker, fresh record
            deadline = time.monotonic() + 60.0
            while self.manager.poll_states().get(rid) != "healthy":
                enforce(time.monotonic() < deadline,
                        f"replica {rid} not healthy after respawn")
                self._sleep(0.05)
            vlog(0, "fleet: rolling upgrade — replica %d respawned "
                 "(%d streams migrated)", rid, migrated[rid])
        return migrated

    # -- observability ------------------------------------------------------
    def census(self) -> Dict[int, str]:
        """Replica states with the ``flapping`` overlay: a replica the
        base census calls healthy whose breaker is open/half-open is
        flapping — alive, polled, but not dispatchable."""
        if self.manager is not None:
            base = self.manager.poll_states()
        else:
            base = {i: ("healthy" if r.alive() else "dead")
                    for i, r in self.replicas.items()}
            for i, br in self.breakers.items():
                if (base.get(i) == "healthy"
                        and br.state in ("open", "half_open")):
                    base[i] = "flapping"
        return base

    def _slow_row(self, journal: StreamJournal,
                  now: Optional[float] = None) -> Dict[str, Any]:
        """One ``slow_requests`` table row: client-observed latency so
        far plus the router-side component breakdown."""
        now = time.time() if now is None else now
        end = journal.end_wall if journal.finished else now
        return {"request_id": journal.request_id,
                "trace_id": journal.trace_id,
                "state": "finished" if journal.finished else "live",
                "latency_ms": round(
                    (end - journal.submit_wall) * 1e3, 3),
                "ttft_ms": (None if journal.ttft_ms is None
                            else round(journal.ttft_ms, 3)),
                "tokens": len(journal.tokens),
                "failovers": journal.failovers,
                "replica": journal.replica_id,
                "components": {k: round(v, 3) for k, v
                               in sorted(journal.components.items())}}

    def slow_requests(self, k: int = 8) -> List[Dict[str, Any]]:
        """Top-``k`` slowest streams (in-flight + recently finished) by
        client-observed latency — the ``/statusz`` tail table."""
        now = time.time()
        rows = [self._slow_row(j, now)
                for j in self.journals.values() if not j.finished]
        rows += list(self._recent)
        rows.sort(key=lambda r: r["latency_ms"], reverse=True)
        return rows[:max(0, int(k))]

    def slo_stats(self) -> Dict[str, Any]:
        """Client-observed SLO snapshot shaped like the engine's
        ``serving_stats()`` — the ``PTPU_FLEET_SLO_SOURCE=router``
        feed for :class:`..autoscaler.ServingSLO`."""
        live = [j for j in self.journals.values() if not j.finished]
        return {"queue_depth": self.fleet_depth(self._available_ids()),
                "waiting": 0,
                "running": len(live),
                "slo": {"ttft_ms": {"p50": _pctl(self._ttft_ms, 50),
                                    "p99": _pctl(self._ttft_ms, 99),
                                    "samples": len(self._ttft_ms)},
                        "tpot_ms": {"p50": _pctl(self._tpot_ms, 50),
                                    "p99": _pctl(self._tpot_ms, 99),
                                    "samples": len(self._tpot_ms)}}}

    def stats(self) -> Dict[str, Any]:
        """Fleet snapshot for ``/statusz`` and the doctor."""
        live = [j for j in self.journals.values() if not j.finished]
        states = self.census()
        counts: Dict[str, int] = {}
        for s in states.values():
            counts[s] = counts.get(s, 0) + 1
        out = {"replicas": len(self.replicas),
               "states": counts,
               "streams": {"live": len(live),
                           "finished": len(self.journals) - len(live)},
               "failovers": self.failovers,
               "migrations": self.migrations,
               "sessions": len(self._sessions),
               "breakers": {i: br.snapshot()
                            for i, br in sorted(self.breakers.items())},
               "retry_budget": self.budget.snapshot(),
               "slo": self.slo_stats()["slo"],
               "slow_requests": self.slow_requests()}
        if self.store is not None:
            out["journal"] = {"live": self.store.live_count(),
                              "appends": self.store.appends,
                              "drops": dict(self.store.drops),
                              "recovered": dict(self.recovered)}
        return out
