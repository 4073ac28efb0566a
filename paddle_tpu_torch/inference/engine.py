"""ServingEngine: the continuous-batching serving loop, the port of
``paddle_tpu/inference/engine.py``.

    engine = ServingEngine(model, max_seqs=8, kv_block_size=16)
    rid = engine.submit([1, 5, 9], max_new_tokens=32)
    while engine.step():            # one prefill OR one decode batch
        ...
    out = engine.collect(rid)       # {"tokens": [...], "ttft_ms": ...}

Pieces: ``kv_cache.PagedKVCache`` (block-pooled KV with per-sequence
tables), ``scheduler.ContinuousBatchingScheduler`` (admission by block
budget, newest-first preemption, prefill/decode interleaving), the model's
``serving_step`` (paged-decode kernel and, with ``use_fused_block``, the
fused-block kernels) and this module: step execution, sampling, the
request lifecycle and the submit / step / run / collect / generate surface.

Step shapes come from a closed set, as in the JAX engine: decode is always
``(max_seqs, 1)``; prefill is padded to power-of-two buckets.  Eager
PyTorch compiles nothing per shape, so the JAX engine's per-bucket compile
tracker (``track_jit``) has no counterpart here.

Sampling is greedy at ``temperature <= 0``; above it, tokens are drawn from
``softmax(logits / temperature)`` with a ``torch.Generator`` seeded by
``seed`` (its stream differs from the JAX engine's PRNG).

The request lifecycle, as in the JAX engine:

- **deadlines and cancel** — ``submit(deadline_ms=, ttft_deadline_ms=)``
  and ``cancel(rid)``; a between-steps reaper evicts expired and cancelled
  sequences with every KV block returned and a terminal reason
  (``deadline`` / ``cancelled``) through ``collect()`` and the callbacks;
- **quarantine** — the step runs inside a fault boundary; a step exception
  (or a nonfinite logits row under the NaN guard) bisects the batch,
  evicts the culprit(s) with ``reason="poisoned"`` and a durable record
  under ``<run_dir>/serve/replica-<i>/quarantine/``, and replays the step
  so every other request completes token-exact (decode rows are
  independent);
- **supervision and drain** — ``step()`` arms the watchdog (a hung step
  gets a stack dump, and the running set is preempted back to the queue
  and recomputed), and ``drain(timeout=)`` stops admission (``/healthz``
  503 ``draining``), finishes what it can, spills the rest to a JSON file
  (``<run_dir>/serve/replica-<i>/spill.json``, byte for byte the JAX
  engine's format) that a fresh engine of either package ``resume()``s,
  then stops the callback thread;
- **token callbacks** (``submit(on_token=)``) run on a separate thread, so
  a slow consumer delays its own stream, never the batch; consumer
  exceptions are counted, never fatal;
- ``serve.*`` metrics on the registry, padding accounting, request-trace
  spans at the JAX engine's points, the status server and ``defrag``.

What differs from the JAX step, and why it is safe:

- The JAX step is pure: it returns new pages and the engine commits them
  only after the step succeeds.  The port's ``serving_step`` writes each
  row's K/V into the pages in place.  A bisection probe, a failed step or
  a replay therefore writes a row's K/V at ``computed_len`` again; the
  value depends only on that row's pending token and its earlier KV, so a
  rewrite stores what the first write stored.  Pad rows write the sentinel
  slot.  A culprit's blocks are freed with whatever it wrote; every later
  read of a slot follows a write by the step that owns it.
- All engine work stays on the current CUDA stream (no side stream), so
  the writes of a step abandoned by hang recovery land before any later
  writer of the blocks ``preempt_all`` freed.
- A decode step copies the logits to the host only when a ``step_fault``
  or ``capture_logits`` is set.  Otherwise the NaN guard reduces
  ``isfinite(logits).all(-1)`` on the device and reads the row flags back
  in the same copy as the tokens.  With a ``step_fault`` the guard runs on
  the faulted host logits, as in JAX.
- The generator's state is taken before each step and restored before
  every bisection probe and before the replay, so they draw what the
  faulted step drew.  Greedy serving draws nothing.

The engine refuses to run under a hybrid group (``fleet.init``), as the
JAX constructor refuses a mesh: its model would hold one rank's shard.
Still to port (ROADMAP.md Queue 1): the engine's decode step as a CUDA
graph.  The serving fleet above
the engine (router, journal, replicas) is :mod:`.fleet`.

Env knobs: ``PTPU_MAX_SEQS``, ``PTPU_KV_BLOCK_SIZE``,
``PTPU_SHED_QUEUE_DEPTH``, ``PTPU_SERVE_NAN_GUARD``,
``PTPU_SERVE_DEADLINE_MS``, ``PTPU_SERVE_DRAIN_SECS``.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.errors import enforce
from ..framework.log import vlog
from ..observability import requesttrace
from ..observability.registry import get_registry
from ..supervisor.watchdog import StepTimeout, Watchdog, guarded
from ..utils import fsio
from .kv_cache import PagedKVCache, default_kv_block_size
from .scheduler import ContinuousBatchingScheduler, SequenceState, StepPlan

__all__ = ["MAX_SEQS_ENV", "SHED_QUEUE_DEPTH_ENV", "NAN_GUARD_ENV",
           "DEADLINE_MS_ENV", "DRAIN_SECS_ENV", "default_max_seqs",
           "default_shed_queue_depth", "default_nan_guard",
           "default_deadline_ms", "default_drain_secs", "CollectTimeout",
           "ServingEngine"]

MAX_SEQS_ENV = "PTPU_MAX_SEQS"
SHED_QUEUE_DEPTH_ENV = "PTPU_SHED_QUEUE_DEPTH"
NAN_GUARD_ENV = "PTPU_SERVE_NAN_GUARD"
DEADLINE_MS_ENV = "PTPU_SERVE_DEADLINE_MS"
DRAIN_SECS_ENV = "PTPU_SERVE_DRAIN_SECS"

_PAD_SEQ = "__pad__"          # never a real request id
_CB_STOP = object()           # callback-thread shutdown sentinel

# recompute cause -> trace-span component: the re-prefill (and the
# re-queue wait before it) is attributed to whatever evicted the KV
_RESUME_COMPONENT = {"preempt": "preempt_recompute",
                     "failover": "failover_recompute",
                     "migration": "migration_recompute"}


def _pctl(values, p: float) -> Optional[float]:
    """Nearest-rank percentile over a small sample; None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(len(ordered) * p / 100.0))
    return float(ordered[idx])


def default_max_seqs() -> int:
    return int(os.environ.get(MAX_SEQS_ENV, "8"))


def default_shed_queue_depth() -> int:
    return int(os.environ.get(SHED_QUEUE_DEPTH_ENV, "64"))


def default_nan_guard() -> bool:
    return os.environ.get(NAN_GUARD_ENV, "0").lower() in ("1", "true",
                                                          "yes", "on")


def default_deadline_ms() -> Optional[float]:
    raw = os.environ.get(DEADLINE_MS_ENV)
    return None if raw is None else float(raw)


def default_drain_secs() -> float:
    return float(os.environ.get(DRAIN_SECS_ENV, "30"))


class CollectTimeout(TimeoutError):
    """``collect(timeout=)`` expired before the request finished; the
    message names the request's current scheduler state."""


class _NonfiniteLogits(RuntimeError):
    """NaN-guard verdict: the named rows came back nonfinite — unlike a
    raised step error this carries the culprits, no bisection needed."""

    def __init__(self, request_ids: List[str]):
        super().__init__(f"nonfinite logits for {request_ids}")
        self.request_ids = list(request_ids)


class ServingEngine:
    """Paged-KV continuous-batching serving engine over a model exposing the
    ``GPTForCausalLM`` serving surface: ``.config``, ``.device``,
    ``.eval()`` and ``serving_step(ids, caches, positions, last_index)``
    returning ``(logits, caches)``.

    The engine runs on the model's device.  ``capture_logits=True`` keeps
    every sampled position's logits row on the host per request (the
    numerics hook for tests).

    Lifecycle knobs: ``nan_guard`` enables the per-step nonfinite-logits
    check (env ``PTPU_SERVE_NAN_GUARD``); ``step_timeout`` arms a watchdog
    of the engine's own around every step (or pass a shared ``watchdog``,
    which ``stop()`` leaves open; without either the step is
    ``guarded`` by the process-global watchdog, if one is installed) — set
    it above the slowest step, the first one included (kernel builds, CUDA
    set-up);
    ``run_dir`` is where quarantine records and the drain spill file land;
    ``step_fault`` is the test seam ``testing.faults.poison_request``
    plugs into — it is called as ``fault(engine, kind, request_ids,
    logits)`` with host logits on every executed step, bisection probes
    included; ``registry`` defaults to the process-global one.
    """

    def __init__(self, model, *, max_seqs: Optional[int] = None,
                 kv_block_size: Optional[int] = None,
                 num_kv_blocks: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 temperature: float = 0.0,
                 capture_logits: bool = False,
                 shed_queue_depth: Optional[int] = None,
                 registry=None, seed: int = 0,
                 clock: Callable[[], float] = time.time,
                 nan_guard: Optional[bool] = None,
                 step_timeout: Optional[float] = None,
                 watchdog: Optional[Watchdog] = None,
                 run_dir: Optional[str] = None,
                 replica_id: Optional[int] = None,
                 step_fault: Optional[Callable] = None):
        from ..distributed.topology import get_mesh
        enforce(get_mesh() is None,
                "ServingEngine is single-card (a model built under a hybrid "
                "group holds one rank's shard) — run it outside fleet groups")
        cfg = model.config
        self.model = model
        model.eval()
        self.device = model.device
        self.max_seqs = int(max_seqs if max_seqs is not None
                            else default_max_seqs())
        self.max_model_len = int(max_model_len if max_model_len is not None
                                 else cfg.max_position_embeddings)
        enforce(self.max_model_len <= cfg.max_position_embeddings,
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"{cfg.max_position_embeddings} positions")
        block_size = (default_kv_block_size() if kv_block_size is None
                      else int(kv_block_size))
        blocks_per_seq = -(-self.max_model_len // block_size)
        if num_kv_blocks is None:
            # every batch slot can hold a full-length sequence
            num_kv_blocks = self.max_seqs * blocks_per_seq
        self.cache = PagedKVCache(cfg.num_layers, cfg.num_heads,
                                  cfg.head_dim, num_kv_blocks,
                                  block_size=block_size,
                                  dtype=cfg.torch_dtype, device=self.device)
        self.sched = ContinuousBatchingScheduler(
            self.cache, self.max_seqs, self.max_model_len, clock=clock)
        self.temperature = float(temperature)
        self.capture_logits = bool(capture_logits)
        self.shed_queue_depth = int(
            shed_queue_depth if shed_queue_depth is not None
            else default_shed_queue_depth())
        self._registry = registry
        self.clock = clock
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._ids = itertools.count()
        self.steps = 0
        self.status_server = None
        self._cb_queue: Optional[queue.Queue] = None
        self._cb_thread: Optional[threading.Thread] = None
        self.nan_guard = (default_nan_guard() if nan_guard is None
                          else bool(nan_guard))
        self.run_dir = run_dir
        self.replica_id = None if replica_id is None else int(replica_id)
        self.step_fault = step_fault
        self.step_timeout = step_timeout
        # a watchdog of its own for step_timeout, else the shared one
        # passed in (closed by its owner, not by stop())
        self._owns_watchdog = watchdog is None and step_timeout is not None
        self._watchdog = (Watchdog(timeout=step_timeout)
                          if self._owns_watchdog else watchdog)
        self._state = "serving"           # serving | draining | stopped
        self._submit_order: List[str] = []
        self.quarantined: Dict[str, Dict[str, Any]] = {}
        self.watchdog_restarts = 0
        self.lifecycle_counts = {"deadline": 0, "cancelled": 0,
                                 "poisoned": 0, "spilled": 0}
        self._cb_dispatched = 0
        self._cb_errors = 0
        self._last_callback_error: Optional[str] = None
        self._ttft_ms: Deque[float] = deque(maxlen=512)
        self._tpot_ms: Deque[float] = deque(maxlen=512)
        self._step_ms: Dict[str, List[float]] = {"prefill": [], "decode": []}
        # request tracing: the process tag of every span, and the request
        # ids whose trace THIS engine owns (direct submissions)
        self._proc = f"replica-{self.replica_id or 0}"
        self._trace_owned: set = set()
        # padding accounting: real vs launched token slots
        self._pad_real_tokens = 0
        self._pad_slot_tokens = 0

    # -- plumbing ----------------------------------------------------------
    def serve_dir(self) -> Optional[str]:
        """Per-replica durable-artifact namespace: ``<run_dir>/serve/
        replica-<i>`` — quarantine records and the drain spill live here,
        so engines sharing one ``run_dir`` never collide.  None without a
        ``run_dir``."""
        if self.run_dir is None:
            return None
        return os.path.join(self.run_dir, "serve",
                            f"replica-{self.replica_id or 0}")

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    # -- intake ------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               request_id: Optional[str] = None,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               deadline_ms: Optional[float] = None,
               ttft_deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> str:
        """Queue one request; returns its id.  ``on_token(request_id,
        token, finished)`` — when given — runs on the callback thread.
        ``deadline_ms`` bounds the whole request (default from
        ``PTPU_SERVE_DEADLINE_MS``; None = no deadline);
        ``ttft_deadline_ms`` bounds the wait for the first token — both
        relative to now, enforced by the between-steps reaper with terminal
        ``reason="deadline"``.  ``trace_id`` is a router's; without it the
        engine mints (and owns) one."""
        enforce(self._state == "serving",
                f"engine is {self._state} — not accepting new requests")
        rid = request_id or f"req-{next(self._ids)}"
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        now = float(self.clock())
        if deadline_ms is None:
            deadline_ms = default_deadline_ms()
        seq = SequenceState(request_id=rid, prompt=prompt,
                            max_new_tokens=int(max_new_tokens),
                            eos_token_id=eos_token_id,
                            arrival=now,
                            on_token=on_token,
                            capture_logits=self.capture_logits,
                            deadline=(None if deadline_ms is None
                                      else now + float(deadline_ms) / 1e3),
                            ttft_deadline=(
                                None if ttft_deadline_ms is None
                                else now + float(ttft_deadline_ms) / 1e3))
        if trace_id is None:
            trace_id = requesttrace.mint_trace_id(rid)
            if trace_id is not None:
                self._trace_owned.add(rid)
        seq.trace_id = trace_id
        self.sched.submit(seq)
        self._submit_order.append(rid)
        reg = self._reg()
        reg.counter("serve.requests").inc()
        reg.emit("serve.request", request_id=rid, prompt_len=len(prompt),
                 max_new_tokens=seq.max_new_tokens, trace_id=trace_id)
        if rid in self._trace_owned:
            reg.emit("trace.request", trace_id=trace_id, request_id=rid,
                     t0=now, prompt_len=len(prompt), proc=self._proc)
        self._update_gauges()
        return rid

    def cancel(self, request_id: str) -> bool:
        """Flag a live request for eviction at the next step boundary
        (terminal ``reason="cancelled"``, KV blocks returned).  False when
        the request already finished or was never submitted."""
        for seq in list(self.sched.running) + list(self.sched.waiting):
            if seq.request_id == request_id:
                seq.cancelled = True
                return True
        return False

    def should_shed(self) -> bool:
        """Load-shed signal: the admission queue is past the knob —
        ``/healthz`` turns 503 so the balancer routes elsewhere."""
        return self.sched.queue_depth > self.shed_queue_depth

    # -- the step ----------------------------------------------------------
    def _trace_end(self, seq: SequenceState, reason: str) -> None:
        """Close an engine-owned trace at a terminal transition."""
        if seq.trace_id is None or seq.request_id not in self._trace_owned:
            return
        self._trace_owned.discard(seq.request_id)
        self._reg().emit("trace.request_end", trace_id=seq.trace_id,
                         request_id=seq.request_id,
                         t1=float(self.clock()), reason=reason,
                         tokens=len(seq.output), proc=self._proc)

    def _evict(self, seq: SequenceState, reason: str) -> Dict[str, Any]:
        """Terminal eviction with reason ``deadline`` / ``cancelled``: free
        blocks, bump counters, emit the record, deliver the terminal event
        down the callback path."""
        self.sched.evict(seq, reason)
        self.lifecycle_counts[reason] += 1
        reg = self._reg()
        if reason == "cancelled":
            reg.counter("serve.cancelled").inc()
            reg.emit("serve.cancel", request_id=seq.request_id,
                     generated=len(seq.output), trace_id=seq.trace_id)
        else:
            reg.counter("serve.deadline_misses").inc()
            reg.emit("serve.deadline_miss", request_id=seq.request_id,
                     generated=len(seq.output), trace_id=seq.trace_id,
                     miss=("ttft" if seq.first_token_time is None
                           and seq.ttft_deadline is not None else "total"))
        self._trace_end(seq, reason)
        event = {"request_id": seq.request_id, "token": None,
                 "finished": True, "reason": reason}
        if seq.on_token is not None:
            self._dispatch_callback(seq.on_token, event, seq)
        return event

    def _reap(self) -> List[Dict[str, Any]]:
        """Between-steps sweep: evict cancelled and deadline-expired
        sequences (running or waiting) before the scheduler plans this
        step — their blocks fund the admissions."""
        now = float(self.clock())
        events = []
        for seq in list(self.sched.running) + list(self.sched.waiting):
            if seq.cancelled:
                events.append(self._evict(seq, "cancelled"))
            elif seq.deadline is not None and now >= seq.deadline:
                events.append(self._evict(seq, "deadline"))
            elif (seq.ttft_deadline is not None
                    and seq.first_token_time is None
                    and now >= seq.ttft_deadline):
                events.append(self._evict(seq, "deadline"))
        return events

    def _step_guard(self):
        if self._watchdog is not None:
            return self._watchdog.armed("serve_step",
                                        timeout=self.step_timeout)
        return guarded("serve_step")

    def step(self) -> List[Dict[str, Any]]:
        """Run one scheduler-chosen unit of work (one prefill or one decode
        batch) inside the lifecycle guard: reap expired and cancelled
        requests first, arm the watchdog around the step, recover from a
        hung step by preempting the running set (recompute-prefill).
        Returns the token events produced; empty when idle."""
        events = self._reap()
        try:
            with self._step_guard():
                events += self._step_inner()
        except StepTimeout:
            events += self._recover_from_hang()
        self.steps += 1
        self._update_gauges()
        return events

    def _step_inner(self) -> List[Dict[str, Any]]:
        plan = self.sched.schedule()
        reg = self._reg()
        for victim in plan.preempted:
            reg.counter("serve.preemptions").inc()
            reg.emit("serve.preempt", request_id=victim.request_id,
                     generated=len(victim.output),
                     trace_id=victim.trace_id)
            now = float(self.clock())
            requesttrace.emit_span(reg, victim.trace_id,
                                   victim.request_id, "preempt",
                                   "preempt", now, now, self._proc)
        if plan.kind not in ("prefill", "decode"):
            return []
        # head-of-line stall: residents not in this step's batch wait the
        # step out; behind a recompute prefill that is its cause's cost
        stall_comp = "stall"
        if plan.kind == "prefill" and plan.seqs:
            why = plan.seqs[0].resume_why
            if why:
                stall_comp = _RESUME_COMPONENT.get(why, "stall")
        served = {s.request_id for s in plan.seqs}
        t_step0 = float(self.clock())
        if plan.kind == "prefill":
            events = self._run_prefill(plan)
        else:
            events = self._run_decode(plan)
        stalled = [(s.request_id, s.trace_id)
                   for s in self.sched.running
                   if s.request_id not in served and s.trace_id is not None]
        if stalled:
            requesttrace.emit_stall_span(reg, stalled, t_step0,
                                         float(self.clock()), self._proc,
                                         component=stall_comp,
                                         cause=plan.kind)
        return events

    def _recover_from_hang(self) -> List[Dict[str, Any]]:
        """Hung-step recovery: the watchdog already dumped every thread's
        stack.  Host state is consistent (the scheduler's marks land only
        after a step returns), and eager PyTorch has no compiled step to
        rebuild, so preempt the running set back to the queue;
        recompute-prefill replays it token-exact.  The abandoned step's
        page writes were queued on the current stream, ahead of every
        later writer of the freed blocks."""
        victims = self.sched.preempt_all()
        self.watchdog_restarts += 1
        reg = self._reg()
        reg.counter("serve.watchdog_restarts").inc()
        reg.emit("serve.watchdog_restart", step=self.steps,
                 victims=[s.request_id for s in victims])
        return []

    def has_work(self) -> bool:
        return self.sched.has_work()

    def run(self, max_steps: Optional[int] = None) -> int:
        """Drive :meth:`step` until every submitted request finishes;
        returns the number of steps taken."""
        taken = 0
        while self.sched.has_work():
            self.step()
            taken += 1
            if max_steps is not None and taken > max_steps:
                stuck = ([s.request_id for s in self.sched.running]
                         + [s.request_id for s in self.sched.waiting])
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps; stuck "
                    f"requests: {', '.join(stuck) or 'none'}")
        return taken

    # -- prefill / decode execution ---------------------------------------
    # The _apply_* helpers run the model step and read the result back to
    # the host without touching scheduler state.  The pages change in
    # place (see the module docstring), but only with values a replay
    # writes again, so probing and replaying are free to repeat.

    def _apply_fault(self, kind: str, seqs: List[SequenceState],
                     logits_np: np.ndarray) -> np.ndarray:
        """Fault seam + NaN guard on host logits, applied to every executed
        step (bisection probes included — injected faults must re-fire on
        the subset that still contains the target)."""
        if self.step_fault is not None:
            out = self.step_fault(self, kind,
                                  [s.request_id for s in seqs], logits_np)
            if out is not None:
                logits_np = np.asarray(out)
        if self.nan_guard:
            bad = [s.request_id for i, s in enumerate(seqs)
                   if not np.isfinite(logits_np[i]).all()]
            if bad:
                raise _NonfiniteLogits(bad)
        return logits_np

    def _forward(self, kind: str, seqs: List[SequenceState],
                 ids: np.ndarray, positions: np.ndarray, last_index: int,
                 caches):
        """Run the model step, sample, and bring back the tokens: with the
        full logits when a fault seam or ``capture_logits`` needs them,
        else with the NaN guard's row flags in the same copy."""
        dev = self.device
        with torch.no_grad():
            logits, _ = self.model.serving_step(
                torch.as_tensor(ids).to(dev), caches,
                torch.as_tensor(positions).to(dev), last_index)
            logits = logits.float()
            if self.temperature <= 0.0:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            if self.capture_logits or self.step_fault is not None:
                nxt_np = nxt.cpu().numpy()
                logits_np = self._apply_fault(kind, seqs,
                                              logits.cpu().numpy())
                return nxt_np, logits_np
            if not self.nan_guard:
                return nxt.cpu().numpy(), None
            finite = torch.isfinite(logits[:len(seqs)]).all(-1)
            packed = torch.cat([nxt, finite.to(nxt.dtype)]).cpu().numpy()
        nxt_np, ok = packed[:len(nxt)], packed[len(nxt):]
        bad = [s.request_id for i, s in enumerate(seqs) if not ok[i]]
        if bad:
            raise _NonfiniteLogits(bad)
        return nxt_np, None

    def _apply_prefill(self, seq: SequenceState, bucket: int):
        ctx = seq.context()
        L = len(ctx)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :L] = ctx
        self._note_padding(L, bucket)
        tables = self.cache.table_array([seq.request_id],
                                        self.sched.max_blocks_per_seq)
        lens = np.asarray([L], np.int32)
        slots = self.cache.slot_array([seq.request_id], [0], bucket)
        caches = self.cache.layer_caches(tables, lens, slots)
        return self._forward("prefill", [seq], ids,
                             np.zeros((1,), np.int64), L - 1, caches)

    def _apply_decode(self, seqs: List[SequenceState]):
        # Each row writes its pending token's K/V at computed_len before it
        # attends; a probe or replay of the same row writes the same value
        # there again (it depends only on that token and the row's earlier
        # KV), and pad rows write the sentinel slot.
        B = self.max_seqs
        enforce(len(seqs) <= B, f"{len(seqs)} decode rows > max_seqs {B}")
        self._note_padding(len(seqs), B)
        sids = [s.request_id for s in seqs] + [_PAD_SEQ] * (B - len(seqs))
        ids = np.zeros((B, 1), np.int64)
        positions = np.zeros((B,), np.int64)
        lens = np.zeros((B,), np.int32)
        starts = [-1] * B
        for i, s in enumerate(seqs):
            enforce(s.pending is not None,
                    f"{s.request_id}: decode row without a pending token")
            ids[i, 0] = s.pending
            positions[i] = s.computed_len
            lens[i] = s.computed_len + 1      # includes the written token
            starts[i] = s.computed_len
        tables = self.cache.table_array(sids, self.sched.max_blocks_per_seq)
        slots = self.cache.slot_array(sids, starts, 1)
        caches = self.cache.layer_caches(tables, lens, slots)
        return self._forward("decode", seqs, ids, positions, 0, caches)

    def _rng_state(self):
        """The sampling generator's state before a step (None when greedy:
        nothing is drawn)."""
        return self._gen.get_state() if self.temperature > 0.0 else None

    def _restore_rng(self, state) -> None:
        if state is not None:
            self._gen.set_state(state)

    def _run_prefill(self, plan: StepPlan) -> List[Dict[str, Any]]:
        seq = plan.seqs[0]
        rng = self._rng_state()
        t_prefill0 = float(self.clock())
        t0 = time.perf_counter()
        try:
            nxt_np, logits_np = self._apply_prefill(seq, plan.bucket)
        except StepTimeout:
            raise                      # the watchdog owns this one
        except Exception as e:
            self._quarantine_step("prefill", [seq], e, rng)
            return []
        self._step_ms["prefill"].append((time.perf_counter() - t0) * 1e3)
        self.sched.mark_prefilled(seq)
        reg = self._reg()
        reg.counter("serve.prefills").inc()
        if seq.trace_id is not None:
            # the (re-)prefill plus the queue wait before it; a
            # recompute's wait is attributed to its cause, not "queue"
            comp = _RESUME_COMPONENT.get(seq.resume_why, "prefill")
            t_q0 = seq.trace_enqueued
            if t_q0 is None:
                t_q0 = seq.arrival
            if t_prefill0 > t_q0:
                requesttrace.emit_span(
                    reg, seq.trace_id, seq.request_id, "queue",
                    "queue" if seq.resume_why is None else comp,
                    t_q0, t_prefill0, self._proc)
            requesttrace.emit_span(reg, seq.trace_id, seq.request_id,
                                   "prefill", comp, t_prefill0,
                                   float(self.clock()), self._proc,
                                   bucket=plan.bucket)
        seq.resume_why = None
        seq.trace_enqueued = None
        if seq.pending is not None:
            # recompute prefill after preemption: the next token was
            # already sampled (and streamed) before eviction; only the KV
            # was rebuilt
            return []
        row = None if logits_np is None else logits_np[0]
        return [self._accept_token(seq, int(nxt_np[0]), row, first=True)]

    def _run_decode(self, plan: StepPlan, rng=None) -> List[Dict[str, Any]]:
        seqs = plan.seqs
        if rng is None:
            rng = self._rng_state()
        else:
            self._restore_rng(rng)     # a replay draws what the step drew
        t_clock0 = float(self.clock())
        t0 = time.perf_counter()
        try:
            nxt_np, logits_np = self._apply_decode(seqs)
        except StepTimeout:
            raise
        except Exception as e:
            survivors = self._quarantine_step("decode", seqs, e, rng)
            if not survivors:
                return []
            # replay: the culprit rows are gone, every surviving row is
            # re-run with the same pending token — per-row paged attention
            # makes the survivors' logits (and, greedy, their tokens)
            # those of the un-faulted step
            return self._run_decode(StepPlan("decode", survivors), rng)
        self._step_ms["decode"].append((time.perf_counter() - t0) * 1e3)
        reg = self._reg()
        reg.counter("serve.decode_steps").inc()
        reg.histogram("serve.decode_batch").observe(float(len(seqs)))
        events = []
        for i, s in enumerate(seqs):
            self.sched.mark_decoded(s)
            row = None if logits_np is None else logits_np[i]
            events.append(self._accept_token(s, int(nxt_np[i]), row,
                                             first=False))
        # one batch-level decode span, amortized across its residents
        requesttrace.emit_decode_span(
            reg, [(s.request_id, s.trace_id) for s in seqs], len(seqs),
            t_clock0, float(self.clock()), self._proc)
        return events

    # -- poisoned-request quarantine ---------------------------------------
    def _probe(self, seqs: List[SequenceState], rng) -> bool:
        """Re-run the decode step on a subset; True when it faults."""
        self._restore_rng(rng)
        try:
            self._apply_decode(seqs)
        except StepTimeout:
            raise
        except Exception:
            return True
        return False

    def _bisect(self, seqs: List[SequenceState],
                rng) -> List[SequenceState]:
        """Find the faulting sequence(s) by halving.  A passing half is
        exonerated (faults here are deterministic per row).  When the whole
        group faults but neither half does, the fault is an interaction —
        quarantine the whole group rather than loop."""
        if len(seqs) == 1:
            return seqs
        mid = len(seqs) // 2
        left, right = seqs[:mid], seqs[mid:]
        culprits: List[SequenceState] = []
        if self._probe(left, rng):
            culprits += self._bisect(left, rng)
        if self._probe(right, rng):
            culprits += self._bisect(right, rng)
        return culprits or seqs

    def _quarantine_step(self, kind: str, seqs: List[SequenceState],
                         error: Exception, rng) -> List[SequenceState]:
        """Fault-boundary handler: identify the culprit rows, evict each
        with ``reason="poisoned"`` and a durable record, return the
        surviving sequences for replay."""
        t0 = float(self.clock())
        if isinstance(error, _NonfiniteLogits):
            bad = set(error.request_ids)
            culprits = [s for s in seqs if s.request_id in bad]
        elif kind == "prefill" or len(seqs) == 1:
            culprits = list(seqs)
        else:
            culprits = self._bisect(seqs, rng)
        for seq in culprits:
            self._quarantine(seq, error, kind)
        # the bisect stalls every row of the faulted batch: attribute that
        # time to quarantine for culprits and survivors alike
        t1 = float(self.clock())
        reg = self._reg()
        for seq in seqs:
            requesttrace.emit_span(reg, seq.trace_id, seq.request_id,
                                   "quarantine_bisect", "quarantine",
                                   t0, t1, self._proc)
        return [s for s in seqs if s not in culprits]

    def _quarantine(self, seq: SequenceState, error: Exception,
                    kind: str) -> None:
        self.sched.evict(seq, "poisoned")
        self.lifecycle_counts["poisoned"] += 1
        record = {"request_id": seq.request_id, "reason": "poisoned",
                  "step_kind": kind, "error": repr(error),
                  "engine_step": self.steps,
                  "prompt_len": len(seq.prompt),
                  "generated": len(seq.output),
                  "output": list(seq.output),
                  "trace_id": seq.trace_id,
                  "time": float(self.clock())}
        self.quarantined[seq.request_id] = record
        reg = self._reg()
        reg.counter("serve.poisoned").inc()
        reg.emit("serve.quarantine", **record)
        self._trace_end(seq, "poisoned")
        if self.run_dir is not None:
            qdir = os.path.join(self.serve_dir(), "quarantine")
            os.makedirs(qdir, exist_ok=True)
            fname = re.sub(r"[^\w.-]", "_", seq.request_id) + ".json"
            fsio.atomic_write_bytes(
                os.path.join(qdir, fname),
                json.dumps(record, indent=1).encode())
        event = {"request_id": seq.request_id, "token": None,
                 "finished": True, "reason": "poisoned"}
        if seq.on_token is not None:
            self._dispatch_callback(seq.on_token, event, seq)

    def _accept_token(self, seq: SequenceState, token: int, logits_row,
                      first: bool) -> Dict[str, Any]:
        now = float(self.clock())
        seq.output.append(token)
        seq.pending = token
        reg = self._reg()
        if first:
            seq.first_token_time = now
            ttft = (now - seq.arrival) * 1e3
            reg.histogram("serve.ttft_ms").observe(ttft)
            self._ttft_ms.append(ttft)
        elif seq.last_token_time is not None:
            tpot = (now - seq.last_token_time) * 1e3
            reg.histogram("serve.tpot_ms").observe(tpot)
            self._tpot_ms.append(tpot)
        seq.last_token_time = now
        reg.counter("serve.tokens").inc()
        if seq.capture_logits:
            seq.logits.append(np.asarray(logits_row))
        reason = seq.should_finish()
        if reason is not None:
            self.sched.complete(seq, reason)
            reg.counter("serve.finished").inc()
            reg.emit("serve.finish", request_id=seq.request_id,
                     reason=reason, generated=len(seq.output),
                     preemptions=seq.preemptions, trace_id=seq.trace_id)
            self._trace_end(seq, reason)
        event = {"request_id": seq.request_id, "token": token,
                 "finished": reason is not None, "reason": reason}
        if seq.on_token is not None:
            self._dispatch_callback(seq.on_token, event, seq)
        return event

    # -- decoupled token callbacks ----------------------------------------
    def _dispatch_callback(self, cb: Callable, event: Dict[str, Any],
                           seq: Optional[SequenceState] = None) -> None:
        if self._cb_queue is None:
            self._cb_queue = queue.Queue()
            self._cb_thread = threading.Thread(
                target=self._cb_worker, args=(self._cb_queue,),
                name="ptpu-serve-callbacks", daemon=True)
            self._cb_thread.start()
        self._cb_dispatched += 1
        self._cb_queue.put((cb, event,
                            None if seq is None else seq.trace_id))

    def _cb_worker(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            try:
                if item is _CB_STOP:
                    return
                cb, event, trace_id = item
                cb_t0 = float(self.clock())
                try:
                    cb(event["request_id"], event["token"],
                       event["finished"])
                except Exception as e:  # consumer bug must not kill serving
                    self._cb_errors += 1
                    self._last_callback_error = \
                        f"{event['request_id']}: {e!r}"
                    reg = self._reg()
                    reg.counter("serve.callback_errors").inc()
                    reg.emit("serve.callback_error",
                             request_id=event["request_id"], error=repr(e))
                    vlog(0, "serving: on_token callback failed for %s: %r",
                         event["request_id"], e)
                requesttrace.emit_span(self._reg(), trace_id,
                                       event["request_id"], "callback",
                                       "callback", cb_t0,
                                       float(self.clock()), self._proc)
            finally:
                q.task_done()

    def _stop_callbacks(self, timeout: Optional[float] = None) -> bool:
        """Stop the callback thread after it drains the queue; True when it
        exited within the timeout (or was never started)."""
        if self._cb_thread is None:
            return True
        self._cb_queue.put(_CB_STOP)
        self._cb_thread.join(timeout=timeout)
        alive = self._cb_thread.is_alive()
        if not alive:
            self._cb_thread = None
            self._cb_queue = None
        return not alive

    def drain_callbacks(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued on_token callback ran; True when
        drained."""
        if self._cb_queue is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._cb_queue.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    # -- results ------------------------------------------------------------
    def _request_state(self, request_id: str) -> str:
        """Human-readable scheduler state for timeout / stuck messages."""
        for seq in self.sched.running:
            if seq.request_id == request_id:
                return (f"state=running, generated={len(seq.output)}/"
                        f"{seq.max_new_tokens}, "
                        f"computed_len={seq.computed_len}")
        for pos, seq in enumerate(self.sched.waiting):
            if seq.request_id == request_id:
                return (f"state={seq.state}, queue_position={pos}, "
                        f"queue_depth={len(self.sched.waiting)}")
        return "state=unknown (never submitted?)"

    def collect(self, request_id: str,
                max_steps: Optional[int] = None,
                timeout: Optional[float] = None) -> Dict[str, Any]:
        """Drive the engine until ``request_id`` finishes; return its
        result record.  ``timeout`` (seconds, wall clock) bounds the wait:
        on expiry it raises :class:`CollectTimeout` naming the request's
        current scheduler state."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while request_id not in self.sched.finished:
            enforce(self.sched.has_work(),
                    f"{request_id}: unknown request (never submitted?)")
            if deadline is not None and time.monotonic() >= deadline:
                raise CollectTimeout(
                    f"{request_id}: not finished after {timeout}s "
                    f"({self._request_state(request_id)})")
            self.step()
            if max_steps is not None:
                max_steps -= 1
                enforce(max_steps >= 0, f"{request_id}: step budget spent")
        seq = self.sched.finished[request_id]
        n = len(seq.output)
        tpot = None
        if (n > 1 and seq.first_token_time is not None
                and seq.last_token_time is not None):
            tpot = (seq.last_token_time - seq.first_token_time) / (n - 1)
        out = {"request_id": request_id, "tokens": list(seq.output),
               "finish_reason": seq.finish_reason,
               "preemptions": seq.preemptions,
               "ttft_ms": (None if seq.first_token_time is None else
                           (seq.first_token_time - seq.arrival) * 1e3),
               "tpot_ms": None if tpot is None else tpot * 1e3}
        if seq.capture_logits:
            out["logits"] = list(seq.logits)
        return out

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Submit every prompt, drain, return the generated token lists in
        submit order."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id) for p in prompts]
        self.run()
        return [self.collect(r)["tokens"] for r in rids]

    # -- graceful drain / resume -------------------------------------------
    @property
    def state(self) -> str:
        """``serving`` | ``draining`` | ``stopped`` — mirrored on
        ``/healthz`` (503 once not ``serving``)."""
        return self._state

    def begin_drain(self) -> None:
        """Stop admission without blocking: new ``submit()`` calls are
        refused, ``/healthz`` goes 503 ``draining``, already-admitted work
        keeps stepping.  Idempotent; ``drain()`` calls it first."""
        if self._state != "serving":
            return
        self._state = "draining"
        self.sched.admission_open = False
        c = self.sched.counts()
        self._reg().emit("serve.drain_begin", running=c["running"],
                         waiting=c["waiting"])

    def drain(self, timeout: Optional[float] = None,
              spill_path: Optional[str] = None) -> Dict[str, Any]:
        """Graceful shutdown: stop admission, finish what fits inside
        ``timeout`` (default ``PTPU_SERVE_DRAIN_SECS``), spill the rest to
        ``spill_path`` (default ``<run_dir>/serve/replica-<i>/spill.json``)
        as a JSON file a fresh engine can :meth:`resume` from, stop the
        callback thread, and mark the engine ``stopped``.  The report
        carries the spill records inline (``"spilled_records"``)."""
        if timeout is None:
            timeout = default_drain_secs()
        self.begin_drain()
        hard = time.monotonic() + float(timeout)
        timed_out = False
        finished = 0
        while (self.sched.running
               or any(s.output for s in self.sched.waiting)):
            if time.monotonic() >= hard:
                timed_out = True
                break
            before = len(self.sched.finished)
            self.step()
            finished += len(self.sched.finished) - before
        # spill whatever is still live — running sequences that ran out of
        # time spill too (their tokens ride along; resume recomputes their
        # KV and continues decoding)
        leftovers = list(self.sched.running) + list(self.sched.waiting)
        spilled = []
        for seq in leftovers:
            spilled.append({"request_id": seq.request_id,
                            "prompt": list(seq.prompt),
                            "output": list(seq.output),
                            "max_new_tokens": seq.max_new_tokens,
                            "eos_token_id": seq.eos_token_id,
                            "preemptions": seq.preemptions,
                            # trace context survives the spill; ownership
                            # moves to whichever engine resumes it
                            "trace_id": seq.trace_id,
                            "trace_owner": seq.request_id in
                            self._trace_owned,
                            "resume_why": "migration"})
            self._trace_owned.discard(seq.request_id)
            self.sched.evict(seq, "spilled")
            self.lifecycle_counts["spilled"] += 1
            self._reg().counter("serve.spilled").inc()
        if spilled:
            if spill_path is None and self.run_dir is not None:
                os.makedirs(self.serve_dir(), exist_ok=True)
                spill_path = os.path.join(self.serve_dir(), "spill.json")
            enforce(spill_path is not None,
                    "drain spilled requests but no spill_path was given "
                    "and the engine has no run_dir")
            fsio.atomic_write_bytes(
                spill_path,
                json.dumps({"version": 1, "spilled": spilled},
                           indent=1).encode())
        callbacks_stopped = self._stop_callbacks(timeout=5.0)
        self._state = "stopped"
        self._reg().emit("serve.drain_end", finished=finished,
                         spilled=len(spilled), timed_out=timed_out)
        self._update_gauges()
        return {"finished": finished, "spilled": len(spilled),
                "spill_path": spill_path if spilled else None,
                "spilled_records": spilled,
                "timed_out": timed_out,
                "callbacks_stopped": callbacks_stopped}

    def admit_record(self, record: Dict[str, Any]) -> str:
        """Admit one spill-format record (``request_id`` / ``prompt`` /
        ``output`` / ``max_new_tokens`` / ``eos_token_id``) into this
        serving engine.  The generated ``output`` is kept and its newest
        token becomes ``pending``, so the recompute-prefill path rebuilds
        the KV and decoding continues token-exact.  Returns the request id.

        Idempotent on ``request_id``: a record the engine already holds
        (running, waiting or finished) is not admitted again."""
        enforce(self._state == "serving",
                f"admit_record() needs a serving engine "
                f"(state={self._state})")
        rid = record["request_id"]
        if rid in self.sched.finished or any(
                s.request_id == rid for s in
                list(self.sched.running) + list(self.sched.waiting)):
            self._reg().counter("serve.readmit_dupes").inc()
            return rid
        seq = SequenceState(
            request_id=record["request_id"],
            prompt=[int(t) for t in record["prompt"]],
            max_new_tokens=int(record["max_new_tokens"]),
            eos_token_id=record.get("eos_token_id"),
            arrival=float(self.clock()),
            capture_logits=self.capture_logits)
        seq.output = [int(t) for t in record.get("output", [])]
        seq.pending = seq.output[-1] if seq.output else None
        seq.preemptions = int(record.get("preemptions", 0))
        # keep the record's trace_id (an explicit None is a decision that
        # survives); only a record without the key gets a minted trace
        if "trace_id" in record:
            seq.trace_id = record["trace_id"]
            if seq.trace_id is not None and record.get("trace_owner"):
                self._trace_owned.add(rid)
        else:
            seq.trace_id = requesttrace.mint_trace_id(rid)
            if seq.trace_id is not None:
                self._trace_owned.add(rid)
                self._reg().emit("trace.request", trace_id=seq.trace_id,
                                 request_id=rid, t0=seq.arrival,
                                 prompt_len=len(seq.prompt),
                                 proc=self._proc)
        if seq.output:
            seq.resume_why = record.get("resume_why") or "failover"
        self.sched.submit(seq)
        self._submit_order.append(seq.request_id)
        self._reg().counter("serve.resumed").inc()
        self._update_gauges()
        return seq.request_id

    def resume(self, spill_path: Optional[str] = None) -> List[str]:
        """Re-admit a drain spill file into this (fresh, serving) engine;
        returns the resumed request ids.  Without ``spill_path`` the engine
        reads ``<run_dir>/serve/replica-<i>/spill.json``, falling back to
        the legacy ``<run_dir>/serve_spill.json``."""
        enforce(self._state == "serving",
                f"resume() needs a serving engine (state={self._state})")
        if spill_path is None:
            enforce(self.run_dir is not None,
                    "resume() without a spill_path needs a run_dir")
            spill_path = os.path.join(self.serve_dir(), "spill.json")
            if not os.path.exists(spill_path):
                legacy = os.path.join(self.run_dir, "serve_spill.json")
                enforce(os.path.exists(legacy),
                        f"no spill file at {spill_path} or {legacy}")
                spill_path = legacy
        payload = json.loads(fsio.read_bytes(spill_path).decode())
        enforce(payload.get("version") == 1,
                f"unknown spill-file version {payload.get('version')!r}")
        return [self.admit_record(rec) for rec in payload["spilled"]]

    # -- observability ------------------------------------------------------
    def _note_padding(self, real: int, total: int) -> None:
        """One padded launch (prefill bucket or fixed decode batch):
        ``real`` of ``total`` token slots carried work."""
        real = max(0, int(real))
        total = max(real, int(total))
        self._pad_real_tokens += real
        self._pad_slot_tokens += total
        reg = self._reg()
        reg.counter("serve.tokens_real").inc(real)
        reg.counter("serve.tokens_padded").inc(total - real)
        if self._pad_slot_tokens:
            reg.gauge("serve.padding_frac").set(
                1.0 - self._pad_real_tokens / self._pad_slot_tokens)

    def padding_frac(self) -> float:
        """Cumulative fraction of launched token slots that were pad (0.0
        before any launch)."""
        if not self._pad_slot_tokens:
            return 0.0
        return 1.0 - self._pad_real_tokens / self._pad_slot_tokens

    def _update_gauges(self) -> None:
        reg = self._reg()
        c = self.sched.counts()
        reg.gauge("serve.queue_depth").set(float(self.sched.queue_depth))
        reg.gauge("serve.waiting").set(float(c["waiting"]))
        reg.gauge("serve.running").set(float(c["running"]))
        reg.gauge("serve.kv_occupancy").set(self.cache.occupancy())
        reg.gauge("serve.kv_blocks_used").set(
            float(self.cache.allocator.num_used))
        reg.gauge("serve.shed").set(1.0 if self.should_shed() else 0.0)

    def stats(self) -> Dict[str, Any]:
        """Engine-state snapshot for ``/statusz``: queues, pool geometry,
        shed state, padding, latency tails, the resilience section, and the
        host wall time of each step kind (``step_ms``: prefill / decode,
        completed steps only)."""
        c = self.sched.counts()
        leak = self.cache.leak_report()
        return {
            "steps": self.steps,
            "replica_id": self.replica_id,
            "queue_depth": self.sched.queue_depth,
            "waiting": c["waiting"],
            "running": c["running"],
            "finished": c["finished"],
            "preemptions": c["preemptions"],
            "max_seqs": self.max_seqs,
            "max_model_len": self.max_model_len,
            "kv_block_size": self.cache.block_size,
            "kv_blocks": {"total": self.cache.num_blocks,
                          "used": self.cache.allocator.num_used,
                          "occupancy": self.cache.occupancy(),
                          "high_water": leak["high_water"],
                          "leaked": leak["leaked_blocks"],
                          "balanced": leak["balanced"]},
            "load_shed": {"active": self.should_shed(),
                          "queue_threshold": self.shed_queue_depth},
            "padding": {"real_tokens": self._pad_real_tokens,
                        "padded_slots": self._pad_slot_tokens,
                        "frac": self.padding_frac()},
            "slo": {"ttft_ms": {"p50": _pctl(self._ttft_ms, 50),
                                "p99": _pctl(self._ttft_ms, 99),
                                "samples": len(self._ttft_ms)},
                    "tpot_ms": {"p50": _pctl(self._tpot_ms, 50),
                                "p99": _pctl(self._tpot_ms, 99),
                                "samples": len(self._tpot_ms)}},
            "step_ms": {k: {"p50": _pctl(v, 50), "count": len(v)}
                        for k, v in self._step_ms.items()},
            "resilience": {
                "state": self._state,
                "deadline_misses": self.lifecycle_counts["deadline"],
                "cancelled": self.lifecycle_counts["cancelled"],
                "poisoned": self.lifecycle_counts["poisoned"],
                "spilled": self.lifecycle_counts["spilled"],
                "watchdog_restarts": self.watchdog_restarts,
                "quarantined": sorted(self.quarantined),
                "callbacks": {"dispatched": self._cb_dispatched,
                              "errors": self._cb_errors,
                              "last_error": self._last_callback_error},
            },
        }

    def defrag(self) -> bool:
        """Compact the KV pool (see ``PagedKVCache.defrag``)."""
        return self.cache.defrag()

    def start_status_server(self, port: int = 0, host: str = "0.0.0.0"):
        """Expose the engine on a :class:`~paddle_tpu_torch.observability.
        monitor.StatusServer`; returns the server (``.port`` holds the
        bound port)."""
        from ..observability.monitor import StatusServer
        self.status_server = StatusServer(port=port, host=host,
                                          registry=self._registry,
                                          engine=self).start()
        return self.status_server

    def stop(self) -> None:
        self._stop_callbacks(timeout=1.0)
        if self._owns_watchdog and self._watchdog is not None:
            self._watchdog.close()
        self._watchdog = None
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
        self._state = "stopped"
