"""Continuous-batching scheduler: the port's own copy of ``paddle_tpu/
inference/scheduler.py`` (host-only there too).

Every ``schedule()`` re-forms the batch: finished sequences leave at once,
waiting ones are admitted as soon as KV blocks allow.

Sequence lifecycle::

    WAITING --admit(prefill)--> RUNNING --eos/max_tokens--> FINISHED
       ^                          |                            ^
       +------- PREEMPTED <-- OOM on next-token block          |
       |                                                       |
       +--- cancel / deadline / poisoned / spilled (evict) ----+

Terminal reasons beyond ``eos`` / ``max_new_tokens``: ``cancelled`` and
``deadline`` land through the engine's between-steps reaper, ``poisoned``
through the fault-boundary quarantine, ``spilled`` through graceful drain.
All of them go through :meth:`ContinuousBatchingScheduler.evict`, which
frees the sequence's blocks from any live state.

- **Admission** is by KV-block budget: a sequence is admitted only when the
  allocator can hold its whole prefill context now (all-or-nothing).
  Preempted sequences re-admit ahead of new arrivals.
- **Preemption** frees the victim's whole table (recompute-style: its
  tokens so far become the new, longer prefill prompt).  Victims are taken
  newest-admitted first, so the oldest running sequence always finishes.
- **Interleaving**: each ``schedule()`` returns ONE prefill (padded to a
  power-of-two bucket) or one decode batch over the running set.
- **Drain gate**: with ``admission_open`` False only sequences that already
  produced output (preempted ones) re-admit; fresh arrivals wait.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..framework.errors import enforce
from .kv_cache import PagedKVCache

__all__ = ["WAITING", "RUNNING", "PREEMPTED", "FINISHED", "SequenceState",
           "StepPlan", "ContinuousBatchingScheduler", "prefill_bucket"]

WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"

_MIN_BUCKET = 8


def prefill_bucket(length: int, cap: int) -> int:
    """Smallest power of two >= ``length`` (floor ``_MIN_BUCKET``), capped
    at ``cap`` — the closed set of prefill step shapes."""
    enforce(0 < length <= cap, f"prefill length {length} outside (0, {cap}]")
    b = _MIN_BUCKET
    while b < length:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class SequenceState:
    """One request's scheduling state.

    - ``prompt``: the submitted prompt ids (never mutated);
    - ``output``: every token generated so far;
    - ``context()``: the tokens whose KV must be cached before the next
      decode step — prompt + output except ``pending`` (the newest sampled
      token, whose KV the step that feeds it back in writes);
    - ``computed_len``: cache entries on the device for this sequence (0
      after preemption — recompute rebuilds them).
    """
    request_id: str
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival: float = 0.0
    on_token: Optional[Callable] = None
    capture_logits: bool = False

    # absolute clock() times, computed by the engine from submit()'s
    # relative deadline_ms / ttft_deadline_ms
    deadline: Optional[float] = None
    ttft_deadline: Optional[float] = None
    cancelled: bool = False

    state: str = WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    pending: Optional[int] = None
    computed_len: int = 0
    logits: List = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_reason: Optional[str] = None
    preemptions: int = 0

    # request tracing: ``trace_id`` rides every span this sequence emits;
    # ``resume_why`` marks a recompute's cause ("preempt" / "failover" /
    # "migration") so the next prefill span is attributed to it;
    # ``trace_enqueued`` is the time the sequence (re-)entered the waiting
    # queue, the start of its next queue span
    trace_id: Optional[str] = None
    resume_why: Optional[str] = None
    trace_enqueued: Optional[float] = None

    def context(self) -> List[int]:
        toks = list(self.prompt) + list(self.output)
        return toks[:-1] if self.pending is not None else toks

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)

    def should_finish(self) -> Optional[str]:
        if (self.eos_token_id is not None and self.output
                and self.output[-1] == self.eos_token_id):
            return "eos"
        if len(self.output) >= self.max_new_tokens:
            return "max_new_tokens"
        return None


@dataclasses.dataclass
class StepPlan:
    """What the engine runs this step."""
    kind: str                               # "prefill" | "decode" | "idle"
    seqs: List[SequenceState]
    bucket: int = 0                         # prefill pad length
    preempted: List[SequenceState] = dataclasses.field(default_factory=list)


class ContinuousBatchingScheduler:
    """Admission / preemption / interleaving policy over a
    :class:`PagedKVCache`'s allocator.  The engine loop is ``plan =
    schedule(); run(plan)``, then ``mark_prefilled`` / ``mark_decoded`` /
    ``complete``.  The scheduler never touches device tensors."""

    def __init__(self, cache: PagedKVCache, max_seqs: int,
                 max_model_len: int, clock: Callable[[], float] = time.time):
        enforce(max_seqs >= 1, "max_seqs must be >= 1")
        self.cache = cache
        self.max_seqs = int(max_seqs)
        self.max_model_len = int(max_model_len)
        self.max_blocks_per_seq = cache.allocator.blocks_for_tokens(
            self.max_model_len)
        self.clock = clock
        self.waiting: Deque[SequenceState] = deque()
        self.running: List[SequenceState] = []
        self.finished: Dict[str, SequenceState] = {}
        self.preemptions = 0
        # drain gate: closed admission still lets preempted sequences
        # (anything that already produced output) re-admit
        self.admission_open = True

    def submit(self, seq: SequenceState) -> None:
        worst = len(seq.prompt) + seq.max_new_tokens
        enforce(worst <= self.max_model_len,
                f"{seq.request_id}: prompt {len(seq.prompt)} + max_new "
                f"{seq.max_new_tokens} exceeds max_model_len "
                f"{self.max_model_len}")
        enforce(self.cache.allocator.blocks_for_tokens(worst)
                <= self.cache.num_blocks,
                f"{seq.request_id}: needs more KV blocks than the whole "
                f"pool holds ({self.cache.num_blocks})")
        enforce(len(seq.prompt) >= 1, f"{seq.request_id}: empty prompt")
        seq.state = WAITING
        seq.arrival = seq.arrival or float(self.clock())
        if seq.trace_enqueued is None:
            seq.trace_enqueued = seq.arrival
        self.waiting.append(seq)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def schedule(self) -> StepPlan:
        """One prefill when a waiting sequence fits the block budget and a
        batch slot, else one decode batch over the running set (preempting
        on next-token OOM), else idle."""
        plan_preempted: List[SequenceState] = []

        if (self.waiting and len(self.running) < self.max_seqs
                and (self.admission_open or self.waiting[0].output)):
            seq = self.waiting[0]
            ctx = len(seq.context())
            need = self.cache.allocator.blocks_for_tokens(ctx)
            if (need <= self.max_blocks_per_seq
                    and self.cache.ensure_capacity(seq.request_id, ctx)):
                self.waiting.popleft()
                seq.state = RUNNING
                self.running.append(seq)
                bucket = prefill_bucket(ctx, self.max_model_len)
                return StepPlan("prefill", [seq], bucket=bucket)

        if self.running:
            survivors: List[SequenceState] = []
            for seq in list(self.running):
                if seq.state != RUNNING:
                    continue      # already preempted as a victim above
                # a decode step writes the pending token's KV at position
                # computed_len — grow the table to cover it, preempting the
                # newest-admitted sequences on OOM
                while not self.cache.ensure_capacity(
                        seq.request_id, seq.computed_len + 1):
                    victim = self.running[-1]
                    self._preempt(victim)
                    plan_preempted.append(victim)
                    if victim is seq:
                        break
                else:
                    survivors.append(seq)
            if survivors:
                return StepPlan("decode", survivors,
                                preempted=plan_preempted)
        return StepPlan("idle", [], preempted=plan_preempted)

    def _preempt(self, seq: SequenceState) -> None:
        self.running.remove(seq)
        self.cache.free_seq(seq.request_id)
        seq.computed_len = 0
        seq.state = PREEMPTED
        seq.preemptions += 1
        self.preemptions += 1
        # the wait and re-prefill this preemption causes belong to it
        seq.resume_why = "preempt"
        seq.trace_enqueued = float(self.clock())
        self.waiting.appendleft(seq)    # re-admits before new arrivals

    def preempt_all(self) -> List[SequenceState]:
        """Evict every running sequence back to the queue (recompute): the
        engine's hang recovery.  Host state stays consistent because the
        engine's feedback (``mark_*``) lands only after a step returns.
        Newest first, so re-admission replays the admission order."""
        victims = list(reversed(self.running))
        for seq in victims:
            self._preempt(seq)
        return victims

    def mark_prefilled(self, seq: SequenceState) -> None:
        seq.computed_len = len(seq.context())

    def mark_decoded(self, seq: SequenceState) -> None:
        seq.computed_len += 1

    def complete(self, seq: SequenceState, reason: str) -> None:
        """Retire a finished sequence and free its blocks at once, so the
        next schedule() can admit into the reclaimed space."""
        self.evict(seq, reason)

    def evict(self, seq: SequenceState, reason: str) -> None:
        """Terminal eviction from any live state — finish, cancel,
        deadline, quarantine and drain-spill all exit through here: remove
        the sequence from whichever queue holds it, free its blocks,
        record the reason, file it under ``finished``."""
        if seq in self.running:
            self.running.remove(seq)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                pass
        self.cache.free_seq(seq.request_id)
        seq.state = FINISHED
        seq.finish_reason = reason
        self.finished[seq.request_id] = seq

    def counts(self) -> Dict[str, int]:
        return {"waiting": len(self.waiting),
                "running": len(self.running),
                "finished": len(self.finished),
                "preemptions": self.preemptions}
