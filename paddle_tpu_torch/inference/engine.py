"""ServingEngine: the continuous-batching serving loop, the port of the core
of ``paddle_tpu/inference/engine.py``.

    engine = ServingEngine(model, max_seqs=8, kv_block_size=16)
    rid = engine.submit([1, 5, 9], max_new_tokens=32)
    while engine.step():            # one prefill OR one decode batch
        ...
    out = engine.collect(rid)       # {"tokens": [...], "ttft_ms": ...}

Pieces: ``kv_cache.PagedKVCache`` (block-pooled KV with per-sequence
tables), ``scheduler.ContinuousBatchingScheduler`` (admission by block
budget, newest-first preemption, prefill/decode interleaving), the model's
``serving_step`` (paged-decode kernel and, with ``use_fused_block``, the
fused-block kernels) and this module: step execution, sampling, TTFT/TPOT
and the submit / step / run / collect / generate surface.

Step shapes come from a closed set, as in the JAX engine: decode is always
``(max_seqs, 1)``; prefill is padded to power-of-two buckets.

Sampling is greedy at ``temperature <= 0``; above it, tokens are drawn from
``softmax(logits / temperature)`` with a ``torch.Generator`` seeded by
``seed`` (its stream differs from the JAX engine's PRNG).

Not in this slice (see ROADMAP.md): deadlines and cancel, quarantine and
bisection, drain / spill / resume / admit_record, the watchdog, token
callbacks, registry metrics, request tracing, the status server and defrag.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.errors import enforce
from .kv_cache import PagedKVCache
from .scheduler import ContinuousBatchingScheduler, SequenceState, StepPlan

__all__ = ["ServingEngine"]

_PAD_SEQ = "__pad__"          # never a real request id


def _pctl(values, p: float) -> Optional[float]:
    """Nearest-rank percentile over a small sample; None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(len(ordered) * p / 100.0))
    return float(ordered[idx])


class ServingEngine:
    """Paged-KV continuous-batching serving engine over a model exposing the
    ``GPTForCausalLM`` serving surface: ``.config``, ``.device``,
    ``.eval()`` and ``serving_step(ids, caches, positions, last_index)``
    returning ``(logits, caches)``.

    The engine runs on the model's device.  ``capture_logits=True`` keeps
    every sampled position's logits row on the host per request (the
    numerics hook for tests).
    """

    def __init__(self, model, *, max_seqs: int = 8,
                 kv_block_size: int = 16,
                 num_kv_blocks: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 temperature: float = 0.0,
                 capture_logits: bool = False,
                 seed: int = 0,
                 clock: Callable[[], float] = time.time):
        cfg = model.config
        self.model = model
        model.eval()
        self.device = model.device
        self.max_seqs = int(max_seqs)
        self.max_model_len = int(max_model_len if max_model_len is not None
                                 else cfg.max_position_embeddings)
        enforce(self.max_model_len <= cfg.max_position_embeddings,
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"{cfg.max_position_embeddings} positions")
        block_size = int(kv_block_size)
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
        self.clock = clock
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._ids = itertools.count()
        self.steps = 0
        self._ttft_ms: Deque[float] = deque(maxlen=512)
        self._tpot_ms: Deque[float] = deque(maxlen=512)
        self._step_ms: Dict[str, List[float]] = {"prefill": [], "decode": []}

    # -- intake ------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               request_id: Optional[str] = None,
               eos_token_id: Optional[int] = None) -> str:
        """Queue one request; returns its id."""
        rid = request_id or f"req-{next(self._ids)}"
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        seq = SequenceState(request_id=rid, prompt=prompt,
                            max_new_tokens=int(max_new_tokens),
                            eos_token_id=eos_token_id,
                            arrival=float(self.clock()),
                            capture_logits=self.capture_logits)
        self.sched.submit(seq)
        return rid

    # -- the step ----------------------------------------------------------
    def step(self) -> List[Dict[str, Any]]:
        """Run one scheduler-chosen unit of work (one prefill or one decode
        batch).  Returns the token events produced; empty when idle."""
        plan = self.sched.schedule()
        events: List[Dict[str, Any]] = []
        if plan.kind == "prefill":
            events = self._run_prefill(plan)
        elif plan.kind == "decode":
            events = self._run_decode(plan)
        self.steps += 1
        return events

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
    # the host without touching scheduler state; only the KV pages change
    # (in place, see GPTAttention._paged_cache_forward), so a failed step
    # leaves nothing behind that a later step would read.

    def _forward(self, ids: np.ndarray, positions: np.ndarray,
                 last_index: int, caches):
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
        logits_np = logits.cpu().numpy() if self.capture_logits else None
        return nxt.cpu().numpy(), logits_np

    def _apply_prefill(self, seq: SequenceState, bucket: int):
        ctx = seq.context()
        L = len(ctx)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :L] = ctx
        tables = self.cache.table_array([seq.request_id],
                                        self.sched.max_blocks_per_seq)
        lens = np.asarray([L], np.int32)
        slots = self.cache.slot_array([seq.request_id], [0], bucket)
        caches = self.cache.layer_caches(tables, lens, slots)
        return self._forward(ids, np.zeros((1,), np.int64), L - 1, caches)

    def _apply_decode(self, seqs: List[SequenceState]):
        B = self.max_seqs
        enforce(len(seqs) <= B, f"{len(seqs)} decode rows > max_seqs {B}")
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
        return self._forward(ids, positions, 0, caches)

    def _run_prefill(self, plan: StepPlan) -> List[Dict[str, Any]]:
        seq = plan.seqs[0]
        t0 = time.perf_counter()
        nxt_np, logits_np = self._apply_prefill(seq, plan.bucket)
        self._step_ms["prefill"].append((time.perf_counter() - t0) * 1e3)
        self.sched.mark_prefilled(seq)
        if seq.pending is not None:
            # recompute prefill after preemption: the next token was already
            # sampled before eviction; only the KV was rebuilt
            return []
        row = None if logits_np is None else logits_np[0]
        return [self._accept_token(seq, int(nxt_np[0]), row, first=True)]

    def _run_decode(self, plan: StepPlan) -> List[Dict[str, Any]]:
        seqs = plan.seqs
        t0 = time.perf_counter()
        nxt_np, logits_np = self._apply_decode(seqs)
        self._step_ms["decode"].append((time.perf_counter() - t0) * 1e3)
        events = []
        for i, s in enumerate(seqs):
            self.sched.mark_decoded(s)
            row = None if logits_np is None else logits_np[i]
            events.append(self._accept_token(s, int(nxt_np[i]), row,
                                             first=False))
        return events

    def _accept_token(self, seq: SequenceState, token: int, logits_row,
                      first: bool) -> Dict[str, Any]:
        now = float(self.clock())
        seq.output.append(token)
        seq.pending = token
        if first:
            seq.first_token_time = now
            self._ttft_ms.append((now - seq.arrival) * 1e3)
        elif seq.last_token_time is not None:
            self._tpot_ms.append((now - seq.last_token_time) * 1e3)
        seq.last_token_time = now
        if seq.capture_logits:
            seq.logits.append(np.asarray(logits_row))
        reason = seq.should_finish()
        if reason is not None:
            self.sched.complete(seq, reason)
        return {"request_id": seq.request_id, "token": token,
                "finished": reason is not None, "reason": reason}

    # -- results ------------------------------------------------------------
    def collect(self, request_id: str,
                max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Drive the engine until ``request_id`` finishes; return its
        result record."""
        while request_id not in self.sched.finished:
            enforce(self.sched.has_work(),
                    f"{request_id}: unknown request (never submitted?)")
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

    def stats(self) -> Dict[str, Any]:
        """Engine-state snapshot: queues, pool, latency tails and the host
        wall time of each step kind (prefill / decode, ms)."""
        c = self.sched.counts()
        leak = self.cache.leak_report()
        return {
            "steps": self.steps,
            "waiting": c["waiting"],
            "running": c["running"],
            "finished": c["finished"],
            "preemptions": c["preemptions"],
            "max_seqs": self.max_seqs,
            "max_model_len": self.max_model_len,
            "kv_block_size": self.cache.block_size,
            "kv_blocks": {"total": self.cache.num_blocks,
                          "used": self.cache.allocator.num_used,
                          "high_water": leak["high_water"],
                          "leaked": leak["leaked_blocks"],
                          "balanced": leak["balanced"]},
            "slo": {"ttft_ms": {"p50": _pctl(self._ttft_ms, 50),
                                "p99": _pctl(self._ttft_ms, 99)},
                    "tpot_ms": {"p50": _pctl(self._tpot_ms, 50),
                                "p99": _pctl(self._tpot_ms, 99)}},
            "step_ms": {k: {"p50": _pctl(v, 50), "count": len(v)}
                        for k, v in self._step_ms.items()},
        }
