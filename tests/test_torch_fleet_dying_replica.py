"""A dying fleet worker must not stall the other streams, and a traced
submission is covered from its first instant.

1. Two HTTP engine workers on the CPU; once replica 0 holds an unfinished
   stream with 2 accepted tokens the manager signals it with SIGSTOP: the
   worker stops answering but keeps its listening socket, as a worker
   tearing down a large device context does for seconds after a SIGKILL.
   Every call to it would wait out ``HttpReplica``'s 5 s timeout; the
   router must fail its streams over without making one, so the streams
   on replica 1 never go 5 s without a token, and every stream finishes
   token-exact against one uninterrupted engine.
2. The router's first dispatch span opens at the submission, so the
   journal's write-ahead record before it is covered time: with a slow
   journal the trace still reaches the assembler's 0.95 coverage.
"""
from __future__ import annotations

import signal
import time

import pytest

from paddle_tpu_torch.inference import ServingEngine, fleet
from paddle_tpu_torch.inference.fleet import drills
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import requesttrace as trt
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.observability.sinks import MetricsWriter, metrics_dir

# HttpReplica's default timeout; a stall this long is one blocked call
STALL_S = 5.0


def test_a_signalled_worker_does_not_stall_the_other_streams(tmp_path):
    spec = {**drills.SPEC, "device": "cpu",
            "config": {**drills.SPEC["config"],
                       "max_position_embeddings": 128}}
    prompts = [[1, 2, 3 + i] for i in range(6)]
    max_new = 96
    reg = MetricsRegistry()
    mgr = fleet.ReplicaManager(spec, replicas=2, registry=reg,
                               run_dir=str(tmp_path),
                               env={"OMP_NUM_THREADS": "1"})
    mgr.start()
    stopped = None
    try:
        router = fleet.Router(mgr.replicas, manager=mgr, registry=reg)
        rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        # (wall, tokens) of every stream after each pump
        seen = {r: [] for r in rids}
        deadline = time.monotonic() + 120
        while router.pump() > 0:
            assert time.monotonic() < deadline, "fleet did not drain"
            now = time.monotonic()
            for r in rids:
                seen[r].append((now, len(router.journals[r].tokens)))
            if stopped is None and any(
                    len(j.tokens) >= 2 for j in router.journals.values()
                    if j.replica_id == 0 and not j.finished):
                stopped = {r for r in rids
                           if router.journals[r].replica_id == 0
                           and not router.journals[r].finished}
                t_stop = time.monotonic()
                mgr.kill(0, signal.SIGSTOP)
            time.sleep(0.002)
        assert stopped, "replica 0 never held a stream"
        assert router.failovers >= len(stopped)
        outs = [router.journals[r].tokens for r in rids]
    finally:
        mgr.stop()
    survivors = [r for r in rids if r not in stopped]
    assert survivors, "every stream was on replica 0"
    for r in survivors:
        # the gaps between a stream's token arrivals after the signal
        times = [t for (t, n), (_, m) in zip(seen[r][1:], seen[r])
                 if n > m and t >= t_stop]
        gaps = [b - a for a, b in zip([t_stop] + times, times)]
        assert not gaps or max(gaps) < STALL_S / 2, (r, max(gaps))
    want = drills.reference_outputs(spec, prompts, max_new)
    assert [list(o) for o in outs] == want


class _SlowStore:
    """A journal whose write-ahead ``open`` takes ``delay`` seconds."""

    def __init__(self, store, delay: float):
        self._store, self._delay = store, delay

    def open(self, *a, **kw):
        time.sleep(self._delay)
        return self._store.open(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._store, name)


def test_the_first_dispatch_span_covers_the_journal_write(tmp_path):
    model = GPTForCausalLM(gpt_tiny(hidden_dropout=0.0,
                                    attention_dropout=0.0), device="cpu")
    run_dir = str(tmp_path / "run")
    reg = MetricsRegistry()
    writer = reg.add_sink(MetricsWriter(metrics_dir(run_dir), worker_id=0,
                                        flush_every=1))
    reps = [fleet.LocalReplica(ServingEngine(model, registry=reg,
                                             replica_id=0, max_seqs=4,
                                             kv_block_size=4,
                                             max_model_len=64),
                               replica_id=0)]
    router = fleet.Router(reps, registry=reg, run_dir=run_dir)
    router.store = _SlowStore(router.store, 0.05)
    rid = router.submit([1, 2, 3], max_new_tokens=4)
    router.collect(rid, timeout=60)
    reg.remove_sink(writer)
    (trace,) = trt.assemble_run(run_dir)["traces"]
    first = min(trace["spans"], key=lambda s: s["t0"])
    assert first["name"] == "dispatch"
    # the 50 ms journal write is inside the dispatch span, not a gap
    assert first["dur_ms"] >= 50.0
    assert trace["coverage"] >= 0.95, trace["coverage"]
