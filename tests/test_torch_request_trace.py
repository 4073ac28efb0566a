"""CPU parity of the port's request-trace assembly
(``paddle_tpu_torch/observability/requesttrace.py``: ``TraceAssembler``,
``assemble_run``, ``tail_latency_attribution``, the Chrome export and
the CLI) with the JAX package's.

The assembler is pure-Python arithmetic over ``trace.*`` records, so the
same records give **equal** results in both packages.  The slice as a
whole: one port ``ServingEngine`` run at gpt_tiny with tracing on and a
hand-driven clock emits the records the JAX engine emits on the same
prompts and weights (trace ids aside, which are uuid4: ``_norm`` renames
them in order of appearance), and both assemblers turn the port's records
into the traces the JAX engine's records give.  A port fleet with a
replica stopped mid-stream, journaled and streamed to disk, assembles
equally in both packages through ``assemble_run`` and the CLI."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability import requesttrace as jrt
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import fleet
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import requesttrace as trt
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.observability.sinks import MetricsWriter, metrics_dir
from paddle_tpu_torch.testing import faults

MODEL_KW = dict(hidden_dropout=0.0, attention_dropout=0.0,
                use_fused_block=True, dtype="float32")
ENGINE_KW = dict(max_seqs=4, kv_block_size=4, max_model_len=64)
PROMPT_LENS = (5, 12, 3, 9, 7, 4)
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracing(monkeypatch):
    monkeypatch.setenv("PTPU_TRACE_REQUESTS", "1")
    monkeypatch.delenv("PTPU_TRACE_SAMPLE", raising=False)
    dist.set_hybrid_communicate_group(None)


class _Sink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def flush(self):
        pass

    def close(self):
        pass


def _span(tid, rid, name, comp, t0, t1, proc):
    return {"kind": "trace.span", "trace_id": tid, "request_id": rid,
            "name": name, "component": comp, "t0": t0, "t1": t1,
            "dur_ms": (t1 - t0) * 1e3, "proc": proc}


def _open(tid, rid, t0):
    return {"kind": "trace.request", "trace_id": tid, "request_id": rid,
            "t0": t0, "prompt_len": 3, "proc": "router"}


def _end(tid, rid, t1):
    return {"kind": "trace.request_end", "trace_id": tid,
            "request_id": rid, "t1": t1, "reason": "length", "tokens": 4,
            "proc": "router"}


def _norm(records):
    """Trace ids renamed in order of appearance (they are uuid4)."""
    ids = {}

    def n(tid):
        if tid is None:
            return None
        return ids.setdefault(tid, f"trace-{len(ids)}")

    out = []
    for r in records:
        rec = {k: (n(v) if k == "trace_id" else v) for k, v in r.items()
               if k != "error"}
        if "requests" in rec:
            rec["requests"] = [[a, n(b)] for a, b in rec["requests"]]
        out.append(rec)
    return out


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


# -- the assembler on hand-written records ---------------------------------
_CASES = {
    "amortized_decode": [
        _open("t1", "r1", 0.0), _open("t2", "r2", 0.0),
        {"kind": "trace.span", "name": "decode_batch", "component":
         "decode", "t0": 0.0, "t1": 0.1, "dur_ms": 100.0,
         "proc": "replica-0", "residents": 4,
         "requests": [["r1", "t1"], ["r2", "t2"], ["r3", None], [], None]},
        _end("t1", "r1", 0.1), _end("t2", "r2", 0.1)],
    "orphan": [_span("ghost", "rg", "prefill", "prefill", 0.0, 0.1,
                     "replica-0")],
    "coverage": [
        _open("t1", "r1", 0.0),
        _span("t1", "r1", "prefill", "prefill", 0.0, 0.4, "replica-0"),
        _span("t1", "r1", "queue", "queue", 0.3, 0.5, "replica-0"),
        _end("t1", "r1", 1.0)],
    "deliver_residue": [
        _open("t1", "r1", 0.0),
        _span("t1", "r1", "dispatch", "dispatch", 0.0, 0.01, "router"),
        _span("t1", "r1", "prefill", "prefill", 0.01, 0.2, "replica-0"),
        _span("t1", "r1", "deliver", "deliver", 0.01, 0.5, "router"),
        _span("t1", "r1", "prefill", "failover", 0.3, 0.4, "replica-1"),
        _end("t1", "r1", 0.5), _end("t1", "r1", 0.45)],
    "open_only": [_open("t1", "r1", 0.0), _open("t1", "r1", -1.0),
                  _span("t1", "r1", "queue", "queue", 0.0, 0.2,
                        "replica-0")],
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_assembler_matches_jax(case):
    recs = _CASES[case]
    got = trt.TraceAssembler().from_records(recs)
    want = jrt.TraceAssembler().from_records(recs)
    assert _json(got) == _json(want)
    assert _json(trt.chrome_trace_events(got["traces"])) == _json(
        jrt.chrome_trace_events(want["traces"]))
    if case == "orphan":
        assert got["orphan_spans"] == ["ghost"]
    if case == "amortized_decode":
        assert [t["components"]["decode"] for t in got["traces"]] == [25.0,
                                                                      25.0]


def test_interval_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = [tuple(sorted(rng.uniform(0, 10, 2))) for _ in range(6)]
        b = [tuple(sorted(rng.uniform(0, 10, 2))) for _ in range(4)]
        assert trt._merged(a) == jrt._merged(a)
        assert trt._merged_length(a) == jrt._merged_length(a)
        assert trt._residue_length(a, b) == jrt._residue_length(a, b)
        vals = list(rng.uniform(0, 5, int(rng.integers(0, 7))))
        assert trt._median(vals) == jrt._median(vals)


def _synthetic_traces(seed, n=12):
    rng = np.random.default_rng(seed)
    comps = ["queue", "prefill", "decode", "dispatch", "failover_recompute"]
    out = []
    for i in range(n):
        c = {k: float(rng.uniform(0, 50)) for k in comps[:3]}
        if i % 5 == 0:
            c["failover_recompute"] = float(rng.uniform(100, 300))
        out.append({"trace_id": f"t{i}", "request_id": f"r{i}",
                    "complete": True, "latency_ms": sum(c.values()),
                    "coverage": 1.0, "components": c})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tail_attribution_matches_jax(seed):
    traces = _synthetic_traces(seed)
    for pct in (99.0, 90.0, 50.0):
        got = trt.tail_latency_attribution(traces, pct)
        assert _json(got) == _json(jrt.tail_latency_attribution(traces, pct))
    assert trt.tail_latency_attribution(traces)["dominant"] == \
        "failover_recompute"
    flat = [dict(t, components={"decode": 10.0}, latency_ms=10.0)
            for t in traces]
    assert _json(trt.tail_latency_attribution(flat)) == _json(
        jrt.tail_latency_attribution(flat))
    assert trt.tail_latency_attribution(traces[:1]) is None


# -- the slice as a whole: one engine run in each package ------------------
def _state(seed=0):
    shapes = {k: v.shape for k, v in
              JaxGPT(jax_gpt_tiny(**MODEL_KW)).state_dict().items()}
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(shapes):
        a = rng.randn(*shapes[k]).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        out[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    return out


@pytest.fixture(scope="module")
def models():
    state = _state()
    jm = JaxGPT(jax_gpt_tiny(**MODEL_KW))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**MODEL_KW), device="cpu"),
                        state)
    return jm, tm


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 1024, n).tolist() for n in PROMPT_LENS]


def _engine_records(Engine, Registry, fx, model):
    clk = fx.expire_clock()
    reg = Registry(clock=clk)
    sink = reg.add_sink(_Sink())
    # a small KV pool: preemption and its recompute are traced too
    eng = Engine(model, registry=reg, clock=clk, num_kv_blocks=8,
                 **ENGINE_KW)
    for p in _prompts():
        eng.submit(p, max_new_tokens=MAX_NEW)
    for _ in range(200):
        if not eng.has_work():
            break
        eng.step()
        clk.advance(0.01)
    return [r for r in sink.records if str(r["kind"]).startswith("trace.")]


def test_engine_run_assembles_as_the_jax_engine_run(models):
    jm, tm = models
    want_recs = _norm(_engine_records(JaxEngine, JaxRegistry, jax_faults,
                                      jm))
    got_recs = _norm(_engine_records(ServingEngine, MetricsRegistry, faults,
                                     tm))
    assert got_recs == want_recs
    port = trt.TraceAssembler().from_records(got_recs)
    assert _json(port) == _json(
        jrt.TraceAssembler().from_records(got_recs))
    assert _json(port) == _json(
        jrt.TraceAssembler().from_records(want_recs))
    assert port["complete"] == len(PROMPT_LENS) == len(port["traces"])
    assert not port["orphan_spans"]
    comps = set().union(*(t["components"] for t in port["traces"]))
    assert {"queue", "prefill", "decode", "preempt_recompute"} <= comps


# -- a port fleet through assemble_run and the CLI --------------------------
def _fleet_run(run_dir, model):
    reg = MetricsRegistry()
    writer = reg.add_sink(MetricsWriter(metrics_dir(run_dir), worker_id=0,
                                        flush_every=1))
    reps = [fleet.LocalReplica(ServingEngine(model, registry=reg,
                                             replica_id=i, **ENGINE_KW),
                               replica_id=i) for i in range(2)]
    router = fleet.Router(reps, registry=reg, run_dir=run_dir)
    rids = [router.submit([1, 2, 3 + i], max_new_tokens=10)
            for i in range(3)]
    while len(router.journals[rids[0]].tokens) < 3:
        router.pump()
    victim = router.journals[rids[0]].replica_id
    reps[victim].engine._state = "stopped"
    outs = [router.collect(r, timeout=60) for r in rids]
    reg.remove_sink(writer)
    assert all(len(o["tokens"]) == 10 for o in outs)
    assert router.failovers >= 1
    return rids


def test_fleet_run_assembles_and_exports_as_jax(models, tmp_path, capsys):
    _, tm = models
    run_dir = str(tmp_path / "run")
    rids = _fleet_run(run_dir, tm)
    got = trt.assemble_run(run_dir)
    want = jrt.assemble_run(run_dir)
    assert _json(got) == _json(want)
    assert sorted(t["request_id"] for t in got["traces"]) == sorted(rids)
    assert got["complete"] == len(rids) and not got["orphan_spans"]
    assert min(t["coverage"] for t in got["traces"]) >= 0.95
    assert got["wal_streams"] == got["wal_matched"] == len(rids)
    moved = [t for t in got["traces"]
             if len([p for p in t["procs"] if p.startswith("replica-")]) == 2]
    assert moved and all(t["components"].get("failover_recompute", 0) > 0
                         for t in moved)
    jdir = str(tmp_path / "jrun")
    shutil.copytree(run_dir, jdir)
    tchrome, jchrome = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert trt.main([run_dir, "--chrome", tchrome, "--json"]) == 0
    tout = json.loads(capsys.readouterr().out)
    assert jrt.main([jdir, "--chrome", jchrome, "--json"]) == 0
    jout = json.loads(capsys.readouterr().out)
    tout["run_dir"] = jout["run_dir"] = None
    assert tout == jout
    with open(tchrome) as f, open(jchrome) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(run_dir, "traces.json")) as f:
        assert json.load(f)["complete"] == len(rids)
    assert trt.main([run_dir]) == 0
    text = capsys.readouterr().out
    assert f"{len(rids)}/{len(rids)} complete, 0 orphan span ids" in text
