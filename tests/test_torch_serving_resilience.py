"""Port parity for the serving engine's request lifecycle: deadlines and
cancel, quarantine with bisection, the NaN guard, watchdog recovery, drain
/ spill / resume, collect timeouts, callbacks, defrag, the status pages and
the ``paddle.inference`` facade.

Each scenario runs the JAX ``ServingEngine`` and the port's on the same
numpy weights (``gpt_tiny``, float32, fused block) and prompts, and the two
must agree exactly: token streams, finish reasons, ``lifecycle_counts``,
quarantined ids, ``stats()["resilience"]``, ``leak_report()`` and the
quarantine records (all but ``time`` and ``error``).  Request tracing is
off (``PTPU_TRACE_REQUESTS=0``) except in the trace test, since trace ids
are random; the spill files of the two packages are then byte-identical,
and a spill written by either package resumes in the other."""
import json
import os
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu.inference import CollectTimeout as JaxCollectTimeout
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability.monitor import StatusServer as JaxStatusServer
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import (CollectTimeout, Config,
                                        PredictorPool, ServingEngine,
                                        create_predictor)
from paddle_tpu_torch.inference import engine as engine_mod
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability.monitor import StatusServer
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.testing import faults

pytestmark = [pytest.mark.serving, pytest.mark.faults]

MODEL_KW = dict(hidden_dropout=0.0, attention_dropout=0.0,
                use_fused_block=True, dtype="float32")
PROMPT_LENS = (5, 12, 3, 9, 7, 4)
MAX_NEW = 6
ENGINE_KW = dict(max_seqs=4, kv_block_size=4, max_model_len=64)


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 1024, n).tolist() for n in PROMPT_LENS]


PROMPTS = _prompts()


@pytest.fixture(autouse=True)
def _no_mesh():
    # the JAX engine refuses to run under a hybrid mesh; earlier files in a
    # full run may leave one installed
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


@pytest.fixture(autouse=True)
def _no_tracing(monkeypatch):
    monkeypatch.setenv("PTPU_TRACE_REQUESTS", "0")
    monkeypatch.delenv("PTPU_SERVE_DEADLINE_MS", raising=False)


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
def pkgs():
    """The two packages behind one surface: ``(jax, torch)``."""
    state = _state()
    jm = JaxGPT(jax_gpt_tiny(**MODEL_KW))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**MODEL_KW), device="cpu"),
                        state)
    jx = SimpleNamespace(name="jax", model=jm, Engine=JaxEngine,
                         faults=jax_faults, Registry=JaxRegistry,
                         StatusServer=JaxStatusServer,
                         CollectTimeout=JaxCollectTimeout,
                         Config=JaxConfig, create_predictor=jax_create_predictor,
                         hang_timeout=4.0,
                         pages=lambda eng: [tuple(np.asarray(t) for t in kv)
                                            for kv in eng.cache._pages])
    pt = SimpleNamespace(name="torch", model=tm, Engine=ServingEngine,
                         faults=faults, Registry=MetricsRegistry,
                         StatusServer=StatusServer,
                         CollectTimeout=CollectTimeout,
                         Config=Config, create_predictor=create_predictor,
                         hang_timeout=1.0,
                         pages=lambda eng: [tuple(t.numpy().copy() for t in kv)
                                            for kv in eng.cache.pages])
    return jx, pt


def _engine(P, **kw):
    args = dict(ENGINE_KW, registry=P.Registry())
    args.update(kw)
    return P.Engine(P.model, **args)


@pytest.fixture(scope="module")
def clean(pkgs):
    """The uninterrupted JAX run of PROMPTS: the token reference."""
    jx, _ = pkgs
    dist.set_hybrid_communicate_group(None)
    eng = _engine(jx, max_seqs=len(PROMPTS))
    return eng.generate(PROMPTS, max_new_tokens=MAX_NEW)


def _records(run_dir):
    qdir = os.path.join(run_dir, "serve", "replica-0", "quarantine")
    if not os.path.isdir(qdir):
        return {}
    out = {}
    for name in sorted(os.listdir(qdir)):
        with open(os.path.join(qdir, name)) as f:
            rec = json.load(f)
        rec.pop("time")
        rec.pop("error")
        out[name] = rec
    return out


def _summary(eng, rids, run_dir=None, **extra):
    fin = eng.sched.finished
    out = {"tokens": [list(fin[r].output) for r in rids],
           "reasons": [fin[r].finish_reason for r in rids],
           "lifecycle": dict(eng.lifecycle_counts),
           "quarantined": sorted(eng.quarantined),
           "resilience": eng.stats()["resilience"],
           "leak": eng.cache.leak_report(),
           "steps": eng.steps,
           "preemptions": eng.sched.preemptions}
    if run_dir is not None:
        out["records"] = _records(run_dir)
    out.update(extra)
    return out


# -- the scenarios: each returns a summary the two packages must share -----
def _deadline(P, tmp):
    clk = P.faults.expire_clock()
    eng = _engine(P, max_seqs=3, clock=clk)
    rids = [eng.submit(PROMPTS[0], max_new_tokens=20, deadline_ms=50.0),
            eng.submit(PROMPTS[1], max_new_tokens=4),
            # first token before the clock moves: its TTFT bound is met
            eng.submit(PROMPTS[2], max_new_tokens=4, ttft_deadline_ms=50.0),
            # queued behind the full batch: misses its TTFT bound
            eng.submit(PROMPTS[3], max_new_tokens=4, ttft_deadline_ms=50.0)]
    for _ in range(4):
        eng.step()
    clk.advance(1.0)
    eng.run(max_steps=100)
    return _summary(eng, rids)


def _env_deadline(P, tmp):
    clk = P.faults.expire_clock()
    old = os.environ.get("PTPU_SERVE_DEADLINE_MS")
    os.environ["PTPU_SERVE_DEADLINE_MS"] = "50"
    try:
        eng = _engine(P, max_seqs=2, clock=clk)
        rids = [eng.submit(PROMPTS[0], max_new_tokens=20)]
    finally:
        if old is None:
            del os.environ["PTPU_SERVE_DEADLINE_MS"]
        else:
            os.environ["PTPU_SERVE_DEADLINE_MS"] = old
    eng.step()
    clk.advance(1.0)
    eng.run(max_steps=100)
    return _summary(eng, rids)


def _cancel(P, tmp):
    events = []
    eng = _engine(P, max_seqs=1)
    cb = lambda r, t, fin: events.append((r, t, fin))  # noqa: E731
    running = eng.submit(PROMPTS[0], max_new_tokens=20, on_token=cb)
    waiting = eng.submit(PROMPTS[1], max_new_tokens=4, on_token=cb)
    eng.step()
    eng.step()
    flags = [eng.cancel(running), eng.cancel(waiting),
             eng.cancel("no-such-request")]
    eng.run(max_steps=50)
    flags.append(eng.cancel(running))           # already finished
    assert eng.drain_callbacks(timeout=5.0)
    eng.stop()
    return _summary(eng, [running, waiting], flags=flags, events=events)


def _traffic(P, tmp, n=4, max_new=MAX_NEW, **kw):
    eng = _engine(P, max_seqs=n, **kw)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in PROMPTS[:n]]
    eng.run(max_steps=500)
    return eng, rids


def _decode_raise(P, tmp):
    inj = P.faults.poison_request(2, mode="raise", kinds=("decode",))
    eng, rids = _traffic(P, tmp, step_fault=inj, run_dir=tmp)
    return _summary(eng, rids, tmp, fired=inj.fired)


def _prefill_raise(P, tmp):
    inj = P.faults.poison_request(1, mode="raise", kinds=("prefill",))
    eng, rids = _traffic(P, tmp, step_fault=inj, run_dir=tmp)
    return _summary(eng, rids, tmp, fired=inj.fired)


def _nan_guard(P, tmp):
    inj = P.faults.poison_request(0, mode="nan", kinds=("decode",))
    eng, rids = _traffic(P, tmp, step_fault=inj, nan_guard=True,
                         run_dir=tmp)
    return _summary(eng, rids, tmp, fired=inj.fired)


def _nan_unguarded(P, tmp):
    # guard off: the NaN row still yields a token (argmax of the step's
    # own logits, taken before the fault seam) and nothing is quarantined
    inj = P.faults.poison_request(0, mode="nan", kinds=("decode",),
                                  count=1)
    eng, rids = _traffic(P, tmp, step_fault=inj, nan_guard=False,
                         run_dir=tmp)
    return _summary(eng, rids, tmp, fired=inj.fired)


def _hang(P, tmp):
    inj = P.faults.poison_request(1, mode="hang", seconds=30.0,
                                  kinds=("decode",), count=1)
    eng = _engine(P, max_seqs=2, step_timeout=120.0, step_fault=inj)
    try:
        warm = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
        eng.run(max_steps=100)
        # the JAX engine re-traces its step after the recovery (its
        # backend compile is cached) under this deadline; the port has
        # nothing to rebuild
        eng.step_timeout = P.hang_timeout
        target = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW)
        eng.run(max_steps=200)
    finally:
        eng.stop()
    return _summary(eng, [warm, target], fired=inj.fired,
                    target_preemptions=eng.sched.finished[target].preemptions)


def _drain(P, tmp):
    eng = _engine(P, max_seqs=2, run_dir=tmp)
    rids = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
    eng.step()
    eng.step()
    report = eng.drain(timeout=30.0)
    with open(report["spill_path"], "rb") as f:
        spill = f.read()
    report = {k: v for k, v in report.items() if k != "spill_path"}
    return _summary(eng, rids, report=report, spill=spill,
                    state=eng.state)


def _drain_now(P, tmp):
    eng = _engine(P, max_seqs=2, run_dir=tmp, replica_id=3)
    rids = [eng.submit(PROMPTS[0], max_new_tokens=20)]
    eng.step()
    eng.step()
    report = eng.drain(timeout=0.0)
    path = os.path.join(tmp, "serve", "replica-3", "spill.json")
    assert report["spill_path"] == path
    with open(path, "rb") as f:
        spill = f.read()
    report = {k: v for k, v in report.items() if k != "spill_path"}
    return _summary(eng, rids, report=report, spill=spill)


def _resume_run(P, tmp):
    """Partial progress, drain (finishing the running request, spilling
    the waiting ones), then a fresh engine resumes the spill."""
    eng = _engine(P, max_seqs=1, run_dir=tmp)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW, request_id=f"r{i}")
            for i, p in enumerate(PROMPTS[:4])]
    for _ in range(3):
        eng.step()
    report = eng.drain(timeout=30.0)
    finished = {r: list(eng.sched.finished[r].output) for r in rids
                if eng.sched.finished[r].finish_reason != "spilled"}
    fresh = _engine(P, max_seqs=1)
    resumed = fresh.resume(report["spill_path"])
    fresh.run(max_steps=500)
    tokens = dict(finished)
    tokens.update({r: fresh.collect(r)["tokens"] for r in resumed})
    return _summary(fresh, resumed, resumed=resumed, drained_tokens=tokens,
                    first=_summary(eng, rids))


def _spill_checks(P, tmp):
    bad = os.path.join(tmp, "bad_spill.json")
    with open(bad, "w") as f:
        json.dump({"version": 99, "spilled": []}, f)
    eng = _engine(P)
    with pytest.raises(Exception, match="version"):
        eng.resume(bad)
    # the legacy <run_dir>/serve_spill.json is found without a path
    eng = _engine(P)
    eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW, request_id="legacy")
    eng.step()
    eng.step()
    eng.drain(timeout=0.0, spill_path=os.path.join(tmp, "serve_spill.json"))
    fresh = _engine(P, run_dir=tmp)
    resumed = fresh.resume()
    fresh.run(max_steps=200)
    # submit and admit are refused once the engine drains
    eng = _engine(P, run_dir=tmp)
    eng.submit(PROMPTS[1], max_new_tokens=2)
    eng.begin_drain()
    errors = []
    for call in (lambda: eng.submit(PROMPTS[2], max_new_tokens=2),
                 lambda: eng.admit_record({"request_id": "x",
                                           "prompt": [1],
                                           "max_new_tokens": 1})):
        with pytest.raises(Exception) as ei:
            call()
        errors.append(str(ei.value))
    return _summary(fresh, resumed, resumed=resumed, errors=errors)


def _collect_timeout(P, tmp):
    eng = _engine(P, max_seqs=1)
    eng.submit(PROMPTS[0], max_new_tokens=20)
    queued = eng.submit(PROMPTS[1], max_new_tokens=2)
    eng.step()
    eng.begin_drain()           # queued can never be admitted now
    with pytest.raises(P.CollectTimeout) as ei:
        eng.collect(queued, timeout=0.3)
    timeout_msg = str(ei.value)
    assert queued in timeout_msg and "queue_position" in timeout_msg
    eng2 = _engine(P, max_seqs=1)
    stuck = eng2.submit(PROMPTS[0], max_new_tokens=20)
    with pytest.raises(RuntimeError, match=stuck) as ei:
        eng2.run(max_steps=2)
    return {"timeout": timeout_msg, "stuck": str(ei.value)}


def _callbacks(P, tmp):
    eng = _engine(P, max_seqs=2)

    def bad_cb(rid, token, finished):
        raise ValueError("consumer bug")

    rid = eng.submit(PROMPTS[0], max_new_tokens=3, on_token=bad_cb)
    ok = eng.submit(PROMPTS[1], max_new_tokens=2, on_token=lambda *a: None)
    eng.run(max_steps=50)
    assert eng.drain_callbacks(timeout=5.0)
    thread = eng._cb_thread
    assert thread is not None and thread.is_alive()
    counter = eng._reg().snapshot()["serve.callback_errors"]["value"]
    eng.stop()
    thread.join(timeout=5.0)
    assert eng._cb_thread is None and not thread.is_alive()
    return _summary(eng, [rid, ok], counter=counter)


def _defrag(P, tmp):
    """Churn on a tight pool (10 blocks of 4 for 6 requests: preemptions),
    then a defrag whenever a finish leaves the pool non-compact; each
    running sequence's cached K/V must read the same through its
    renumbered table."""
    eng = _engine(P, num_kv_blocks=10)
    rids = [eng.submit(p, max_new_tokens=3 + i % 4)
            for i, p in enumerate(PROMPTS)]
    moves = []
    while eng.has_work():
        before = len(eng.sched.finished)
        eng.step()
        if len(eng.sched.finished) == before:
            continue
        live = {s.request_id: s.computed_len for s in eng.sched.running}
        old = {r: [eng.cache.slot(r, p) for p in range(n)]
               for r, n in live.items()}
        pages = P.pages(eng)
        moved = eng.defrag()
        new = {r: [eng.cache.slot(r, p) for p in range(n)]
               for r, n in live.items()}
        after = P.pages(eng)
        for r in live:
            for (k0, v0), (k1, v1) in zip(pages, after):
                np.testing.assert_array_equal(k1[new[r]], k0[old[r]])
                np.testing.assert_array_equal(v1[new[r]], v0[old[r]])
        used = eng.cache.allocator.num_used
        assert sorted(b for r in live for b in eng.cache.table(r)) \
            == list(range(used))
        moves.append((moved, {r: list(eng.cache.table(r)) for r in live}))
    assert eng.sched.preemptions > 0 and any(m for m, _ in moves)
    # a run without defrag gives the same tokens
    plain = _engine(P, num_kv_blocks=10)
    prids = [plain.submit(p, max_new_tokens=3 + i % 4)
             for i, p in enumerate(PROMPTS)]
    plain.run(max_steps=500)
    assert [plain.collect(r)["tokens"] for r in prids] \
        == [eng.collect(r)["tokens"] for r in rids]
    return _summary(eng, rids, moves=moves)


def _surfaces(P, tmp):
    eng = _engine(P, max_seqs=2, shed_queue_depth=1)
    srv = P.StatusServer(registry=eng._registry, engine=eng)
    states = [srv.healthz()]
    rid = eng.submit(PROMPTS[0], max_new_tokens=4)
    states.append(srv.healthz())
    eng.submit(PROMPTS[1], max_new_tokens=4)
    states.append(srv.healthz())                 # 2 waiting > 1: shed
    eng.cancel(rid)
    eng.run(max_steps=50)
    states.append(srv.healthz())
    res = srv.statusz()["serving"]["resilience"]
    eng.begin_drain()
    states.append(srv.healthz())
    eng.drain(timeout=10.0)
    states.append(srv.healthz())
    return {"states": states, "resilience": res,
            "stats": eng.stats()["resilience"]}


def _predictor(P, tmp):
    cfg = P.Config()
    cfg.enable_continuous_batching(4, 4)
    cfg.set_decoder_model(P.model, MAX_NEW, pad_token_id=1023)
    pred = P.create_predictor(cfg)
    width = max(len(p) for p in PROMPTS[:4])
    ids = np.full((4, width), 1023, np.int64)
    for i, p in enumerate(PROMPTS[:4]):
        ids[i, :len(p)] = p
    names = pred.get_input_names()
    pred.get_input_handle(names[0]).copy_from_cpu(ids)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    return {"names": names, "out": out.tolist()}


SCENARIOS = {"deadline": _deadline, "env_deadline": _env_deadline,
             "cancel": _cancel, "decode_raise": _decode_raise,
             "prefill_raise": _prefill_raise, "nan_guard": _nan_guard,
             "nan_unguarded": _nan_unguarded, "hang": _hang,
             "drain": _drain, "drain_now": _drain_now,
             "resume": _resume_run, "spill_checks": _spill_checks,
             "collect_timeout": _collect_timeout, "callbacks": _callbacks,
             "defrag": _defrag, "surfaces": _surfaces,
             "predictor": _predictor}


@pytest.fixture(scope="module")
def jax_run(pkgs, tmp_path_factory):
    """Each scenario's JAX run, once per module."""
    memo = {}

    def run(name):
        if name not in memo:
            dist.set_hybrid_communicate_group(None)
            tmp = str(tmp_path_factory.mktemp(f"jax-{name}"))
            memo[name] = SCENARIOS[name](pkgs[0], tmp)
        return memo[name]
    return run


def _torch_run(pkgs, name, tmp_path):
    tmp = tmp_path / "torch"
    tmp.mkdir()
    return SCENARIOS[name](pkgs[1], str(tmp))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, pkgs, jax_run, tmp_path):
    assert _torch_run(pkgs, name, tmp_path) == jax_run(name)


# -- what each scenario must show, beyond agreeing with JAX ----------------
def test_deadlines_evict_with_reasons(pkgs, jax_run, clean):
    got = jax_run("deadline")
    assert got["reasons"] == ["deadline", "max_new_tokens",
                              "max_new_tokens", "deadline"]
    assert got["tokens"][3] == []
    assert got["tokens"][1] == clean[1][:4]
    assert got["lifecycle"]["deadline"] == 2
    assert got["leak"]["num_used"] == 0 and got["leak"]["balanced"]
    assert jax_run("env_deadline")["reasons"] == ["deadline"]


def test_cancel_reaches_the_callback(jax_run):
    got = jax_run("cancel")
    assert got["reasons"] == ["cancelled", "cancelled"]
    assert got["flags"] == [True, True, False, False]
    assert got["events"][-2:] == [("req-0", None, True),
                                  ("req-1", None, True)]
    assert got["resilience"]["cancelled"] == 2


def test_quarantine_bisects_to_the_culprit(jax_run, clean):
    got = jax_run("decode_raise")
    assert got["fired"] > 1                 # the probes re-fired it
    assert got["quarantined"] == ["req-2"]
    assert got["reasons"][2] == "poisoned"
    for i in (0, 1, 3):
        assert got["tokens"][i] == clean[i]
    (rec,) = got["records"].values()
    assert rec["step_kind"] == "decode" and rec["reason"] == "poisoned"
    pre = jax_run("prefill_raise")
    assert pre["quarantined"] == ["req-1"] and pre["tokens"][1] == []
    nan = jax_run("nan_guard")
    assert nan["quarantined"] == ["req-0"] and nan["fired"] == 1
    for i in (1, 2, 3):
        assert nan["tokens"][i] == clean[i]
    assert not jax_run("nan_unguarded")["quarantined"]


def test_hang_recovery_is_token_exact(jax_run, clean):
    got = jax_run("hang")
    assert got["resilience"]["watchdog_restarts"] == 1
    assert got["fired"] == 1 and got["target_preemptions"] >= 1
    assert got["tokens"] == [clean[0], clean[1]]


def test_hang_preempts_and_recomputes(pkgs):
    # the JAX engine rebuilds its jitted step after a hang; the port has
    # nothing to rebuild, so the recovery is the preemption: the target
    # goes back to the queue with no cached KV, and the next step is its
    # recompute prefill
    _, pt = pkgs
    inj = faults.poison_request(1, mode="hang", seconds=30.0,
                                kinds=("decode",), count=1)
    eng = _engine(pt, max_seqs=2, step_timeout=2.0, step_fault=inj)
    try:
        eng.submit(PROMPTS[0], max_new_tokens=2)
        eng.run(max_steps=20)
        target = eng.submit(PROMPTS[1], max_new_tokens=4)
        eng.step()                                  # prefill
        eng.step()                                  # decode hangs
        assert eng.watchdog_restarts == 1 and not eng.sched.running
        (seq,) = eng.sched.waiting
        assert seq.request_id == target and seq.computed_len == 0
        assert seq.resume_why == "preempt" and len(seq.output) == 1
        assert eng.cache.allocator.num_used == 0
        prefills = eng.stats()["step_ms"]["prefill"]["count"]
        eng.step()
        assert eng.stats()["step_ms"]["prefill"]["count"] == prefills + 1
        assert eng.sched.running[0].computed_len == len(PROMPTS[1])
        eng.run(max_steps=20)
    finally:
        eng.stop()


def test_drain_spills_and_resumes(jax_run, clean):
    got = jax_run("drain")
    assert got["state"] == "stopped"
    assert got["report"]["spilled"] > 0 and not got["report"]["timed_out"]
    assert got["report"]["finished"] >= 2
    assert got["leak"]["num_used"] == 0
    now = jax_run("drain_now")
    assert now["report"]["timed_out"] and now["report"]["spilled"] == 1
    res = jax_run("resume")
    assert res["drained_tokens"] == {f"r{i}": clean[i] for i in range(4)}
    assert jax_run("spill_checks")["resumed"] == ["legacy"]
    assert jax_run("spill_checks")["tokens"] == [clean[0]]


def test_callbacks_counted_not_fatal(jax_run):
    got = jax_run("callbacks")
    assert got["reasons"] == ["max_new_tokens", "max_new_tokens"]
    cbs = got["resilience"]["callbacks"]
    assert cbs["errors"] == 3 and cbs["dispatched"] == 5
    assert "consumer bug" in cbs["last_error"] and got["counter"] == 3


def test_surfaces(jax_run):
    got = jax_run("surfaces")
    assert got["states"] == [(200, "ok"), (200, "ok"),
                             (503, "load-shed:queue_depth=2"),
                             (200, "ok"), (503, "draining"),
                             (503, "stopped")]
    assert got["resilience"]["cancelled"] == 1
    assert got["resilience"]["state"] == "serving"


def test_predictor_facade(jax_run, clean):
    got = jax_run("predictor")
    for row, prompt, toks in zip(got["out"], PROMPTS, clean):
        full = prompt + toks
        assert row[:len(full)] == full
        assert all(t == 1023 for t in row[len(full):])


# -- across the packages ---------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_resumes_in_the_other_package(writer, pkgs, jax_run, clean,
                                            tmp_path):
    jx, pt = pkgs
    if writer == "jax":
        spill = jax_run("drain")["spill"]
    else:
        spill = _torch_run(pkgs, "drain", tmp_path)["spill"]
    path = tmp_path / "spill.json"
    path.write_bytes(spill)
    reader = pt if writer == "jax" else jx
    eng = _engine(reader, max_seqs=2)
    resumed = eng.resume(str(path))
    assert resumed
    eng.run(max_steps=500)
    for rid in resumed:
        i = int(rid.split("-")[1])
        assert eng.collect(rid)["tokens"] == clean[i][:4], rid


def test_trace_records_match_jax(pkgs, monkeypatch):
    """With tracing on and one hand-driven clock, both engines emit the
    same records (trace ids aside): submissions, spans, preemption,
    quarantine, cancel and finish, in the same order."""
    monkeypatch.setenv("PTPU_TRACE_REQUESTS", "1")

    class Sink:
        def __init__(self):
            self.records = []

        def write(self, record):
            self.records.append(record)

        def flush(self):
            pass

        def close(self):
            pass

    def run(P):
        clk = P.faults.expire_clock()
        reg = P.Registry(clock=clk)
        sink = reg.add_sink(Sink())
        inj = P.faults.poison_request(3, mode="raise", kinds=("decode",))
        eng = _engine(P, registry=reg, clock=clk, num_kv_blocks=8,
                      step_fault=inj)
        rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        for i in range(200):
            if not eng.has_work():
                break
            if i == 6:
                eng.cancel(rids[4])
            eng.step()
            clk.advance(0.01)
        ids = {}

        def norm(trace_id):
            if trace_id is None:
                return None
            return ids.setdefault(trace_id, f"trace-{len(ids)}")

        out = []
        for r in sink.records:
            rec = {k: (norm(v) if k == "trace_id" else v)
                   for k, v in r.items() if k not in ("error",)}
            if "requests" in rec:
                rec["requests"] = [[a, norm(b)] for a, b in rec["requests"]]
            out.append(rec)
        return out, eng

    jx, pt = pkgs
    want, jeng = run(jx)
    got, teng = run(pt)
    assert teng.sched.preemptions > 0 and teng.quarantined
    kinds = {r["kind"] for r in got}
    assert {"trace.request", "trace.span", "trace.request_end",
            "serve.quarantine", "serve.cancel", "serve.preempt"} <= kinds
    assert got == want


# -- the port's own checks -------------------------------------------------
def test_decode_step_copies_no_logits(pkgs, monkeypatch, clean):
    """Without a fault seam or capture_logits, the NaN guard reduces on the
    device: no tensor of vocab width is copied to the host, and a
    nonfinite row still quarantines its request."""
    _, pt = pkgs
    vocab = pt.model.config.vocab_size
    copied = []
    real_cpu = torch.Tensor.cpu

    def spy(self, *a, **kw):
        copied.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    real_step = pt.model.serving_step
    poisoned = {"row": None}

    def step(ids, caches, positions, last_index):
        logits, caches = real_step(ids, caches, positions, last_index)
        if poisoned["row"] is not None and ids.shape[1] == 1:
            logits = logits.clone()
            logits[poisoned["row"]] = float("nan")
            poisoned["row"] = None              # the replay runs clean
        return logits, caches

    monkeypatch.setattr(pt.model, "serving_step", step)
    eng = _engine(pt, nan_guard=True)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS[:4]]
    eng.run(max_steps=100)
    assert [eng.collect(r)["tokens"] for r in rids] == clean[:4]
    assert copied and all(vocab not in shape for shape in copied)
    eng = _engine(pt, nan_guard=True)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS[:4]]
    for _ in range(4):
        eng.step()                              # four prefills
    poisoned["row"] = 1
    eng.run(max_steps=100)
    assert list(eng.quarantined) == [rids[1]]
    assert "nonfinite" in eng.quarantined[rids[1]]["error"]
    for i in (0, 2, 3):
        assert eng.collect(rids[i])["tokens"] == clean[i]


def test_sampled_replay_draws_what_the_step_drew(pkgs):
    """Above temperature 0 a quarantine's probes and replay restore the
    generator: the survivors' tokens are those of an engine whose step
    never faulted (the same rows in the same places)."""
    _, pt = pkgs

    def serve(fault):
        eng = _engine(pt, temperature=0.9, seed=5, step_fault=fault)
        rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS[:4]]
        eng.run(max_steps=200)
        return [eng.collect(r)["tokens"] for r in rids]

    base = serve(None)
    got = serve(faults.poison_request(3, "raise", kinds=("decode",)))
    # req-3 sits in the last row: the survivors keep their rows, so each
    # draw restored from the step's state matches the un-faulted draw
    assert got[:3] == base[:3]
    assert got[3] == base[3][:1]


def test_status_server_over_http(pkgs):
    _, pt = pkgs
    eng = _engine(pt)
    rid = eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.run(max_steps=20)
    srv = eng.start_status_server(port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200 and json.load(r)["ok"]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "paddle_tpu_serve_tokens 2" in text
        with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
            page = json.load(r)
        assert page["serving"]["resilience"] == \
            eng.stats()["resilience"]
        assert page["serving"]["finished"] == 1 and rid
        eng.begin_drain()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        assert json.load(ei.value)["state"] == "draining"
    finally:
        eng.stop()
    assert eng.status_server is None


def test_facade_surface(pkgs):
    _, pt = pkgs
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.inference import Predictor, get_version
    # a Config without continuous batching is a Predictor over a jit.save
    # artifact (tests/test_torch_jit.py), which these directories lack
    with pytest.raises(InvalidArgumentError, match="no exported model"):
        create_predictor(Config("some/dir"))
    with pytest.raises(InvalidArgumentError, match="set_model"):
        Predictor(Config())
    assert get_version() == "0.1.0"
    cfg = Config()
    cfg.enable_continuous_batching(2, 4)
    cfg.set_decoder_model(pt.model, 2)
    pool = PredictorPool(cfg, size=2)
    assert pool.retrieve(0) is not pool.retrive(1)
    assert pool.retrieve(0).engine.cache.block_size == 4


def test_watchdog_fires_and_dumps(monkeypatch):
    from paddle_tpu_torch.supervisor.watchdog import (StepTimeout, Watchdog,
                                                      dump_all_stacks,
                                                      guarded,
                                                      install_global)
    wd = Watchdog(timeout=0.2)
    try:
        with pytest.raises(StepTimeout):
            with wd.armed("unit"):
                faults.hang(5.0)
        assert wd.timeouts == 1
        with wd.armed("fast"):
            pass
        assert wd.timeouts == 1
        prev = install_global(wd)
        try:
            with pytest.raises(StepTimeout):
                with guarded("global", timeout=0.2):
                    faults.hang(5.0)
        finally:
            install_global(prev)
    finally:
        wd.close()
    me = threading.get_ident()
    assert dump_all_stacks(first=me).startswith(f"--- thread ")


def test_engine_env_defaults(pkgs, monkeypatch):
    _, pt = pkgs
    monkeypatch.setenv("PTPU_MAX_SEQS", "3")
    monkeypatch.setenv("PTPU_KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("PTPU_SHED_QUEUE_DEPTH", "5")
    monkeypatch.setenv("PTPU_SERVE_NAN_GUARD", "1")
    monkeypatch.setenv("PTPU_SERVE_DRAIN_SECS", "7")
    eng = ServingEngine(pt.model, max_model_len=64,
                        registry=MetricsRegistry())
    assert (eng.max_seqs, eng.cache.block_size, eng.shed_queue_depth,
            eng.nan_guard) == (3, 8, 5, True)
    assert engine_mod.default_drain_secs() == 7.0
