"""Port parity for the serving fleet, part 2: the crash-safe router journal
(the store, recovery, the random crash / recover property, and a journal of
either package recovering in the other), the circuit breaker, the retry
budget, the flap drill, the SLO autoscaler and the fleet's env knobs.

Each scenario runs through the JAX fleet and the port's on the same numpy
weights (``gpt_tiny``, float32, fused block) and prompts, and the two must
agree exactly: token streams, finish reasons, ``router.recovered``,
exceptions, breaker and budget states, the ``fleet.*`` counters and gauges
(histograms by sample count), census states and the journal lines apart
from their ``ts`` / ``mono`` stamps.  Each scenario also checks its own
invariants (``ok``), token streams against an uninterrupted port engine.
Request tracing is off (``PTPU_TRACE_REQUESTS=0``): trace ids are random.
The doctor's fleet verdicts are not ported yet and are not run here."""
import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
import paddle_tpu.inference.fleet as jax_fleet
import paddle_tpu.inference.fleet.journal as jax_journal
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import fleet
from paddle_tpu_torch.inference.fleet import journal as torch_journal
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.testing import faults

pytestmark = [pytest.mark.serving, pytest.mark.faults]

MODEL_KW = dict(hidden_dropout=0.0, attention_dropout=0.0,
                use_fused_block=True, dtype="float32")
ENGINE_KW = dict(max_seqs=4, kv_block_size=4)
PROMPTS = [[1, 2, 3 + i] for i in range(6)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state(monkeypatch):
    # see test_torch_serve_fleet: no mesh, no tracing, full retry budgets
    dist.set_hybrid_communicate_group(None)
    monkeypatch.setenv("PTPU_TRACE_REQUESTS", "0")
    for knob in ("PTPU_FLEET_JOURNAL_KEEP", "PTPU_FLEET_MIN",
                 "PTPU_FLEET_MAX", "PTPU_FLEET_RETRY_BUDGET",
                 "PTPU_FLEET_RETRY_REFILL_PER_S",
                 "PTPU_FLEET_DRAIN_SLACK_SECS"):
        monkeypatch.delenv(knob, raising=False)
    jax_fleet.reset_retry_budget()
    fleet.reset_retry_budget()
    yield
    dist.set_hybrid_communicate_group(None)
    jax_fleet.reset_retry_budget()
    fleet.reset_retry_budget()


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
                         fleet=jax_fleet, journal=jax_journal,
                         faults=jax_faults, Registry=JaxRegistry)
    pt = SimpleNamespace(name="torch", model=tm, Engine=ServingEngine,
                         fleet=fleet, journal=torch_journal,
                         faults=faults, Registry=MetricsRegistry)
    return jx, pt


@pytest.fixture(scope="module")
def want(pkgs):
    """``want(prompt, n)``: the greedy tokens of an uninterrupted port
    engine."""
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            eng = ServingEngine(pkgs[1].model, registry=MetricsRegistry(),
                                **ENGINE_KW)
            memo[key] = eng.generate([prompt], max_new_tokens=n)[0]
        return memo[key]
    return run


@pytest.fixture
def pinned_journal_clock(pkgs, monkeypatch):
    """Both journals stamp ``ts`` / ``mono`` from one fixed clock, so their
    files are byte-identical (the crash property tears them at byte
    offsets)."""
    fixed = SimpleNamespace(time=lambda: 1700000000.0,
                            monotonic=lambda: 1000.0)
    for P in pkgs:
        monkeypatch.setattr(P.journal, "time", fixed)


def _fleet(P, n=2, reg=None, **engine_kw):
    reg = reg if reg is not None else P.Registry()
    kw = dict(ENGINE_KW, **engine_kw)
    reps = [P.fleet.LocalReplica(P.Engine(P.model, registry=reg,
                                          replica_id=i, **kw),
                                 replica_id=i)
            for i in range(n)]
    return reps, reg


def _metrics(reg):
    """Every ``fleet.*`` instrument: counters and gauges by value,
    histograms (wall-clock latencies) by sample count."""
    return {name: (m["count"] if m["type"] == "histogram" else m["value"])
            for name, m in reg.snapshot().items()
            if name.startswith("fleet.")}


def _raised(fn):
    try:
        fn()
    except Exception as e:   # the scenario compares what was raised
        return [type(e).__name__, str(e)]
    return None


def _budget(P, capacity=64, refill=0.0):
    return P.fleet.RetryBudget(capacity=capacity, refill_per_s=refill)


def _lines(directory):
    """Every journal file's lines without their ``ts`` / ``mono`` stamps
    (a torn tail kept raw), by file name."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            raw = f.read()
        rows = []
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                rows.append(line.decode())
                continue
            rec.pop("ts", None)
            rec.pop("mono", None)
            rows.append(rec)
        out[name] = rows
    return out


def _recovered(store):
    return [{k: v for k, v in rec.items() if k != "opened_ts"}
            for rec in store.recover()]


def _leaks(reps):
    return [rep.engine.cache.leak_report()["leaked_blocks"] for rep in reps]


# -- JournalStore: the WAL itself ----------------------------------------------
def _wal_roundtrip(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store.open("r1", [1, 2, 3], 8, None, session="u1")
    store.append_tokens("r1", [4, 5])
    store.append_tokens("r1", [6])
    live = _recovered(store)
    lines = _lines(store.directory)
    store.retire("r1", "length")
    return {"live": live, "lines": lines, "retired": _recovered(store),
            "files": sorted(os.listdir(store.directory)),
            "live_count": store.live_count(), "appends": store.appends,
            "ok": {"tokens": live[0]["tokens"] == [4, 5, 6]
                   and not live[0]["finished"],
                   # retired streams still recover, as finished
                   "retired": _recovered(store)[0]["finished"],
                   "gone": store.live_count() == 0}}


def _torn_tail(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store.open("r1", [1, 2], 8, None)
    store.append_tokens("r1", [9, 9])
    with open(store._path("r1"), "ab") as f:
        f.write(b'{"kind": "tok", "t": [7')   # the torn append
    rec = _recovered(store)
    return {"rec": rec, "drops": store.drops,
            "ok": {"complete_only": rec[0]["tokens"] == [9, 9],
                   "counted": store.drops["torn_lines"] == 1}}


def _headerless(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store._append("ghost", {"kind": "tok", "t": [1]})
    rec = _recovered(store)
    files = sorted(os.listdir(store.directory))
    return {"rec": rec, "drops": store.drops, "files": files,
            "ok": {"none": rec == [],
                   "quarantined": files == ["ghost.jsonl.corrupt"]}}


def _fin_before_rename(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store.open("r1", [1], 4, None)
    store.append_tokens("r1", [2, 3])
    # a crash between the fin append and the rename
    store._append("r1", {"kind": "fin", "reason": "length"})
    rec = _recovered(store)
    return {"rec": rec, "ok": {"finished": rec[0]["finished"]
                               and rec[0]["reason"] == "length"}}


def _disp_last(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store.open("r1", [1], 4, None)
    store._append("r1", {"kind": "disp", "replica": 0})
    store._append("r1", {"kind": "disp", "replica": 1})
    rec = _recovered(store)
    return {"rec": rec, "lines": _lines(store.directory),
            "ok": {"last_wins": rec[0]["replica"] == 1}}


def _gc_bounds(P, tmp):
    store = P.fleet.JournalStore(tmp, keep=2)
    for i in range(5):
        store.open(f"r{i}", [1], 4, None)
        store.retire(f"r{i}", "length")
    done = [n for n in os.listdir(store.directory) if n.endswith(".done")]
    # which two survive depends on file mtimes, not on the package
    return {"done": len(done), "live": store.live_count(),
            "ok": {"bounded": len(done) == 2}}


def _keep_env(P, tmp):
    os.environ["PTPU_FLEET_JOURNAL_KEEP"] = "3"
    try:
        keep = P.fleet.JournalStore(tmp).keep
    finally:
        del os.environ["PTPU_FLEET_JOURNAL_KEEP"]
    return {"keep": keep, "default": P.fleet.default_journal_keep(),
            "ok": {"knob": keep == 3}}


def _discard(P, tmp):
    store = P.fleet.JournalStore(tmp)
    store.open("r1", [1], 4, None)
    store.discard("r1")
    store.discard("r1")                       # idempotent
    return {"live": store.live_count(),
            "files": sorted(os.listdir(store.directory)),
            "ok": {"gone": store.live_count() == 0}}


# -- router crash / recover ------------------------------------------------------
def _recover_reattach(P, tmp, want):
    prompts = PROMPTS[:4]
    reps, reg = _fleet(P, 2)
    router = P.fleet.Router(reps, registry=reg, run_dir=tmp,
                            retry_budget=_budget(P))
    rids = [router.submit(p, max_new_tokens=10) for p in prompts]
    while any(len(router.journals[r].tokens) < 2 for r in rids):
        router.pump()
    lines = _lines(router.store.directory)
    del router                                # the "crash"
    r2 = P.fleet.Router(reps, registry=reg, recover=tmp,
                        retry_budget=_budget(P))
    outs = [r2.collect(r, timeout=60) for r in rids]
    return {"lines_at_crash": lines, "recovered": r2.recovered,
            "outs": outs, "live": r2.store.live_count(),
            "metrics": _metrics(reg), "leaks": _leaks(reps),
            "ok": {"reattached": r2.recovered["reattached"] == 4,
                   "exact": [o["tokens"] for o in outs]
                   == [want(p, 10) for p in prompts],
                   "retired": r2.store.live_count() == 0,
                   "no_leak": _leaks(reps) == [0, 0]}}


def _recover_orphan(P, tmp, want):
    reps, reg = _fleet(P, 2)
    router = P.fleet.Router(reps, registry=reg, run_dir=tmp,
                            retry_budget=_budget(P))
    rid = router.submit([1, 2, 3], max_new_tokens=10)
    while len(router.journals[rid].tokens) < 3:
        router.pump()
    victim = router.journals[rid].replica_id
    del router
    reps[victim].engine._state = "stopped"    # the replica died too
    r2 = P.fleet.Router(reps, registry=reg, recover=tmp,
                        retry_budget=_budget(P))
    out = r2.collect(rid, timeout=60)
    return {"recovered": r2.recovered, "out": out, "victim": victim,
            "metrics": _metrics(reg),
            "lines": _lines(r2.store.directory),
            "ok": {"redispatched": r2.recovered["redispatched"] == 1,
                   "exact": out["tokens"] == want([1, 2, 3], 10)}}


def _recover_finished(P, tmp, want):
    reps, reg = _fleet(P, 1, max_seqs=2)
    router = P.fleet.Router(reps, registry=reg, run_dir=tmp)
    rid = router.submit([1, 2], max_new_tokens=3)
    out1 = router.collect(rid, timeout=60)
    # a crash AFTER the fin append but BEFORE the rename
    store = P.fleet.JournalStore(tmp)
    store.open(rid, [1, 2], 3, None, tokens=out1["tokens"])
    store._append(rid, {"kind": "fin", "reason": "length"})
    r2 = P.fleet.Router(reps, registry=reg, recover=tmp)
    out2 = r2.collect(rid, timeout=5)
    return {"out1": out1, "out2": out2, "recovered": r2.recovered,
            "live": r2.store.live_count(),
            "ok": {"finished": r2.recovered["finished"] == 1,
                   "same": out2["tokens"] == out1["tokens"],
                   "retired": r2.store.live_count() == 0}}


def _recover_anonymous(P, tmp, want):
    """The auto-id counter restarts at 0 after a crash but the recovered
    journals keep their fleet-N names: new submissions skip past them."""
    reps, reg = _fleet(P, 1)
    router = P.fleet.Router(reps, registry=reg, run_dir=tmp,
                            retry_budget=_budget(P))
    old = router.submit([1, 2, 3], max_new_tokens=6)   # fleet-0
    router.collect(old, timeout=60)
    del router
    r2 = P.fleet.Router(reps, registry=reg, recover=tmp,
                        retry_budget=_budget(P))
    new = r2.submit([1, 2, 4], max_new_tokens=6)
    out = r2.collect(new, timeout=60)
    return {"ids": [old, new], "out": out,
            "ok": {"fresh": new != old,
                   "exact": out["tokens"] == want([1, 2, 4], 6)}}


def _shed_no_ghost(P, tmp, want):
    reps, reg = _fleet(P, 1, max_seqs=2)
    router = P.fleet.Router(reps, registry=reg, run_dir=tmp,
                            shed_queue_depth=64, retry_budget=_budget(P))
    reps[0].engine._state = "stopped"
    err = _raised(lambda: router.submit([1, 2], max_new_tokens=4))
    return {"error": err, "journals": len(router.journals),
            "live": router.store.live_count(), "metrics": _metrics(reg),
            "ok": {"shed": err[0] == "FleetOverloaded",
                   "no_ghost": not router.journals
                   and router.store.live_count() == 0}}


def _crash_property(seed):
    def scenario(P, tmp, want):
        """Random accept / crash / torn-truncate / recover interleavings:
        completions stay token-exact and allocators leak-free.  Torn
        truncation only shortens the accepted prefix."""
        rng = random.Random(seed)
        reps, reg = _fleet(P, 2)
        router = P.fleet.Router(reps, registry=reg, run_dir=tmp,
                                retry_budget=_budget(P))
        rids = [router.submit(p, max_new_tokens=12) for p in PROMPTS]
        rounds = []
        for _round in range(rng.randint(1, 4)):
            for _ in range(rng.randint(1, 6)):
                router.pump()
            # crash the router; tear a random live journal's tail (never
            # into the header: a torn header is the quarantine path)
            store = router.store
            del router
            live = sorted(n for n in os.listdir(store.directory)
                          if n.endswith(".jsonl"))
            torn = None
            if live and rng.random() < 0.7:
                path = os.path.join(store.directory, rng.choice(live))
                raw = open(path, "rb").read()
                header_end = raw.index(b"\n") + 1
                if len(raw) > header_end:
                    cut = rng.randint(header_end, len(raw) - 1)
                    with open(path, "wb") as f:
                        f.write(raw[:cut])
                    torn = (os.path.basename(path), cut)
            router = P.fleet.Router(reps, registry=reg, recover=tmp,
                                    retry_budget=_budget(P))
            rounds.append({"torn": torn, "recovered": router.recovered,
                           "drops": dict(router.store.drops)})
        outs = [router.collect(r, timeout=120) for r in rids]
        return {"rounds": rounds, "outs": outs, "metrics": _metrics(reg),
                "leaks": _leaks(reps), "live": router.store.live_count(),
                "ok": {"exact": [o["tokens"] for o in outs]
                       == [want(p, 12) for p in PROMPTS],
                       "retired": router.store.live_count() == 0,
                       "no_leak": _leaks(reps) == [0, 0],
                       "all_recovered": all(
                           r["recovered"]["streams"] == len(PROMPTS)
                           for r in rounds)}}
    return scenario


STORE = {"wal_roundtrip": _wal_roundtrip, "torn_tail": _torn_tail,
         "headerless": _headerless, "fin_before_rename": _fin_before_rename,
         "disp_last": _disp_last, "gc_bounds": _gc_bounds,
         "keep_env": _keep_env, "discard": _discard}
RECOVERY = {"reattach": _recover_reattach, "orphan": _recover_orphan,
            "finished": _recover_finished, "anonymous": _recover_anonymous,
            "shed_no_ghost": _shed_no_ghost,
}


def _ok(summary):
    assert summary["ok"] and all(summary["ok"].values()), summary["ok"]


def _both(tmp_path, run):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    return run("jax", str(tmp_path / "jax")), run("torch",
                                                  str(tmp_path / "torch"))


@pytest.mark.parametrize("name", sorted(STORE))
def test_journal_store_matches_jax(name, pkgs, tmp_path,
                                   pinned_journal_clock):
    by = {"jax": pkgs[0], "torch": pkgs[1]}
    ref, got = _both(tmp_path, lambda n, d: STORE[name](by[n], d))
    assert got == ref
    _ok(got)


@pytest.mark.parametrize("name", sorted(RECOVERY))
def test_router_recovery_matches_jax(name, pkgs, want, tmp_path,
                                     pinned_journal_clock):
    by = {"jax": pkgs[0], "torch": pkgs[1]}
    ref, got = _both(tmp_path, lambda n, d: RECOVERY[name](by[n], d, want))
    assert got == ref
    _ok(got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crash_recover_property_matches_jax(seed, pkgs, want, tmp_path,
                                            pinned_journal_clock):
    """The random crash / recover property: the port's completions are
    token-exact in every run.  The JAX run agrees exactly unless a tear
    left a torn tail that its store then appended to (ROADMAP Queue 3):
    the runs agree up to that recovery, and the JAX run lost tokens."""
    by = {"jax": pkgs[0], "torch": pkgs[1]}
    ref, got = _both(tmp_path,
                     lambda n, d: _crash_property(seed)(by[n], d, want))
    _ok(got)
    if ref["ok"]["exact"]:
        assert got == ref
    else:
        first = next(i for i, r in enumerate(ref["rounds"]) if r["torn"])
        assert got["rounds"][:first + 1] == ref["rounds"][:first + 1]
        assert not ref["ok"]["exact"] and ref["ok"]["retired"]


def test_append_after_a_torn_tail(pkgs, tmp_path):
    """Recovery cuts a live file's torn tail off, so the next appends
    start lines of their own: a later recovery reads every token.  The
    JAX store leaves the tail; its next append joins it into one
    unreadable line, and the recovery after that reads a gap."""
    got = {}
    for P in pkgs:
        store = P.fleet.JournalStore(str(tmp_path / P.name))
        store.open("r1", [1, 2], 8, None)
        store.append_tokens("r1", [9, 9])
        with open(store._path("r1"), "ab") as f:
            f.write(b'{"kind": "tok", "t": [7')   # the torn append
        first = _recovered(store)[0]["tokens"]
        store.append_tokens("r1", [3])
        store.append_tokens("r1", [4])
        got[P.name] = (first, _recovered(store)[0]["tokens"])
    assert got == {"jax": ([9, 9], [9, 9, 4]),
                   "torch": ([9, 9], [9, 9, 3, 4])}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovers_in_the_other_package(writer, pkgs, want,
                                               tmp_path):
    """A journal directory written by either package's router recovers
    token-exact in the other's: its streams are orphans there (the other
    package's replicas never saw them) and are re-dispatched from the
    journaled prefix."""
    W, R = (pkgs[0], pkgs[1]) if writer == "jax" else (pkgs[1], pkgs[0])
    run_dir = str(tmp_path)
    reps, reg = _fleet(W, 2)
    router = W.fleet.Router(reps, registry=reg, run_dir=run_dir,
                            retry_budget=_budget(W))
    rids = [router.submit(p, max_new_tokens=10) for p in PROMPTS[:4]]
    while any(len(router.journals[r].tokens) < 2 for r in rids):
        router.pump()
    accepted = [len(router.journals[r].tokens) for r in rids]
    del router
    reps2, reg2 = _fleet(R, 2)
    r2 = R.fleet.Router(reps2, registry=reg2, recover=run_dir,
                        retry_budget=_budget(R))
    assert r2.recovered == {"streams": 4, "reattached": 0,
                            "redispatched": 4, "finished": 0}
    assert [len(r2.journals[r].tokens) for r in rids] == accepted
    outs = [r2.collect(r, timeout=60) for r in rids]
    assert [o["tokens"] for o in outs] == [want(p, 10) for p in PROMPTS[:4]]
    assert r2.store.live_count() == 0
    assert _leaks(reps2) == [0, 0]


# -- circuit breaker + retry budget ---------------------------------------------
def _breaker_trips(P):
    clk = P.faults.expire_clock(0.0)
    br = P.fleet.CircuitBreaker(failures=3, window_secs=10, backoff_secs=2,
                                clock=clk)
    seen = []
    for _ in range(3):
        br.record_failure()
        seen.append((br.state, br.allow()))
    return {"seen": seen, "snap": br.snapshot(),
            "ok": {"trips_at_3": seen == [("closed", True),
                                          ("closed", True),
                                          ("open", False)]
                   and br.trips == 1}}


def _breaker_window(P):
    clk = P.faults.expire_clock(0.0)
    br = P.fleet.CircuitBreaker(failures=3, window_secs=5, backoff_secs=2,
                                clock=clk)
    br.record_failure()
    clk.advance(6.0)                          # the first failure ages out
    br.record_failure()
    br.record_failure()
    return {"snap": br.snapshot(), "ok": {"closed": br.state == "closed"}}


def _breaker_probe_closes(P):
    clk = P.faults.expire_clock(0.0)
    br = P.fleet.CircuitBreaker(failures=1, window_secs=10, backoff_secs=2,
                                clock=clk)
    br.record_failure()
    seen = [(br.state, br.allow())]
    clk.advance(2.0)
    seen.append((br.allow(), br.state))       # THE probe
    seen.append(br.allow())                   # one probe at a time
    br.record_success()
    return {"seen": seen, "snap": br.snapshot(),
            "ok": {"probe": seen == [("open", False), (True, "half_open"),
                                     False],
                   "closed": br.state == "closed",
                   "reset": br.current_backoff() == 2.0}}


def _breaker_backoff(P):
    clk = P.faults.expire_clock(0.0)
    br = P.fleet.CircuitBreaker(failures=1, window_secs=10, backoff_secs=2,
                                clock=clk)
    br.record_failure()
    seen = []
    for _ in range(6):
        clk.advance(br.current_backoff())
        probe = br.allow()                    # half-open probe
        br.record_failure()                   # the probe fails: reopen
        seen.append((probe, br.state, br.current_backoff()))
    return {"seen": seen, "ok": {"doubles_capped": [b for _, _, b in seen]
                                 == [4.0, 8.0, 16.0, 32.0, 32.0, 32.0]}}


def _breaker_callback(P):
    seen = []
    clk = P.faults.expire_clock(0.0)
    br = P.fleet.CircuitBreaker(
        failures=1, window_secs=10, backoff_secs=1, clock=clk,
        on_transition=lambda p, n, _b: seen.append([p, n]))
    br.record_failure()
    clk.advance(1.0)
    br.allow()
    br.record_success()
    return {"seen": seen, "ok": {"fired": seen == [
        ["closed", "open"], ["open", "half_open"], ["half_open", "closed"]]}}


def _budget_spend(P):
    clk = P.faults.expire_clock(0.0)
    b = P.fleet.RetryBudget(capacity=3, refill_per_s=0.0, clock=clk)
    got = [b.try_acquire() for _ in range(4)]
    return {"got": got, "snap": b.snapshot(),
            "ok": {"spent": (b.spent, b.denied) == (3, 1)}}


def _budget_refill(P):
    clk = P.faults.expire_clock(0.0)
    b = P.fleet.RetryBudget(capacity=2, refill_per_s=1.0, clock=clk)
    got = [b.try_acquire(2), b.try_acquire()]
    clk.advance(1.5)
    got += [b.try_acquire(), b.try_acquire()]   # 1.5 refilled, then 0.5
    return {"got": got, "snap": b.snapshot(),
            "ok": {"refilled": got == [True, False, True, False]}}


def _budget_singleton(P):
    P.fleet.reset_retry_budget()
    a = P.fleet.get_retry_budget()
    same = P.fleet.get_retry_budget() is a
    P.fleet.reset_retry_budget()
    fresh = P.fleet.get_retry_budget() is not a
    return {"same": same, "fresh": fresh, "snap": a.snapshot(),
            "ok": {"singleton": same and fresh}}


def _budget_env(P):
    os.environ["PTPU_FLEET_RETRY_BUDGET"] = "7"
    os.environ["PTPU_FLEET_RETRY_REFILL_PER_S"] = "0.5"
    try:
        b = P.fleet.RetryBudget()
    finally:
        del os.environ["PTPU_FLEET_RETRY_BUDGET"]
        del os.environ["PTPU_FLEET_RETRY_REFILL_PER_S"]
    return {"knobs": [b.capacity, b.refill_per_s],
            "defaults": [P.fleet.default_retry_budget(),
                         P.fleet.default_retry_refill_per_s(),
                         P.fleet.default_breaker_failures(),
                         P.fleet.default_breaker_window_secs(),
                         P.fleet.default_breaker_backoff_secs()],
            "ok": {"knobs": (b.capacity, b.refill_per_s) == (7.0, 0.5)}}


HEALTH = {"breaker_trips": _breaker_trips, "breaker_window": _breaker_window,
          "breaker_probe_closes": _breaker_probe_closes,
          "breaker_backoff": _breaker_backoff,
          "breaker_callback": _breaker_callback,
          "budget_spend": _budget_spend, "budget_refill": _budget_refill,
          "budget_singleton": _budget_singleton, "budget_env": _budget_env}


@pytest.mark.parametrize("name", sorted(HEALTH))
def test_breaker_and_budget_match_jax(name, pkgs):
    got = HEALTH[name](pkgs[1])
    assert got == HEALTH[name](pkgs[0])
    _ok(got)


# -- the flap drill: breaker + budget + census under flaky_replica -------------
class CaptureSink:
    """Registry sink that keeps every emitted record."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append({k: v for k, v in record.items() if k != "ts"})

    def flush(self):
        pass

    def close(self):
        pass


def _flaky_restores(P, want):
    reps, _ = _fleet(P, 1, max_seqs=2)
    with P.faults.flaky_replica(reps[0], error_rate=1.0, seed=0) as flake:
        wrapped = "submit" in reps[0].__dict__
        err = _raised(lambda: reps[0].submit(
            {"request_id": "x", "prompt": [1], "max_new_tokens": 1,
             "eos_token_id": None}))
        injected = flake.injected_errors
    restored = "submit" not in reps[0].__dict__
    waiting = reps[0].engine.sched.counts()["waiting"]
    return {"error": err, "injected": injected, "waiting": waiting,
            "ok": {"wrapped": wrapped, "restored": restored,
                   "injected": injected == 1, "nothing_admitted": waiting
                   == 0}}


def _breaker_opens(P, want):
    sink = CaptureSink()
    reps, reg = _fleet(P, 3)
    reg.add_sink(sink)
    budget = P.fleet.RetryBudget(capacity=32, refill_per_s=0.0)
    router = P.fleet.Router(reps, registry=reg, retry_budget=budget,
                            breaker_kw={"failures": 3, "window_secs": 60.0,
                                        "backoff_secs": 1000.0})
    victim = 1
    with P.faults.flaky_replica(reps[victim], error_rate=0.3,
                                seed=7) as flake:
        rids = [router.submit(p, max_new_tokens=10) for p in PROMPTS]
        outs = [router.collect(r, timeout=120) for r in rids]
    fleet_records = [r for r in sink.records
                     if r["kind"] in ("fleet.breaker", "fleet.failover",
                                      "fleet.replica_state", "fleet.shed",
                                      "fleet.deferred")]
    trips = {i: br.trips for i, br in sorted(router.breakers.items())}
    return {"outs": outs, "trips": trips, "census": router.census(),
            "states": router.stats()["states"],
            "budget": [budget.spent, budget.denied, budget.available()],
            "flake": [flake.calls, flake.injected_errors],
            "records": fleet_records, "metrics": _metrics(reg),
            "ok": {"exact": [o["tokens"] for o in outs]
                   == [want(p, 10) for p in PROMPTS],
                   "injected": flake.injected_errors > 0,
                   "only_victim": trips[victim] >= 1 and all(
                       t == 0 for i, t in trips.items() if i != victim),
                   "flapping": router.census()[victim] == "flapping"
                   and router.stats()["states"].get("flapping") == 1,
                   "record": any(r["kind"] == "fleet.breaker"
                                 and r["state"] == "open"
                                 and r["replica"] == victim
                                 for r in sink.records),
                   # no retry storm: retries spent the bounded budget
                   "bounded": budget.spent <= budget.capacity
                   and budget.spent == 32 - budget.available()}}


def _dry_budget(P, want):
    reps, reg = _fleet(P, 2)
    router = P.fleet.Router(reps, registry=reg, retry_max=3,
                            retry_backoff_ms=0.0, sleep=lambda _t: None,
                            retry_budget=P.fleet.RetryBudget(
                                capacity=0, refill_per_s=0.0))
    router.dispatch_fault = P.faults.drop_dispatch(count=1)
    # the first attempt is free; the drop forces a second send, which
    # needs a budget token: a dry bucket degrades to load-shed
    err = _raised(lambda: router.submit([1, 2], max_new_tokens=4))
    return {"error": err, "journals": len(router.journals),
            "metrics": _metrics(reg),
            "ok": {"shed": err[0] == "FleetOverloaded"
                   and "retry budget dry" in err[1],
                   "no_ghost": not router.journals}}


def _census_flapping(P, want):
    reg = P.Registry()
    mgr = P.fleet.LocalReplicaManager(
        lambda i: P.Engine(P.model, registry=reg, replica_id=i,
                           **dict(ENGINE_KW, max_seqs=2)),
        replicas=2, registry=reg)
    mgr.set_flapping(1, True)
    flapping = [mgr.poll_states(), _metrics(reg)]
    mgr.set_flapping(1, False)
    return {"flapping": flapping, "after": [mgr.poll_states(),
                                            _metrics(reg)],
            "ok": {"flapping": flapping[0][1] == "flapping"
                   and flapping[1]["fleet.replicas[state=flapping]"] == 1.0
                   and flapping[1]["fleet.replicas[state=healthy]"] == 1.0,
                   "healthy": mgr.poll_states()[1] == "healthy"}}


FLAP = {"flaky_restores": _flaky_restores, "breaker_opens": _breaker_opens,
        "dry_budget": _dry_budget, "census_flapping": _census_flapping}


@pytest.mark.parametrize("name", sorted(FLAP))
def test_flap_drill_matches_jax(name, pkgs, want):
    got = FLAP[name](pkgs[1], want)
    assert got == FLAP[name](pkgs[0], want)
    _ok(got)


# -- autoscaler control loop (fake clock) ---------------------------------------
class ScalableStub:
    """Replica stub with mutable pressure."""

    def __init__(self, replica_id, pressure=0.0):
        self.replica_id = replica_id
        self.pressure = float(pressure)
        self.up = True

    def serving_stats(self):
        return {"queue_depth": self.pressure, "waiting": 0, "running": 0}

    def healthz(self):
        return (200, "serving")

    def alive(self):
        return self.up

    def stop(self):
        self.up = False


class StubManager:
    """Minimal actuator-protocol manager over :class:`ScalableStub`."""

    def __init__(self, n=1, pressure=0.0):
        self.replicas = [ScalableStub(i, pressure) for i in range(n)]
        self._retired = set()
        self.spawns = 0
        self.retires = []

    def poll_states(self):
        return {i: ("retired" if i in self._retired else "healthy")
                for i in range(len(self.replicas))}

    def spawn(self):
        for idx in sorted(self._retired):
            self._retired.discard(idx)
            self.replicas[idx] = ScalableStub(idx,
                                              self.replicas[0].pressure)
            self.spawns += 1
            return self.replicas[idx]
        self.replicas.append(ScalableStub(len(self.replicas),
                                          self.replicas[0].pressure))
        self.spawns += 1
        return self.replicas[-1]

    def retire(self, idx):
        self._retired.add(idx)
        self.retires.append(idx)

    def set_pressure(self, p):
        for r in self.replicas:
            r.pressure = float(p)


def _scaler(P, **kw):
    clk = P.faults.expire_clock(0.0)
    mgr = StubManager(n=1, pressure=0.0)
    sink = CaptureSink()
    reg = P.Registry()
    reg.add_sink(sink)
    kw.setdefault("slo", P.fleet.ServingSLO(queue_depth=4))
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("window_secs", 10.0)
    kw.setdefault("cooldown_secs", 5.0)
    auto = P.fleet.FleetAutoscaler(mgr, registry=reg, clock=clk, **kw)
    return auto, mgr, clk, sink


def _drive(auto, clk, seconds, dt=1.0):
    actions = []
    t = 0.0
    while t < seconds:
        clk.advance(dt)
        t += dt
        a = auto.step()
        if a:
            actions.append(a)
    return actions


def _scale_records(sink):
    return [r for r in sink.records if r["kind"] == "fleet.autoscale"]


def _burst_up(P, want):
    auto, mgr, clk, sink = _scaler(P)
    mgr.set_pressure(10.0)                    # the SLO burns (> 4)
    actions = _drive(auto, clk, 30)
    ups = [r for r in _scale_records(sink) if r["action"] == "up"]
    return {"actions": actions, "records": _scale_records(sink),
            "stats": auto.stats(),
            "ok": {"up_up": actions[:2] == ["up", "up"] and mgr.spawns == 2,
                   "why": len(ups) == 2
                   and all("queue_depth" in u["why"] for u in ups)}}


def _blocked_at_max(P, want):
    auto, mgr, clk, sink = _scaler(P, max_replicas=1)
    mgr.set_pressure(10.0)
    actions = _drive(auto, clk, 20)
    blocked = [r for r in _scale_records(sink)
               if r["action"] == "blocked_at_max"]
    return {"actions": actions, "records": _scale_records(sink),
            "ok": {"blocked": "blocked_at_max" in actions
                   and mgr.spawns == 0,
                   "record": bool(blocked) and blocked[0]["replicas"] == 1}}


def _idle_down(P, want):
    auto, mgr, clk, sink = _scaler(P)
    mgr.set_pressure(10.0)
    _drive(auto, clk, 16)                     # scale up first
    up = len(mgr.replicas)
    mgr.set_pressure(0.0)                     # the burst is over
    actions = _drive(auto, clk, 60)
    downs = [r for r in _scale_records(sink) if r["action"] == "down"]
    active = [i for i, s in mgr.poll_states().items() if s == "healthy"]
    return {"actions": actions, "records": _scale_records(sink),
            "retires": mgr.retires,
            "ok": {"scaled_up": up >= 2, "down": "down" in actions,
                   "why": bool(downs)
                   and "idle through window" in downs[0]["why"],
                   "floor": len(active) >= auto.min_replicas}}


def _cooldown(P, want):
    auto, mgr, clk, _ = _scaler(P, cooldown_secs=30.0)
    mgr.set_pressure(10.0)
    actions = _drive(auto, clk, 35)
    return {"actions": actions, "ok": {"one_up": actions == ["up"]}}


def _no_flap(P, want):
    auto, mgr, clk, _ = _scaler(P)
    # 12 quiet samples and one burning blip: the burn fraction stays far
    # under the threshold
    steps = []
    for i in range(12):
        clk.advance(1.0)
        mgr.set_pressure(10.0 if i == 5 else 1.0)
        steps.append(auto.step())
    return {"steps": steps, "stats": auto.stats(),
            "ok": {"quiet": steps == [None] * 12 and mgr.spawns == 0}}


def _down_through_router(P, want):
    """Against a real LocalReplicaManager: the victim's streams migrate
    (drain) before the slot retires, and spawn() reuses the slot."""
    reg = P.Registry()
    clk = P.faults.expire_clock(0.0)
    mgr = P.fleet.LocalReplicaManager(
        lambda i: P.Engine(P.model, registry=reg, replica_id=i,
                           **ENGINE_KW),
        replicas=2, registry=reg)
    router = P.fleet.Router(mgr.replicas, manager=mgr, registry=reg,
                            retry_budget=_budget(P))
    rid = router.submit([1, 2, 3], max_new_tokens=12)
    router.pump()
    auto = P.fleet.FleetAutoscaler(mgr, router=router,
                                   slo=P.fleet.ServingSLO(queue_depth=50),
                                   min_replicas=1, max_replicas=2,
                                   window_secs=5.0, cooldown_secs=1.0,
                                   registry=reg, clock=clk)
    # the fleet holds work, so it is never idle: finish first
    out = router.collect(rid, timeout=60)
    steps = []
    for _ in range(8):
        clk.advance(1.0)
        steps.append(auto.step())
    retired = mgr.poll_states()
    mgr.spawn()
    return {"out": out, "steps": steps, "retired": retired,
            "after_spawn": mgr.poll_states(), "metrics": _metrics(reg),
            "ok": {"exact": out["tokens"] == want([1, 2, 3], 12),
                   "down": auto.actions["down"] == 1
                   and "retired" in retired.values(),
                   "reused": sorted(mgr.poll_states().values())
                   == ["healthy", "healthy"]}}


def _scale_env(P, want):
    os.environ["PTPU_FLEET_MIN"] = "2"
    os.environ["PTPU_FLEET_MAX"] = "5"
    try:
        auto = P.fleet.FleetAutoscaler(StubManager(n=2),
                                       registry=P.Registry(),
                                       window_secs=1.0, cooldown_secs=1.0)
    finally:
        del os.environ["PTPU_FLEET_MIN"]
        del os.environ["PTPU_FLEET_MAX"]
    return {"bounds": [auto.min_replicas, auto.max_replicas],
            "defaults": [P.fleet.default_fleet_min(),
                         P.fleet.default_fleet_max(),
                         P.fleet.default_scale_window_secs(),
                         P.fleet.default_scale_cooldown_secs()],
            "ok": {"knobs": (auto.min_replicas, auto.max_replicas)
                   == (2, 5)}}


SCALE = {"burst_up": _burst_up, "blocked_at_max": _blocked_at_max,
         "idle_down": _idle_down, "cooldown": _cooldown,
         "no_flap": _no_flap, "down_through_router": _down_through_router,
         "env_knobs": _scale_env}


@pytest.mark.parametrize("name", sorted(SCALE))
def test_autoscaler_matches_jax(name, pkgs, want):
    got = SCALE[name](pkgs[1], want)
    assert got == SCALE[name](pkgs[0], want)
    _ok(got)


# -- satellite knobs ------------------------------------------------------------
def _drain_slack(P, want):
    default = P.fleet.default_drain_slack_secs()
    os.environ["PTPU_FLEET_DRAIN_SLACK_SECS"] = "1.5"
    try:
        knob = P.fleet.default_drain_slack_secs()
        rep = P.fleet.HttpReplica(0, port=1)
        seen = {}

        def fake_call(path, payload=None, timeout=None):
            seen.update(path=path, payload=payload, timeout=timeout)
            return {"finished": 0, "spilled_records": []}

        rep._call = fake_call
        rep.drain(timeout=2.0)
    finally:
        del os.environ["PTPU_FLEET_DRAIN_SLACK_SECS"]
    return {"default": default, "knob": knob, "call": seen,
            "ok": {"default": default == 30.0,
                   "slack": seen["timeout"] == pytest.approx(3.5)}}


def _engine_slo(P, want):
    eng = P.Engine(P.model, registry=P.Registry(), **dict(ENGINE_KW,
                                                          max_seqs=2))
    eng.generate([[1, 2, 3]], max_new_tokens=4)
    slo = eng.stats()["slo"]
    return {"samples": [slo["ttft_ms"]["samples"],
                        slo["tpot_ms"]["samples"]],
            "ok": {"ordered": slo["ttft_ms"]["p99"]
                   >= slo["ttft_ms"]["p50"] >= 0.0}}


def _admit_idempotent(P, want):
    reg = P.Registry()
    eng = P.Engine(P.model, registry=reg, **ENGINE_KW)
    rec = {"request_id": "dup", "prompt": [1, 2], "max_new_tokens": 4,
           "eos_token_id": None, "output": []}
    ids = [eng.admit_record(rec), eng.admit_record(dict(rec))]
    counts = eng.sched.counts()
    dupes = reg.snapshot()["serve.readmit_dupes"]["value"]
    return {"ids": ids, "counts": counts, "dupes": dupes,
            "ok": {"once": counts["waiting"] + counts["running"] == 1,
                   "counted": dupes == 1.0}}


KNOBS = {"drain_slack": _drain_slack, "engine_slo": _engine_slo,
         "admit_idempotent": _admit_idempotent}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_satellite_knobs_match_jax(name, pkgs, want):
    got = KNOBS[name](pkgs[1], want)
    assert got == KNOBS[name](pkgs[0], want)
    _ok(got)
