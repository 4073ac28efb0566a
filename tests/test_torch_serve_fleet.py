"""Port parity for the serving fleet, part 1: the router's dispatch policy
(fake replicas), token-exact failover and drain migration in process, the
``/statusz`` fleet section, the port's HTTP engine worker, and the
multi-process drills (``slow``).

Each scenario runs through the JAX fleet and the port's on the same numpy
weights (``gpt_tiny``, float32, fused block) and prompts, and the two must
agree exactly: token streams, finish reasons, replica picks, exceptions
(type and message), the ``fleet.*`` counters and gauges (histograms by
sample count), census states and what the replicas received.  Each
scenario also checks its own invariants (``ok``): token streams against an
uninterrupted port engine, as the JAX tests check theirs against the dense
model.  Request tracing is off (``PTPU_TRACE_REQUESTS=0``), since trace ids
are random.  The port's worker is checked on its own (its weights come from
``convert.random_state``, not ``pt.seed``)."""
import contextlib
import json
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
import paddle_tpu.inference.fleet as jax_fleet
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability.monitor import StatusServer as JaxStatusServer
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import fleet
from paddle_tpu_torch.inference.fleet import drills
from paddle_tpu_torch.inference.fleet.worker import build_engine, build_model
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability.monitor import StatusServer
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.testing import faults

pytestmark = [pytest.mark.serving, pytest.mark.faults]

MODEL_KW = dict(hidden_dropout=0.0, attention_dropout=0.0,
                use_fused_block=True, dtype="float32")
ENGINE_KW = dict(max_seqs=4, kv_block_size=4)
# the port worker's spec for the HTTP tests: gpt_tiny's widths, float32,
# on the CPU (a spec without "device" means cuda)
WORKER_SPEC = {"seed": 7,
               "config": {"vocab_size": 1024, "hidden_size": 128,
                          "num_layers": 2, "num_heads": 4,
                          "max_position_embeddings": 256,
                          "hidden_dropout": 0.0, "attention_dropout": 0.0,
                          "use_fused_block": True},
               "engine": {"max_seqs": 4, "kv_block_size": 4},
               "device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh_fleet_state(monkeypatch):
    # the JAX engine refuses to run under a hybrid mesh (earlier files in a
    # full run may leave one installed); trace ids are random, so tracing
    # is off; each scenario starts from a full process-wide retry budget
    dist.set_hybrid_communicate_group(None)
    monkeypatch.setenv("PTPU_TRACE_REQUESTS", "0")
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
                         fleet=jax_fleet, faults=jax_faults,
                         Registry=JaxRegistry, StatusServer=JaxStatusServer)
    pt = SimpleNamespace(name="torch", model=tm, Engine=ServingEngine,
                         fleet=fleet, faults=faults,
                         Registry=MetricsRegistry, StatusServer=StatusServer)
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


class FakeReplica:
    """Replica protocol stub with a scriptable load and liveness."""

    def __init__(self, replica_id, load=0.0, up=True):
        self.replica_id = replica_id
        self.load = float(load)
        self.up = up
        self.submitted = []

    def submit(self, record):
        if not self.up:
            raise ConnectionError(f"replica {self.replica_id} down")
        self.submitted.append(record)

    def poll(self, rid, start=0):
        if not self.up:
            raise ConnectionError(f"replica {self.replica_id} down")
        return {"tokens": [], "finished": False, "reason": None}

    def pump(self):
        return False

    def serving_stats(self):
        return {"queue_depth": self.load, "waiting": 0, "running": 0}

    def healthz(self):
        return (200, "serving") if self.up else (503, "dead")

    def alive(self):
        return self.up


def _fake_summary(reps, reg, **extra):
    out = {"submitted": [r.submitted for r in reps],
           "metrics": _metrics(reg)}
    out.update(extra)
    return out


# -- dispatch policy: fake replicas, no model --------------------------------
def _least_loaded(P):
    reps = [FakeReplica(0, load=5), FakeReplica(1, load=1),
            FakeReplica(2, load=9)]
    reg = P.Registry()
    P.fleet.Router(reps, registry=reg).submit([1, 2], max_new_tokens=4)
    return _fake_summary(reps, reg, ok={
        "least_loaded": [len(r.submitted) for r in reps] == [0, 1, 0]})


def _affinity(P):
    reps = [FakeReplica(0, load=5), FakeReplica(1, load=1)]
    reg = P.Registry()
    router = P.fleet.Router(reps, registry=reg)
    router.submit([1], max_new_tokens=4, session="u1")
    first = 0 if reps[0].submitted else 1
    # the second stream of the session lands on the same replica, though
    # the other one is now less loaded
    reps[first].load = 50
    router.submit([2], max_new_tokens=4, session="u1")
    return _fake_summary(reps, reg, ok={
        "affine": len(reps[first].submitted) == 2})


def _affinity_broken(P):
    reps = [FakeReplica(0, load=0), FakeReplica(1, load=5)]
    reg = P.Registry()
    router = P.fleet.Router(reps, registry=reg)
    router.submit([1], max_new_tokens=4, session="u1")
    reps[0].up = False
    router.submit([2], max_new_tokens=4, session="u1")
    return _fake_summary(reps, reg, ok={
        "moved": [len(r.submitted) for r in reps] == [1, 1]})


def _admission_shed(P):
    reps = [FakeReplica(0, load=40), FakeReplica(1, load=30)]
    reg = P.Registry()
    router = P.fleet.Router(reps, registry=reg, shed_queue_depth=64)
    err = _raised(lambda: router.submit([1], max_new_tokens=4))
    return _fake_summary(reps, reg, error=err, journals=len(router.journals),
                         ok={"shed": err[0] == "FleetOverloaded"
                             and "aggregate depth" in err[1]})


def _no_healthy(P):
    reps = [FakeReplica(0, up=False), FakeReplica(1, up=False)]
    reg = P.Registry()
    err = _raised(lambda: P.fleet.Router(reps, registry=reg).submit(
        [1], max_new_tokens=4))
    return _fake_summary(reps, reg, error=err, ok={
        "shed": err[0] == "FleetOverloaded" and "0 healthy" in err[1]})


def _exhausted(P):
    reps = [FakeReplica(0), FakeReplica(1)]
    reg = P.Registry()
    router = P.fleet.Router(reps, registry=reg, retry_max=2,
                            retry_backoff_ms=0.0, sleep=lambda _t: None)
    router.dispatch_fault = P.faults.drop_dispatch(count=10**6)
    err = _raised(lambda: router.submit([1], max_new_tokens=4))
    return _fake_summary(reps, reg, error=err, ok={
        "named": err[0] == "DispatchExhausted" and "[0, 1]" in err[1]
        and "3 attempts" in err[1]})


def _transient_drop(P):
    reps = [FakeReplica(0), FakeReplica(1)]
    reg = P.Registry()
    slept = []
    router = P.fleet.Router(reps, registry=reg, retry_max=3,
                            retry_backoff_ms=10.0, sleep=slept.append)
    fault = P.faults.drop_dispatch(count=3)
    router.dispatch_fault = fault
    rid = router.submit([1], max_new_tokens=4)
    # one retry round (2 drops on attempt 0, 1 on attempt 1): one backoff
    # sleep at the base delay
    return _fake_summary(reps, reg, rid=rid, fired=fault.fired, slept=slept,
                         ok={"landed": sum(len(r.submitted) for r in reps)
                             == 1, "slept": slept == [0.010]})


def _drop_scoped(P):
    fault = P.faults.drop_dispatch(count=5, replica_id=1)
    fault(0, {"request_id": "a"})     # another replica: passes
    before = fault.fired
    err = _raised(lambda: fault(1, {"request_id": "a"}))
    return {"fired": [before, fault.fired], "error": err,
            "ok": {"scoped": before == 0 and fault.fired == 1
                   and err[0] == "ConnectionError"}}


# -- token-exact failover and migration, in process --------------------------
def _failover(P, tmp, want):
    prompts = [[1, 2, 3 + i] for i in range(3)]
    reps, reg = _fleet(P, 2)
    router = P.fleet.Router(reps, registry=reg)
    rids = [router.submit(p, max_new_tokens=10) for p in prompts]
    # accept a few tokens, then hard-stop whichever replica serves the
    # first stream (a simulated SIGKILL: no drain, no spill)
    while len(router.journals[rids[0]].tokens) < 3:
        router.pump()
    victim = router.journals[rids[0]].replica_id
    reps[victim].engine._state = "stopped"
    outs = [router.collect(r, timeout=60) for r in rids]
    leaks = [rep.engine.cache.leak_report()["leaked_blocks"]
             for i, rep in enumerate(reps) if i != victim]
    return {"outs": outs, "victim": victim, "failovers": router.failovers,
            "metrics": _metrics(reg), "census": router.census(),
            "survivor_leaks": leaks,
            "ok": {"exact": [o["tokens"] for o in outs]
                   == [want(p, 10) for p in prompts],
                   "failover": router.failovers >= 1,
                   "counted": _metrics(reg)["fleet.failovers"]
                   == router.failovers,
                   "no_leak": leaks == [0]}}


def _spill_format(P, tmp, want):
    reps, reg = _fleet(P, 1, max_seqs=2)
    router = P.fleet.Router(reps, registry=reg)
    rid = router.submit([1, 2, 3], max_new_tokens=8, eos_token_id=9)
    while len(router.journals[rid].tokens) < 2:
        router.pump()
    rec = router.journals[rid].record()
    # it round-trips through a fresh engine's admit_record
    fresh = P.Engine(P.model, registry=P.Registry(), max_seqs=2,
                     kv_block_size=4)
    return {"record": rec, "admitted": fresh.admit_record(rec),
            "ok": {"prompt": rec["prompt"] == [1, 2, 3],
                   "output": rec["output"] == router.journals[rid].tokens,
                   "limits": (rec["max_new_tokens"], rec["eos_token_id"])
                   == (8, 9)}}


def _drain_migration(P, tmp, want):
    prompts = [[1, 2, 3 + i] for i in range(4)]
    # both replicas share one run_dir: the per-replica namespace keeps
    # their spill files apart
    reps, reg = _fleet(P, 2, run_dir=tmp)
    router = P.fleet.Router(reps, registry=reg)
    rids = [router.submit(p, max_new_tokens=12) for p in prompts]
    router.pump()
    moved = router.drain_replica(0, timeout=0.0)
    live_on_0 = [r for r in rids if router.journals[r].replica_id == 0
                 and not router.journals[r].finished]
    outs = [router.collect(r, timeout=60) for r in rids]
    spill = os.path.join(tmp, "serve", "replica-0", "spill.json")
    payload = json.load(open(spill)) if os.path.exists(spill) else None
    return {"outs": outs, "moved": moved, "live_on_0": live_on_0,
            "migrations": router.migrations, "metrics": _metrics(reg),
            "spill": payload,
            "ok": {"exact": [o["tokens"] for o in outs]
                   == [want(p, 12) for p in prompts],
                   "rehomed": not live_on_0, "moved": moved > 0,
                   "counted": router.migrations == moved
                   == _metrics(reg)["fleet.migrations"],
                   "spilled": payload is not None
                   and payload["version"] == 1}}


def _statusz(P, tmp, want):
    reps, reg = _fleet(P, 2, max_seqs=2)
    router = P.fleet.Router(reps, registry=reg)
    rid = router.submit([1, 2, 3], max_new_tokens=4)
    router.collect(rid, timeout=60)
    page = P.StatusServer(registry=reg, router=router).statusz()["fleet"]
    # wall-clock latencies: compared by their sample counts
    for key in ("ttft_ms", "tpot_ms"):
        page[key] = page[key]["count"]
        page["slo"][key] = page["slo"][key]["samples"]
    page["slow_requests"] = [(r["request_id"], r["state"], r["tokens"],
                              r["failovers"], r["replica"])
                             for r in page["slow_requests"]]
    return {"page": page, "ok": {
        "dispatched": page["dispatch"] >= 1, "replicas": page["replicas"] == 2,
        "healthy": page["states"].get("healthy") == 2,
        "finished": page["streams"]["finished"] == 1}}


FAKE = {"least_loaded": _least_loaded, "affinity": _affinity,
        "affinity_broken": _affinity_broken, "admission_shed": _admission_shed,
        "no_healthy": _no_healthy, "exhausted": _exhausted,
        "transient_drop": _transient_drop, "drop_scoped": _drop_scoped}
MODEL = {"failover": _failover, "spill_format": _spill_format,
         "drain_migration": _drain_migration, "statusz": _statusz}


def _ok(summary):
    assert summary["ok"] and all(summary["ok"].values()), summary["ok"]


@pytest.mark.parametrize("name", sorted(FAKE))
def test_dispatch_policy_matches_jax(name, pkgs):
    jx, pt = pkgs
    got = FAKE[name](pt)
    assert got == FAKE[name](jx)
    _ok(got)


@pytest.mark.parametrize("name", sorted(MODEL))
def test_in_process_fleet_matches_jax(name, pkgs, want, tmp_path):
    jx, pt = pkgs
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = MODEL[name](jx, str(tmp_path / "jax"), want)
    got = MODEL[name](pt, str(tmp_path / "torch"), want)
    assert got == ref
    _ok(got)


# -- the port's HTTP engine worker --------------------------------------------
@contextlib.contextmanager
def _time_limit(seconds):
    """Raise TimeoutError in this (the main) thread after ``seconds``: a
    blocking read of a hung worker cannot hold the suite."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _record(rid, prompt, n):
    return {"request_id": rid, "prompt": prompt, "output": [],
            "max_new_tokens": n, "eos_token_id": None, "preemptions": 0,
            "trace_id": None}


def test_worker_http_routes(tmp_path):
    """One port worker on the CPU: handshake, /healthz, /submit, /poll
    while the engine works, /statusz, /drain with the spill under the
    replica's own namespace, and /shutdown."""
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    n = 40
    model = build_model(WORKER_SPEC)
    want = ServingEngine(model, registry=MetricsRegistry(),
                         **WORKER_SPEC["engine"]).generate(
                             prompts, max_new_tokens=n)
    mgr = fleet.ReplicaManager(WORKER_SPEC, replicas=1,
                               registry=MetricsRegistry(),
                               run_dir=str(tmp_path), spawn_timeout=60)
    with _time_limit(90):
        try:
            [rep] = mgr.start()
            assert rep.process.poll() is None
            assert rep.healthz() == (200, "serving")
            assert mgr.poll_states() == {0: "healthy"}
            for i, p in enumerate(prompts):
                rep.submit(_record(f"r{i}", p, n))
            # the step loop yields its lock between steps: a poll is
            # answered while the engine still has work
            seen = []
            while True:
                out = rep.poll("r0", start=0)
                seen.append(len(out["tokens"]))
                if out["finished"] or 2 <= seen[-1] < n:
                    break
            assert not out["finished"], seen
            report = rep.drain(timeout=0.0)
            assert report["spilled_records"]
            spill = tmp_path / "serve" / "replica-0" / "spill.json"
            payload = json.loads(spill.read_text())
            assert payload["version"] == 1
            assert payload["spilled"] == report["spilled_records"]
            # stopped: 503 with the engine's state, which the census
            # reads as draining
            assert rep.healthz() == (503, "stopped")
            assert mgr.poll_states() == {0: "draining"}
            # the spill resumes token-exact in a fresh engine
            fresh = ServingEngine(model, registry=MetricsRegistry(),
                                  **WORKER_SPEC["engine"])
            fresh.resume(str(spill))
            fresh.run()
            finished = {r["request_id"] for r in report["spilled_records"]}
            for i, p in enumerate(prompts):
                rid = f"r{i}"
                if rid in finished:
                    got = fresh.sched.finished[rid].output
                else:
                    got = rep.poll(rid)["tokens"]
                assert got == want[i], (rid, got)
            rep.stop()
            assert rep.process.wait(timeout=30) == 0
            assert not rep.alive()
        finally:
            mgr.stop()


def test_worker_spawn_failure_raises_with_exit_code(tmp_path):
    """A worker that dies before its handshake (here: a spec the model
    rejects) raises with its exit code; the manager never serves it."""
    bad = dict(WORKER_SPEC, config=dict(WORKER_SPEC["config"],
                                        num_heads=3))
    mgr = fleet.ReplicaManager(bad, replicas=1, registry=MetricsRegistry(),
                               run_dir=str(tmp_path), spawn_timeout=60)
    with _time_limit(90):
        with pytest.raises(RuntimeError, match=r"died before handshake "
                                               r"\(rc=1\)"):
            mgr.start()
    assert mgr.replicas == []


def test_build_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: no device means cuda and succeeds")
    spec = {k: v for k, v in WORKER_SPEC.items() if k != "device"}
    with pytest.raises(UnavailableError, match="no CUDA device"):
        build_engine(spec, 0)


def test_worker_spawn_puts_the_package_on_the_path(tmp_path, monkeypatch):
    """``_spawn`` runs the port's worker module with the checkout on the
    child's PYTHONPATH (a script reaches the package through sys.path,
    which a child does not inherit) and sets no JAX platform."""
    seen = {}

    class Proc:
        pid = 1
        returncode = 3

        def __init__(self, cmd, env, **kw):
            seen["cmd"], seen["env"] = cmd, env
            self.stdout = self

        def readline(self):
            return ""

        def poll(self):
            return self.returncode

    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    mgr = fleet.ReplicaManager(WORKER_SPEC, replicas=1,
                               registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="rc=3"):
        mgr.start()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert seen["cmd"][1:3] == ["-m",
                                "paddle_tpu_torch.inference.fleet.worker"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep) == [repo,
                                                           "/elsewhere"]
    assert "JAX_PLATFORMS" not in seen["env"]


# -- the multi-process drills (slow) ------------------------------------------
DRILL_SPEC = dict(WORKER_SPEC, engine={"max_seqs": 4})
DRILL_PROMPTS = [[1, 2, 3 + i] for i in range(6)]


@pytest.mark.slow
def test_sigkill_drill(tmp_path):
    with _time_limit(400):
        ev = drills.sigkill_drill(str(tmp_path), DRILL_SPEC, DRILL_PROMPTS,
                                  max_new=80)
    assert ev["kill_fired"] == 1 and ev["token_exact"] == 6
    assert ev["failovers"] >= 1 and ev["survivor_leaked_blocks"] == 0
    assert ev["statusz_states"].get("dead") == 1


@pytest.mark.slow
def test_rolling_upgrade_drill(tmp_path):
    with _time_limit(400):
        ev = drills.rolling_upgrade(str(tmp_path), DRILL_SPEC,
                                    DRILL_PROMPTS, max_new=48)
    assert ev["dropped"] == 0 and ev["token_exact"] == 6
    assert ev["restarts"] == 2 and ev["statusz_states"] == {"healthy": 2}


@pytest.mark.slow
def test_router_crash_drill(tmp_path):
    with _time_limit(400):
        ev = drills.router_crash_drill(str(tmp_path), DRILL_SPEC,
                                       DRILL_PROMPTS, max_new=80)
    assert ev["token_exact"] == 6 and ev["leaked_blocks"] == 0
    assert ev["journal_live"] == 0
    assert ev["recovered"]["streams"] == 6


def test_drills_cli_runs_on_the_cpu():
    """``python -m paddle_tpu_torch.inference.fleet.drills`` with
    ``--device cpu``: the in-process autoscale drill prints its evidence
    line."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.inference.fleet.drills",
         "--autoscale_drill", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=repo)
    assert out.returncode == 0, out.stderr[-2000:]
    ev = json.loads(out.stdout.strip().splitlines()[-1])
    assert ev["drill"] == "autoscale" and ev["token_exact"] == 6
    assert {"up", "blocked_at_max", "down"} <= set(ev["actions"])
    assert ev["active_end"] == 1
