"""Port parity of the elastic checkpoint chain and the state-integrity
guard (``paddle_tpu_torch/distributed/elastic.py``,
``paddle_tpu_torch/supervisor/integrity.py``) on the CPU, against the JAX
package.  Each scenario runs once through each package and the two
outcomes must be equal:

- ``ElasticTrainState`` as in ``tests/test_fault_tolerance.py:199-345``
  and ``tests/test_elastic_fleet.py:61-150``: the corrupt-newest fallback
  and its quarantine, a torn manifest, every step corrupt, a failed save
  that commits nothing, gc of stale debris and the quarantine bound, the
  SIGTERM flush (mid-run, mid-save, after a failed async save), the world
  descriptor and generation fencing; the two chains restore each other;
- ``IntegrityGuard`` as in ``tests/test_integrity.py``: majority
  attribution, the ambiguous split, the common step, interval gating,
  the replay audit's three verdicts, resync offer / take / timeout / gc,
  and the three-replica bit-flip drill through ``Model``: the desync
  named at the flip's step, the suspect's audit ``sdc_suspect``, the
  resync heal, equal digests afterwards and losses equal to an unfaulted
  run's;
- a checkpoint committed by the JAX ``RunSupervisor`` restores into the
  port's ``Model`` and training continues.

Tolerances: restored values, digests, steps, verdicts and directory
listings exact; losses across packages within ``LOSS_RTOL`` = 1e-5
relative (float32 on both sides; within one package the drill's losses
are compared bit for bit, as the JAX test does).
"""
import json
import os
import signal
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import supervisor as jsup
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.distributed.fingerprint import digest_tree_host as jdigest
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.supervisor.integrity import IntegrityGuard as JGuard
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.utils.retry import RetriesExhausted as JRetriesExhausted
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import supervisor as tsup
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.distributed.fingerprint import \
    digest_tree_host as tdigest
from paddle_tpu_torch.hapi import Model as TModel
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.observability.monitor import StatusServer
from paddle_tpu_torch.supervisor.integrity import IntegrityGuard as TGuard
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.utils.retry import RetriesExhausted as TRetriesExhausted

LOSS_RTOL = 1e-5


def _j_template(n=16):
    return {"w": jax.ShapeDtypeStruct((n,), np.float32),
            "step": jax.ShapeDtypeStruct((), np.int32)}


def _t_template(n=16):
    return {"w": torch.zeros(n), "step": torch.zeros((), dtype=torch.int32)}


J = types.SimpleNamespace(
    name="jax", el=jel, ck=jck, faults=jfaults, Guard=JGuard,
    digest=jdigest, template=_j_template, RetriesExhausted=JRetriesExhausted,
    array=lambda a: jnp.asarray(a), like=lambda t: jax.tree_util.tree_map(
        lambda x: x, t))
T = types.SimpleNamespace(
    name="torch", el=tel, ck=tck, faults=tfaults, Guard=TGuard,
    digest=tdigest, template=_t_template, RetriesExhausted=TRetriesExhausted,
    array=lambda a: torch.from_numpy(np.array(a)),
    like=lambda t: {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in t.items()})
PKGS = (J, T)


def _state(P, seed=0, n=16):
    return {"w": P.array(np.random.RandomState(seed).randn(n)
                         .astype(np.float32)),
            "step": P.array(np.asarray(seed, np.int32))}


def _mgr(P, d, **kw):
    kw.setdefault("install_sigterm_handler", False)
    return P.el.ElasticTrainState(d, **kw)


def _both(fn, tmp_path):
    out = []
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir()
        out.append(fn(P, str(d)))
    return out


def _w(state):
    return np.asarray(state["w"]).tolist() if state is not None else None


# -- ElasticTrainState ------------------------------------------------------
def _corrupt_newest(P, d):
    mgr = _mgr(P, d, save_interval_steps=2, keep=4)
    for s in (2, 4):
        mgr.save(s, _state(P, s), use_async=False)
    P.faults.corrupt_shard(os.path.join(d, "step-4"), offset=-2)
    events = []
    mgr.set_event_sink(lambda kind, **f: events.append(
        (kind, f.get("step"), f.get("reason"))))
    restored, start = mgr.restore_or(lambda: None, P.template)
    return (start, _w(restored), sorted(os.listdir(d)),
            [e for e in events if e[0] != "restore.fallback"][:1],
            mgr.last_good_step())


def _torn_manifest(P, d):
    mgr = _mgr(P, d, save_interval_steps=1, keep=4)
    for s in (1, 2):
        mgr.save(s, _state(P, s), use_async=False)
    P.faults.corrupt_manifest(os.path.join(d, "step-2"))
    restored, start = mgr.restore_or(lambda: None, P.template)
    return start, _w(restored), sorted(os.listdir(d))


def _all_corrupt(P, d):
    mgr = _mgr(P, d, keep=4)
    for s in (1, 2):
        mgr.save(s, _state(P, s), use_async=False)
    for s in (1, 2):
        P.faults.corrupt_shard(os.path.join(d, f"step-{s}"), offset=-2)
    state, start = mgr.restore_or(lambda: {"fresh": True}, P.template)
    return start, state, P.el.committed_checkpoints(d)


def _failed_save(P, d):
    mgr = _mgr(P, d)
    with P.faults.fast_retries(max_attempts=2):
        with P.faults.FaultInjector() as fi:
            fi.fail_writes(first=1, times=99)
            with pytest.raises(P.RetriesExhausted):
                mgr.save(3, _state(P, 3), use_async=False)
    return P.el.latest_checkpoint(d), fi.write_count, sorted(os.listdir(d))


def _gc_debris(P, d):
    for name in ("step-1.tmp", "step-0.corrupt", "step-2.corrupt",
                 "step-4.corrupt", "step-3", "step-9.tmp"):
        os.makedirs(os.path.join(d, name))
    mgr = _mgr(P, d, keep=2)
    mgr.save(5, _state(P, 5), use_async=False)
    mgr.save(6, _state(P, 6), use_async=False)
    mgr.save(7, _state(P, 7), use_async=False)
    return sorted(os.listdir(d))


def _corrupt_gc_bound(P, d):
    for step in (1, 2, 3, 4, 5):
        os.makedirs(os.path.join(d, f"step-{step}.corrupt"))
    mgr = P.el.ElasticTrainState(d, keep=2, corrupt_keep=2,
                                 install_sigterm_handler=False)
    mgr.save(10, {"w": P.array(np.ones(4, np.float32))}, use_async=False)
    return sorted(n for n in os.listdir(d) if n.endswith(".corrupt"))


def _sigterm_mid_run(P, d):
    orig = signal.getsignal(signal.SIGTERM)
    try:
        mgr = P.el.ElasticTrainState(d, save_interval_steps=1000,
                                     install_sigterm_handler=True)
        mgr._prev_handler = lambda *a: None    # don't kill pytest
        rng = np.random.RandomState(0)
        state = None
        for step in range(1, 6):
            state = {"w": P.array(rng.randn(16).astype(np.float32)),
                     "step": P.array(np.asarray(step, np.int32))}
            mgr.maybe_save(step, state)
            if step == 5:
                os.kill(os.getpid(), signal.SIGTERM)
        path = P.el.latest_checkpoint(d)
        restored, start = _mgr(P, d).restore_or(lambda: None, P.template)
        return (os.path.basename(path), start,
                _w(restored) == _w(state))
    finally:
        signal.signal(signal.SIGTERM, orig)


def _sigterm_mid_save(P, d):
    orig = signal.getsignal(signal.SIGTERM)
    try:
        mgr = P.el.ElasticTrainState(d, save_interval_steps=1000,
                                     install_sigterm_handler=True)
        mgr._prev_handler = lambda *a: None
        state = _state(P, 11)
        mgr.maybe_save(11, state)
        with P.faults.FaultInjector() as fi:
            fi.sigterm_on_write(1)
            mgr.save(11, state, use_async=False)
        back = P.ck.load_sharded(P.el.latest_checkpoint(d), P.template())
        return ("sigterm" in {k for _, k, _p in fi.injected},
                os.path.basename(P.el.latest_checkpoint(d)),
                _w(back) == _w(state))
    finally:
        signal.signal(signal.SIGTERM, orig)


def _sigterm_after_failed_async(P, d):
    mgr = _mgr(P, d)
    state = _state(P, 12)
    mgr.maybe_save(12, state)
    with P.faults.fast_retries(max_attempts=2):
        with P.faults.FaultInjector() as fi:
            fi.fail_writes(first=1, times=99)
            mgr.save(12, state)      # async; fails on its thread
            mgr._pending._thread.join()
    mgr._prev_handler = lambda *a: None
    mgr._on_sigterm(signal.SIGTERM, None)          # must not raise
    return os.path.basename(P.el.latest_checkpoint(d))


def _fencing(P, d):
    el = P.el
    desc = el.write_world(d, generation=3, members=[2, 0, 1], min_size=1,
                          max_size=4, reason="test")
    roundtrip = (el.read_world(d) == desc, desc["members"],
                 desc["world_size"], el.read_world(d + "-none"))
    el.write_world(d, generation=0, members=[0, 1])
    events = []
    mgr = el.ElasticTrainState(os.path.join(d, "ck"),
                               install_sigterm_handler=False,
                               event_sink=lambda k, **f: events.append(k))
    mgr.bind_world(d)
    st = {"w": P.array(np.arange(8, dtype=np.float32))}
    mgr.save(5, st, use_async=False)
    el.write_world(d, generation=1, members=[1], reason="lost-worker:0")
    with pytest.raises(el.StaleGeneration):
        mgr.save(7, st, use_async=False)
    stale = (mgr.last_good_step(), "elastic.fence_rejected" in events)
    # an async commit's fence surfaces from wait()
    el.write_world(d, generation=0, members=[0])
    amgr = el.ElasticTrainState(os.path.join(d, "ack"),
                                install_sigterm_handler=False)
    amgr.bind_world(d)
    el.write_world(d, generation=2, members=[], reason="retired")
    amgr.save(3, st, use_async=True)
    with pytest.raises(el.StaleGeneration):
        amgr.wait()
    # a member of the newer world may commit, until it is retired
    el.write_world(d, generation=0, members=[0, 1])
    mmgr = el.ElasticTrainState(os.path.join(d, "mck"),
                                install_sigterm_handler=False)
    mmgr.bind_world(d, worker_id=0)
    el.write_world(d, generation=1, members=[0], reason="lost-worker:1")
    mmgr.save(4, st, use_async=False)
    el.write_world(d, generation=2, members=[1], reason="swap")
    with pytest.raises(el.StaleGeneration):
        mmgr.save(6, st, use_async=False)
    return (roundtrip, stale, amgr.last_good_step(), mmgr.last_good_step())


ELASTIC_SCENARIOS = [_corrupt_newest, _torn_manifest, _all_corrupt,
                     _failed_save, _gc_debris, _corrupt_gc_bound,
                     _sigterm_mid_run, _sigterm_mid_save,
                     _sigterm_after_failed_async, _fencing]


@pytest.mark.parametrize("scenario", ELASTIC_SCENARIOS,
                         ids=lambda f: f.__name__.strip("_"))
def test_elastic_scenario_matches_jax(scenario, tmp_path):
    jax_out, port_out = _both(scenario, tmp_path)
    assert port_out == jax_out


def test_elastic_expectations(tmp_path):
    """The JAX tests' own assertions, on the port's outcomes."""
    d = tmp_path
    start, w, names, quarantined, last = _corrupt_newest(T, str(d / "a"))
    assert start == 3 and w == _w(_state(T, 2))
    assert "step-4.corrupt" in names and "step-4" not in names
    assert quarantined == [("checkpoint_quarantined", 4, "corruption")]
    assert _all_corrupt(T, str(d / "b"))[:2] == (0, {"fresh": True})
    assert _gc_debris(T, str(d / "c")) == [
        "step-2.corrupt", "step-4.corrupt", "step-6", "step-7",
        "step-9.tmp"]
    assert _sigterm_mid_run(T, str(d / "d")) == ("step-5", 6, True)
    assert _sigterm_after_failed_async(T, str(d / "e")) == "step-12"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chains_restore_across_packages(writer, tmp_path):
    """A chain committed by one package (with its fingerprint stamp)
    restores in the other, and a corrupt newest step falls back there."""
    W, R = (J, T) if writer == "jax" else (T, J)
    d = str(tmp_path)
    mgr = _mgr(W, d, keep=3)
    for s in (2, 4):
        mgr.save(s, _state(W, s), use_async=False)
    W.faults.corrupt_shard(os.path.join(d, "step-4"), offset=-2)
    restored, start = _mgr(R, d).restore_or(lambda: None, R.template)
    assert start == 3 and _w(restored) == _w(_state(W, 2))
    assert int(np.asarray(restored["step"])) == 2


# -- IntegrityGuard -----------------------------------------------------------
def _tree(P, seed=0):
    rng = np.random.RandomState(seed)
    tree = {"params": {"w": rng.randn(37, 19).astype(np.float32),
                       "b": rng.randn(11).astype(np.float32)},
            "opt": {"step": np.asarray(3, np.int32),
                    "m": rng.randn(64).astype(np.float32)}}
    return {k: {n: P.array(v) for n, v in sub.items()}
            for k, sub in tree.items()}


def _guards(P, d, n=3, **kw):
    return [P.Guard(d, worker_id=i, every=2, expected=n, action="resync",
                    **kw) for i in range(n)]


def _guard_compare(P, d):
    out = []
    g0, g1, g2 = _guards(P, os.path.join(d, "a"))
    tree = _tree(P)
    bad = P.faults.flip_tree_bit(tree, "params/w", bit=3)
    g0.publish(4, g0.fingerprint.digest(tree))
    v = g0.compare()
    out.append((v.ok, v["step"]))                 # waits for everyone
    g1.publish(4, g1.fingerprint.digest(tree))
    g2.publish(4, g2.fingerprint.digest(bad))
    v = g0.compare()
    out.append((v.ok, v.suspects, v["ambiguous"], v["majority"],
                g2.fingerprint.digest(bad).diff(g0.fingerprint.digest(tree))))
    h0, h1 = _guards(P, os.path.join(d, "b"), n=2)
    h0.publish(4, h0.fingerprint.digest(tree))
    h1.publish(4, h1.fingerprint.digest(bad))
    v = h0.compare()
    out.append((v.ok, v["ambiguous"], v.suspects))
    k = _guards(P, os.path.join(d, "c"))
    for g in k:
        g.publish(2, g.fingerprint.digest(tree))
    k[0].publish(4, k[0].fingerprint.digest(tree))
    v = k[0].compare()
    out.append((v.ok, v["step"]))
    (single,) = _guards(P, os.path.join(d, "d"), n=1)
    out.append((single.maybe_check(1, tree), single.maybe_check(2, tree).ok,
                single.checks))
    off = P.Guard(os.path.join(d, "e"), every=0)
    out.append((off.enabled, off.maybe_check(2, tree)))
    return out


def _replay_audit(P, d):
    g = P.Guard(d, every=2, expected=1)
    out = [g.audit()["verdict"]]
    tree = _tree(P)
    g.last_fingerprint = g.fingerprint.digest(tree)
    g.stash_replay(2, tree, None)
    other = P.faults.flip_tree_bit(tree, "params/w", bit=3)
    seq = [tree, other]
    out += [g.audit(lambda s, i: s)["verdict"],
            g.audit(lambda s, i: other)["verdict"],
            g.audit(lambda s, i: seq.pop(0))["verdict"]]
    return out


def _resync(P, d):
    g0 = P.Guard(d, worker_id=0, every=2, expected=2, action="resync",
                 resync_timeout=2.0)
    g2 = P.Guard(d, worker_id=2, every=2, expected=2, action="resync",
                 resync_timeout=0.2)
    tree = _tree(P)
    tree["resid"] = {"w": P.array(np.ones(5, np.float32))}
    g0.offer_resync(4, tree)
    healed = g2.take_resync(4, lambda: P.like(tree))
    timed_out = g2.take_resync(6, lambda: P.like(tree))
    for step in (6, 8):
        g0.offer_resync(step, tree)
    left = sorted(n for n in os.listdir(os.path.join(d, "integrity"))
                  if n.startswith("resync-step-"))
    return (P.digest(healed).hex() == P.digest(tree).hex(),
            np.asarray(healed["resid"]["w"]).tolist(), timed_out, left)


@pytest.mark.parametrize("scenario", [_guard_compare, _replay_audit,
                                      _resync],
                         ids=lambda f: f.__name__.strip("_"))
def test_integrity_scenario_matches_jax(scenario, tmp_path):
    jax_out, port_out = _both(scenario, tmp_path)
    assert port_out == jax_out


def test_port_stash_clones_and_is_taken_only_when_due(tmp_path):
    """The JAX stash holds references (immutable arrays); the port's
    clones, so a later in-place update leaves the stashed pre-state as
    it was."""
    g = TGuard(str(tmp_path), every=3)
    assert [s for s in range(1, 10) if g.due(s)] == [3, 6, 9]
    tree = _tree(T)
    g.stash_replay(3, tree, None)
    before = tdigest(g._stash[1]).hex()
    tree["params"]["w"].add_(1.0)
    assert tdigest(g._stash[1]).hex() == before
    assert g.stash_bytes == sum(x.numel() * x.element_size()
                                for sub in tree.values()
                                for x in sub.values())


# -- the three-replica drill through Model --------------------------------------
FLIP_STEP, STEPS, N_WORKERS = 4, 8, 3


def _jax_worker(run_dir, i):
    class Net(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(8, 4)

        def forward(self, x):
            return self.fc(x)

    pt.seed(7)
    net = Net()
    m = JModel(net)
    m.prepare(optimizer=pt.optimizer.SGD(learning_rate=0.1,
                                         parameters=net.parameters()),
              loss=jnn.CrossEntropyLoss())
    return m, net


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 4, device="cpu")

    def forward(self, x):
        return self.fc(x)


def _torch_worker(run_dir, i):
    _jm, jnet = _jax_worker(run_dir, i)
    net = _TNet()
    load_jax_state(net, {k: np.asarray(v)
                         for k, v in jnet.state_dict().items()})
    m = TModel(net)
    m.prepare(optimizer=topt.SGD(learning_rate=0.1,
                                 parameters=net.named_parameters()),
              loss=lambda out, y: TF.cross_entropy(out, y))
    return m, net


def _drill(P, d):
    sup_mod = jsup if P is J else tsup
    make = _jax_worker if P is J else _torch_worker
    run_dir = os.path.join(d, "run")
    workers = []
    for i in range(N_WORKERS):
        m, _net = make(run_dir, i)
        guard = P.Guard(run_dir, worker_id=i, every=2, expected=N_WORKERS,
                        action="resync", resync_timeout=5.0)
        sup = sup_mod.RunSupervisor(
            run_dir, worker_id=i, expected_workers=N_WORKERS,
            sigterm_handler=False, integrity=guard,
            report_path=os.path.join(run_dir, f"report-{i}.json"))
        m._supervisor = sup
        workers.append((m, sup))
    fault = P.faults.bitflip("params/fc.weight", bit=13, step=FLIP_STEP,
                             worker=2)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 8).astype("float32"),
                (np.arange(8) % 4).astype("int64")) for _ in range(STEPS)]
    losses = {i: [] for i in range(N_WORKERS)}
    for step0, (xs, ys) in enumerate(batches):
        step = step0 + 1
        for i, (m, sup) in enumerate(workers):
            loss, _ = m.train_batch(xs, ys)
            losses[i].append(loss)
            st = fault(step, m._supervised_state(), worker=i)
            m._load_supervised_state(st)
            sup.note_step_ok(m._supervised_state())
        for m, sup in workers:
            sup.recheck_integrity()
        suspects = set()
        for m, sup in workers:
            if sup.pending_integrity is not None:
                suspects.update(sup.pending_integrity["suspects"])
        for i, (m, sup) in enumerate(workers):
            if sup.pending_integrity is not None and i not in suspects:
                m._supervised_integrity_heal(sup)
        for i, (m, sup) in enumerate(workers):
            if sup.pending_integrity is not None:
                m._supervised_integrity_heal(sup)
    ref, _net = make(run_dir, 9)
    ref_losses = [ref.train_batch(xs, ys)[0] for xs, ys in batches]
    finals = [P.digest(m._supervised_state()).hex() for m, _ in workers]
    desync = workers[0][1].report.of_kind("integrity.desync")[0]
    heals = workers[2][1].report.of_kind("integrity.heal")
    resync = [h for h in heals if h.get("action") == "resync"]
    status = None
    if P is T:
        status = StatusServer(supervisor=workers[2][1]).statusz()
    return {
        "fired": fault.fired, "mismatches": workers[2][1].integrity.mismatches,
        "desync_step": desync["step"], "suspects": desync["suspects"],
        "audit": resync[0]["audit"]["verdict"] if resync else None,
        "offered": any(h.get("action") == "offer" for h in
                       workers[0][1].report.of_kind("integrity.heal")),
        "converged": len(set(finals)) == 1,
        "ref_digest_equal": P.digest(ref._supervised_state()).hex()
        == finals[0],
        "last_ok": all(w[1].integrity.last_verdict.ok for w in workers),
        "w0_equals_ref": losses[0][-1] == ref_losses[-1],
        "w2_prefix_equals_ref": losses[2][:FLIP_STEP]
        == ref_losses[:FLIP_STEP],
        "w2_last_equals_ref": losses[2][-1] == ref_losses[-1],
        "losses": losses[0], "status": status,
    }


def test_bitflip_drill_matches_jax(tmp_path):
    jax_out, port_out = _both(_drill, tmp_path)
    status = port_out.pop("status")
    jax_out.pop("status")
    np.testing.assert_allclose(port_out.pop("losses"),
                               jax_out.pop("losses"), rtol=LOSS_RTOL)
    assert port_out == jax_out
    assert port_out["fired"] == FLIP_STEP and port_out["audit"] == \
        "sdc_suspect" and port_out["suspects"] == [2]
    assert port_out["converged"] and port_out["w2_last_equals_ref"]
    integ = status["integrity"]
    assert integ["enabled"] and integ["interval"] == 2
    assert integ["mismatches"] >= 1 and integ["strikes"] == {2: 1}
    assert integ["last_verdict"]["ok"] is True
    assert integ["stash_bytes"] > 0


def test_jax_supervised_checkpoint_restores_into_port_model(tmp_path):
    """A JAX ``RunSupervisor`` commits steps 4 and 8 of a supervised fit
    (Linear(4, 2) under Adam); the newest loads into a port ``Model``
    (parameters, Adam slots and step; no random streams in a JAX state),
    matching the JAX model exactly, and one more step of both agrees."""
    pt.seed(0)
    jnet = jnn.Linear(4, 2)
    weights = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    jm = JModel(jnet)
    jm.prepare(optimizer=pt.optimizer.Adam(learning_rate=1e-2),
               loss=lambda out, y: jnp.mean((out - y) ** 2))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 2).astype(np.float32)
    sup = jsup.RunSupervisor(str(tmp_path / "run"), save_interval_steps=4,
                             heartbeat_secs=60.0, sigterm_handler=False)
    jm.fit(JTensorDataset([x, y]), batch_size=1, epochs=1, shuffle=False,
           verbose=0, supervisor=sup)
    sup.elastic.wait()
    path = jel.latest_checkpoint(sup.elastic.directory)
    assert os.path.basename(path) == "step-8"
    tnet = tnn.Linear(4, 2, device="cpu")
    load_jax_state(tnet, weights)
    tm = TModel(tnet)
    tm.prepare(optimizer=topt.Adam(learning_rate=1e-2,
                                   parameters=tnet.named_parameters()),
               loss=lambda out, yy: ((out - yy) ** 2).mean())
    tm._load_supervised_state(tck.load_sharded(path))
    for name, value in jnet.state_dict().items():
        np.testing.assert_array_equal(
            tnet.state_dict()[name].numpy(), np.asarray(value))
    opt_state = tm._optimizer.state_dict()["state"]
    assert int(opt_state["step"]) == 8
    for name, slots in jm._opt_state["slots"].items():
        for k, v in slots.items():
            np.testing.assert_array_equal(
                opt_state["slots"][name][k].numpy(), np.asarray(v))
    lj, _ = jm.train_batch([x[:1]], y[:1])
    lt, _ = tm.train_batch([x[:1]], y[:1])
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    # a JAX state has no random streams; the port's carries them
    manifest = json.loads(open(os.path.join(path, "manifest-p0.json")).read())
    assert not any(n.startswith("rng/") for n in manifest["leaves"])
    assert "cpu" in tm._supervised_state()["rng"]
