"""Port parity of the run supervisor (``paddle_tpu_torch/supervisor/``) on
the CPU, against the JAX package: every scenario of
``tests/test_supervisor.py`` that the port carries runs once through each
package, and the two runs must agree.

- the report's round trip, the guard's ladder, heartbeat staleness and
  the rollback budget: identical verdicts, event kinds and steps;
- the supervised ``fit`` drills of ``TestSupervisedFitEndToEnd`` (a
  diverging loss climbing skip -> lower LR -> rollback, a hung step the
  watchdog skips, repeated hangs that roll back, an exhausted rollback
  budget, the sticky LR back-off) on the same ``Linear(4, 2)`` weights
  and data: the same report event kinds in the same order, the same
  committed and rollback steps, the same batch count, and losses within
  ``LOSS_RTOL`` (float32 on both sides; the summation order of the two
  libraries' matmuls differs, ~1e-7 relative).

Tolerances: ``LOSS_RTOL`` = 1e-5 relative on every loss, 1e-6 absolute
near zero; everything else exact.
"""
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import supervisor as jsup
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import supervisor as tsup
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.hapi import Model as TModel
from paddle_tpu_torch.io import TensorDataset as TTensorDataset
from paddle_tpu_torch.testing import faults as tfaults

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6

J = types.SimpleNamespace(name="jax", sup=jsup, el=jel, faults=jfaults,
                          state=lambda a: jnp.asarray(a))
T = types.SimpleNamespace(name="torch", sup=tsup, el=tel, faults=tfaults,
                          state=lambda a: torch.from_numpy(np.asarray(a)))
PKGS = (J, T)


def _both(fn, tmp_path):
    """``fn(P, tmp)`` once per package in its own directory."""
    out = []
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir()
        out.append(fn(P, str(d)))
    return out


# -- unit scenarios ---------------------------------------------------------
def _report_roundtrip(P, d):
    path = os.path.join(d, "report.json")
    report = P.sup.SupervisorReport(path)
    report.record("watchdog_timeout", label="train_batch")
    report.record("rollback", reason="divergence", start_step=7)
    on_disk = json.loads(open(path).read())["events"][-1]["kind"]
    loaded = P.sup.SupervisorReport.load(path)
    return (loaded.counts(), loaded.of_kind("rollback")[0]["start_step"],
            on_disk, loaded.summary().split(":")[1])


def _guard_ladder(P, d):
    guard = P.sup.DivergenceGuard(skip_budget=2, max_lr_backoffs=1,
                                  min_history=2,
                                  report=P.sup.SupervisorReport())
    ok = [guard.observe(i, 1.0) for i in range(4)]
    inject = P.faults.diverge_after(4, mode="spike")
    seq = [guard.observe(s, inject(s, 1.0)) for s in range(4, 8)]
    one_off = P.sup.DivergenceGuard(min_history=2)
    for i in range(4):
        one_off.observe(i, 1.0, grad_norm=1.0)
    spikes = [one_off.observe(4, 1e6), one_off.observe(5, 1.0),
              one_off.observe(6, 1.0, grad_norm=1e5)]
    amp = P.sup.DivergenceGuard(amp_grace=3)
    amp_seq = [amp.observe(i, float("inf"), amp_active=True)
               for i in range(4)]
    guard.reset_after_rollback()
    kept = guard.lr_scale
    guard.restore_lr()
    return (ok, seq, kept, guard.lr_scale,
            [e["kind"] for e in guard.report.events], spikes,
            one_off.total_bad, amp_seq, amp.consecutive_bad,
            amp.amp_overflows)


def _heartbeat(P, d):
    clock = {"t": 1000.0}
    w0 = P.sup.HeartbeatWriter(d, worker_id=0, interval=1,
                               clock=lambda: clock["t"])
    w1 = P.sup.HeartbeatWriter(d, worker_id=1, interval=1,
                               clock=lambda: clock["t"])
    report = P.sup.SupervisorReport()
    monitor = P.sup.HeartbeatMonitor(d, stale_after=3, lost_after=9,
                                     expected=3, clock=lambda: clock["t"],
                                     report=report)
    w0.beat(step=5)
    w1.beat()
    polls = [monitor.poll()]
    clock["t"] += 5
    w0.beat()
    polls.append(monitor.poll())
    clock["t"] += 6
    w0.beat()
    polls.append(monitor.poll())
    payload = json.loads(open(w0.path).read())
    throttle = P.sup.HeartbeatWriter(d, worker_id=2, interval=10,
                                     clock=lambda: clock["t"])
    beats = [throttle.maybe_beat(1), throttle.maybe_beat(2)]
    clock["t"] += 6
    beats.append(throttle.maybe_beat(3))
    return (polls, [e["state"] for e in report.of_kind("run_state")],
            payload["step"], payload["beats"], beats)


def _rollback_budget(P, d):
    report = P.sup.SupervisorReport(os.path.join(d, "report.json"))
    mgr = P.el.ElasticTrainState(os.path.join(d, "ckpt"), keep=5,
                                 install_sigterm_handler=False,
                                 event_sink=report.record)
    seeds = []
    rb = P.sup.RollbackManager(mgr, budget=1, report=report,
                               reseed=seeds.append)
    state = {"w": P.state(np.arange(4, dtype=np.float32))}
    steps = [mgr.last_good_step()]
    mgr.save(5, state, use_async=False)
    steps.append(mgr.last_good_step())
    restored, start = rb.rollback(lambda: state, lambda: state)
    with pytest.raises(P.sup.RollbackBudgetExceeded) as ei:
        rb.rollback(lambda: state, lambda: state)
    return (steps, start, np.asarray(restored["w"]).tolist(), seeds,
            "report.json" in str(ei.value), report.counts())


def _watchdog(P, d):
    report = P.sup.SupervisorReport()
    with P.sup.Watchdog(timeout=0.25, report=report) as wd:
        t0 = time.monotonic()
        with pytest.raises(P.sup.StepTimeout):
            with wd.armed("train_batch"):
                P.faults.hang(30.0)
        fast = time.monotonic() - t0 < 5.0
        with wd.armed("step", timeout=5.0):
            P.faults.slow_call(lambda: "ok", 0.05)()
        timeouts = wd.timeouts
    (event,) = report.of_kind("watchdog_timeout")
    return (fast, timeouts, event["label"], "MainThread" in event["stacks"])


@pytest.mark.parametrize("scenario", [_report_roundtrip, _guard_ladder,
                                      _heartbeat, _rollback_budget,
                                      _watchdog],
                         ids=lambda f: f.__name__.strip("_"))
def test_unit_scenarios_match_jax(scenario, tmp_path):
    jax_out, port_out = _both(scenario, tmp_path)
    assert port_out == jax_out


def test_env_knobs_seed_defaults(monkeypatch):
    monkeypatch.setenv("PTPU_ROLLBACK_BUDGET", "7")
    monkeypatch.setenv("PTPU_WATCHDOG_SECS", "12")
    monkeypatch.setenv("PTPU_HEARTBEAT_SECS", "3")
    for P in PKGS:
        assert P.sup.RollbackManager(None).budget == 7
        assert P.sup.Watchdog().timeout == 12.0
        assert P.sup.HeartbeatWriter("unused", worker_id=0).interval == 3.0


def test_port_refuses_an_elastic_coordinator(tmp_path):
    from paddle_tpu_torch.framework.errors import UnimplementedError
    with pytest.raises(UnimplementedError):
        tsup.RunSupervisor(str(tmp_path), coordinator=object(),
                           sigterm_handler=False)
    sup = tsup.RunSupervisor(str(tmp_path), sigterm_handler=False)
    with pytest.raises(UnimplementedError):
        sup.request_resize(2)


# -- the supervised fit drills ---------------------------------------------
def _jax_weights():
    pt.seed(0)
    net = jnn.Linear(4, 2)
    return net, {k: np.asarray(v) for k, v in net.state_dict().items()}


def _mse_jax(out, y):
    return jnp.mean((out - y) ** 2)


def _mse_torch(out, y):
    return ((out - y) ** 2).mean()


def _tiny_supervised(P, d, calibrate_watchdog=None, **sup_kw):
    """The JAX test's ``_tiny_supervised`` for either package: the same
    Linear(4, 2) weights, SGD(1e-2), MSE, 24 samples; ``calibrate_
    watchdog=K`` arms the watchdog at K times one measured step (within
    [1, 10] s), so a load-slowed step never crosses it."""
    jnet, weights = _jax_weights()
    if P is J:
        model = JModel(jnet)
        model.prepare(optimizer=pt.optimizer.SGD(learning_rate=1e-2),
                      loss=_mse_jax)
        ds_cls = JTensorDataset
    else:
        net = tnn.Linear(4, 2, device="cpu")
        load_jax_state(net, weights)
        model = TModel(net)
        model.prepare(optimizer=topt.SGD(
            learning_rate=1e-2, parameters=net.named_parameters()),
            loss=_mse_torch)
        ds_cls = TTensorDataset
    rng = np.random.RandomState(0)
    ds = ds_cls([rng.randn(24, 4).astype(np.float32),
                 rng.randn(24, 2).astype(np.float32)])
    if calibrate_watchdog is not None:
        x, y = rng.randn(1, 4).astype(np.float32), \
            rng.randn(1, 2).astype(np.float32)
        model.train_batch([x], y)            # compile outside the timing
        t0 = time.monotonic()
        model.train_batch([x], y)
        stepped = time.monotonic() - t0
        sup_kw["watchdog_secs"] = min(
            10.0, max(1.0, calibrate_watchdog * stepped))
    sup_kw.setdefault("save_interval_steps", 4)
    sup_kw.setdefault("watchdog_secs", 30.0)
    sup_kw.setdefault("heartbeat_secs", 60.0)
    sup_kw.setdefault("sigterm_handler", False)
    sup_kw.setdefault("guard", P.sup.DivergenceGuard(
        skip_budget=2, max_lr_backoffs=1, min_history=2))
    sup = P.sup.RunSupervisor(os.path.join(d, "run"), **sup_kw)
    return model, ds, sup


def _fit(model, ds, sup):
    np.random.seed(1234)    # the loader's shuffle draws from numpy's stream
    return model.fit(ds, batch_size=1, epochs=1, verbose=0, supervisor=sup)


def _summary(P, sup, history, raised=None):
    # neither package waits for the last async save at the run's end
    sup.elastic.wait()
    report = P.sup.SupervisorReport.load(
        os.path.join(sup.run_dir, "supervisor_report.json"))
    kinds = [e["kind"] for e in report.events]
    return {"kinds": kinds,
            "rollbacks": [(e["reason"], e["restored_step"], e["start_step"])
                          for e in report.of_kind("rollback")],
            "committed": [os.path.basename(p) for p in
                          P.el.committed_checkpoints(sup.elastic.directory)],
            "gstep": sup.gstep, "used": sup.rollback.used,
            "lr_scale": sup.guard.lr_scale,
            "timeouts": sup.watchdog.timeouts,
            "end": report.of_kind("run_end")[0]["status"],
            "raised": raised,
            "losses": None if history is None else history["loss"]}


def _divergence(P, d):
    model, ds, sup = _tiny_supervised(P, d, rollback_budget=2)
    sup.inject_loss(P.faults.diverge_after(8, mode="spike", count=4))
    out = _summary(P, sup, _fit(model, ds, sup))
    out["detached"] = model._supervisor is None
    return out


def _hang_once(P, d):
    model, ds, sup = _tiny_supervised(P, d, calibrate_watchdog=50)
    hung = []

    def hang_once(step, loss):
        if step == 5 and not hung:
            hung.append(step)
            P.faults.hang(30.0)
        return loss

    sup.inject_loss(hang_once)
    return _summary(P, sup, _fit(model, ds, sup))


def _hang_twice(P, d):
    model, ds, sup = _tiny_supervised(P, d, calibrate_watchdog=50,
                                      rollback_budget=2,
                                      step_failure_budget=1)
    hangs = {"n": 0}

    def hang_twice(step, loss):
        if step >= 6 and hangs["n"] < 2:
            hangs["n"] += 1
            P.faults.hang(30.0)
        return loss

    sup.inject_loss(hang_twice)
    return _summary(P, sup, _fit(model, ds, sup))


def _budget_exhausted(P, d):
    model, ds, sup = _tiny_supervised(P, d, rollback_budget=1)
    sup.inject_loss(P.faults.diverge_after(6, mode="spike"))   # forever
    with pytest.raises(P.sup.RollbackBudgetExceeded) as ei:
        _fit(model, ds, sup)
    return _summary(P, sup, None,
                    raised="supervisor_report.json" in str(ei.value))


def _lr_backoff(P, d):
    model, ds, sup = _tiny_supervised(P, d, rollback_budget=2)
    sup.inject_loss(P.faults.diverge_after(8, mode="spike", count=3))
    return _summary(P, sup, _fit(model, ds, sup))


FIT_DRILLS = {
    # name: (drill, what the JAX test asserts of it)
    "divergence_skip_rollback_resume": (_divergence, dict(
        used=1, rollbacks=[("divergence", 8, 9)], end="completed")),
    "watchdog_hang_skipped_run_completes": (_hang_once, dict(
        used=0, timeouts=1, rollbacks=[], end="completed", n_losses=23)),
    "repeated_hang_rolls_back": (_hang_twice, dict(
        used=1, timeouts=2, end="completed")),
    "budget_exhaustion_fails_loudly": (_budget_exhausted, dict(
        used=2, end="failed", raised=True)),
    "lr_backoff_applied_to_updates": (_lr_backoff, dict(
        used=0, lr_scale=0.5, rollbacks=[], end="completed")),
}


@pytest.mark.parametrize("name", sorted(FIT_DRILLS))
def test_supervised_fit_drill_matches_jax(name, tmp_path):
    drill, expect = FIT_DRILLS[name]
    jax_out, port_out = _both(drill, tmp_path)
    for key, want in expect.items():
        if key == "n_losses":
            assert len(port_out["losses"]) == len(jax_out["losses"]) == want
        else:
            assert port_out[key] == jax_out[key] == want, key
    assert port_out["kinds"] == jax_out["kinds"]
    for key in ("rollbacks", "committed", "gstep", "used", "lr_scale",
                "timeouts", "raised"):
        assert port_out[key] == jax_out[key], key
    if jax_out["losses"] is not None:
        np.testing.assert_allclose(port_out["losses"], jax_out["losses"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
    if name == "repeated_hang_rolls_back":
        reasons = [r for r, _, _ in port_out["rollbacks"]]
        assert reasons == ["step-timeout"]


def test_supervised_run_streams_metrics_and_status(tmp_path, monkeypatch):
    """The port's ``begin_run`` wiring: the run's JSONL stream carries the
    step records and mirrored supervisor events, and ``PTPU_MONITOR_PORT``
    starts a status server whose ``/statusz`` has the supervisor
    sections (the server stops with the run)."""
    monkeypatch.setenv("PTPU_MONITOR_PORT", "0")
    model, ds, sup = _tiny_supervised(T, str(tmp_path))
    seen = {}

    from paddle_tpu_torch.hapi import Callback

    class Peek(Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 3:
                seen["status"] = sup.status_server.statusz()
                seen["health"] = sup.status_server.healthz()

    np.random.seed(0)
    model.fit(ds, batch_size=4, epochs=1, verbose=0, supervisor=sup,
              callbacks=[Peek()])
    assert sup.status_server is None
    status = seen["status"]
    assert seen["health"][0] == 200
    assert status["supervisor"]["running"] is True
    assert status["watchdog"]["armed"] == []
    assert status["heartbeat"]["beats"] >= 1
    assert status["step"] == 4 and status["loss"] is not None  # gstep
    lines = open(os.path.join(sup.run_dir, "metrics",
                              "worker-0.jsonl")).read().splitlines()
    kinds = [json.loads(x)["kind"] for x in lines]
    assert kinds.count("step") == 6
    assert "supervisor.run_start" in kinds and "supervisor.run_end" in kinds


def test_skipped_step_leaves_the_state_as_it_was(tmp_path):
    """The port's guard decides before ``optimizer.step()``: after a
    skipped batch the parameters, Adam slots and step count are the old
    ones bit for bit (the JAX step computes the update and drops it)."""
    net = tnn.Linear(4, 2, device="cpu")
    model = TModel(net)
    model.prepare(optimizer=topt.Adam(learning_rate=1e-2,
                                      parameters=net.named_parameters()),
                  loss=_mse_torch)
    sup = tsup.RunSupervisor(str(tmp_path), sigterm_handler=False,
                             guard=tsup.DivergenceGuard(min_history=2))
    sup.inject_loss(tfaults.diverge_after(3, mode="nan", count=1))
    sup.attach(model)
    rng = np.random.RandomState(0)
    x, y = rng.randn(4, 4).astype(np.float32), rng.randn(4, 2).astype(
        np.float32)
    for _ in range(3):
        model.train_batch([x], y)
        sup.note_step_ok(model._supervised_state())
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = model._optimizer.state_dict()["state"]
    slots = {n: {k: v.clone() for k, v in s.items()}
             for n, s in opt["slots"].items()}
    step = int(opt["step"])
    model.train_batch([x], y)
    assert sup.last_action == tsup.GuardAction.SKIP
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])
    opt = model._optimizer.state_dict()["state"]
    assert int(opt["step"]) == step
    for n, s in opt["slots"].items():
        for k, v in s.items():
            assert torch.equal(v, slots[n][k])
    assert all(p.grad is None for p in net.parameters())


def test_worker_ids_come_from_torch_distributed(tmp_path, monkeypatch):
    """Heartbeats, the flight recorder and DistributedBatchSampler take
    the rank and world size from torch.distributed when a group exists
    (the JAX package reads jax.process_index() / its mesh), and 0 / 1
    without one."""
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.observability.flight import FlightRecorder
    ds = TTensorDataset([np.arange(12, dtype=np.float32)])
    assert tsup.HeartbeatWriter(str(tmp_path)).worker_id == 0
    assert DistributedBatchSampler(ds, batch_size=2).nranks == 1
    import torch.distributed as tdist
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_rank", lambda group=None: 3)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 4)
    assert tsup.HeartbeatWriter(str(tmp_path)).worker_id == 3
    assert FlightRecorder(str(tmp_path)).worker_id == 3
    sampler = DistributedBatchSampler(ds, batch_size=2)
    assert (sampler.local_rank, sampler.nranks) == (3, 4)
    assert list(sampler) == [[3, 7], [11]]
