"""Port parity of the optimizers, clips, regularizers and lr schedules, on
the CPU: the same numpy parameters and gradients through the JAX package's
functional ``apply_gradients`` and the port's stateful ``step()``.

- every update rule, 4 steps, with weight decay where the rule takes it;
- each gradient clip, float / L1 / L2 decay, ``apply_decay_param_fun``;
- ``multi_precision``: bf16 parameters with float32 masters;
- a step given ``found_inf`` leaves the whole state bit for bit;
- ``state_dict`` round trips, in the port and through a JAX state;
- every scheduler's values over 50 steps against the JAX ``_compute``;
- a scheduler as the optimizer's lr.

Tolerances: float32 elementwise arithmetic in the same order on both sides
lands within a few ulps (1e-6 of each tensor's range); rules with norms
(Lamb, Lars, the norm clips) sum in another order (1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.convert import (optimizer_state_from_jax,
                                      optimizer_state_to_jax)
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"fc.weight": (16, 8), "fc.bias": (8,), "ln.weight": (8,),
          "emb.weight": (5, 4, 3)}
STEPS = 4


def _close(got, ref, what, tol=1e-6):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * float(np.abs(ref).max()) + 1e-8
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _data(seed=0, dtype=np.float32):
    r = np.random.RandomState(seed)
    params = {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _run(make_j, make_t, seed=0, bf16=False, tol=1e-6):
    """STEPS updates on both sides; returns the port optimizer and params
    after comparing every parameter, slot and master."""
    params, grads = _data(seed)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jo = make_j()
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(tdt))
          for k, v in params.items()}
    to = make_t(list(tp.items()))
    japply = jax.jit(jo.apply_gradients)
    for gs in grads:
        jp, js = japply({k: jnp.asarray(v).astype(jdt)
                         for k, v in gs.items()}, jp, js)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k]).to(tdt)
        to.step()
    st = to.state_dict()["state"]
    assert int(st["step"]) == int(js["step"]) == STEPS
    for k in SHAPES:
        if bf16:
            # both round the same float32 master to bf16
            _close(tp[k].detach().float(), jnp.asarray(jp[k], jnp.float32),
                   f"param {k}", tol=2.0 ** -8)
            _close(st["master"][k], js["master"][k], f"master {k}", tol=tol)
        else:
            _close(tp[k].detach(), jp[k], f"param {k}", tol=tol)
            assert st["master"][k] is None and js["master"][k] is None
        jslots = js["slots"][k] or {}
        assert set(st["slots"][k]) == set(jslots), k
        for s in jslots:
            _close(st["slots"][k][s], jslots[s], f"{s} {k}", tol=tol)
    return to, tp


RULES = {
    "SGD": lambda m, ps: m.SGD(learning_rate=0.1, parameters=ps,
                               weight_decay=0.01),
    "Momentum": lambda m, ps: m.Momentum(learning_rate=0.1, momentum=0.8,
                                         parameters=ps, weight_decay=0.01),
    "Momentum-nesterov": lambda m, ps: m.Momentum(
        learning_rate=0.1, momentum=0.8, parameters=ps, use_nesterov=True),
    "Adagrad": lambda m, ps: m.Adagrad(learning_rate=0.1, parameters=ps,
                                       weight_decay=0.01),
    "RMSProp": lambda m, ps: m.RMSProp(learning_rate=0.01, momentum=0.5,
                                       parameters=ps, weight_decay=0.01),
    "Adam": lambda m, ps: m.Adam(learning_rate=0.01, parameters=ps,
                                 weight_decay=0.01),
    "AdamW": lambda m, ps: m.AdamW(learning_rate=0.01, beta2=0.95,
                                   parameters=ps, weight_decay=0.1),
    "AdamMax": lambda m, ps: m.AdamMax(learning_rate=0.01, parameters=ps,
                                       weight_decay=0.01),
    "Lamb": lambda m, ps: m.Lamb(learning_rate=0.01, parameters=ps,
                                 lamb_weight_decay=0.01,
                                 exclude_from_weight_decay_fn=lambda n:
                                 n.endswith("bias")),
    "Lars": lambda m, ps: m.Lars(learning_rate=0.1, parameters=ps,
                                 exclude_from_weight_decay_fn=lambda n:
                                 n.startswith("ln")),
    "Adadelta": lambda m, ps: m.Adadelta(learning_rate=1.0, parameters=ps,
                                         weight_decay=0.01),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_update_rule_matches_jax(rule):
    make = RULES[rule]
    norms = rule in ("Lamb", "Lars")
    _run(lambda: make(jopt, None), lambda ps: make(topt, ps),
         tol=1e-5 if norms else 1e-6)


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.5),
    "value-min": lambda m: m.ClipGradByValue(0.7, min=-0.2),
    "norm": lambda m: m.ClipGradByNorm(1.5),
    "global-norm": lambda m: m.ClipGradByGlobalNorm(1.0),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_grad_clip_matches_jax(clip):
    def make(m, ps):
        return m.AdamW(learning_rate=0.01, parameters=ps, weight_decay=0.1,
                       grad_clip=CLIPS[clip](m))
    _run(lambda: make(jopt, None), lambda ps: make(topt, ps),
         tol=1e-6 if clip.startswith("value") else 1e-5)


def test_global_norm_matches_jax_and_is_kept():
    _, grads = _data(3)
    g = grads[0]
    ref = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    clip = topt.ClipGradByGlobalNorm(1.0)
    out = clip([torch.from_numpy(v) for v in g.values()])
    assert abs(float(clip.last_norm) - ref) <= 1e-6 * ref
    total = float(torch.sqrt(sum(torch.sum(o * o) for o in out)))
    assert abs(total - 1.0) <= 1e-5


# the decay forms: a float (L2), L1Decay and L2Decay objects, each with
# and without apply_decay_param_fun (only 2-D weights decay)
DECAYS = {
    "float": lambda m, r: 0.05,
    "L1": lambda m, r: r.L1Decay(0.05),
    "L2": lambda m, r: r.L2Decay(0.05),
}


def _two_d(name):
    return name.endswith(".weight") and len(SHAPES[name]) == 2


@pytest.mark.parametrize("selective", [False, True],
                         ids=["all", "apply_decay_param_fun"])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("rule", ["Adam", "AdamW"])
def test_weight_decay_matches_jax(rule, decay, selective):
    fn = _two_d if selective else None

    def make(m, r, ps):
        return getattr(m, rule)(learning_rate=0.01, parameters=ps,
                                weight_decay=DECAYS[decay](m, r),
                                apply_decay_param_fun=fn)
    _run(lambda: make(jopt, jreg, None), lambda ps: make(topt, treg, ps))


@pytest.mark.parametrize("decay", ["L1", "L2"])
def test_regularizer_objects_on_sgd_match_jax(decay):
    def make(m, r, ps):
        return m.SGD(learning_rate=0.1, parameters=ps,
                     weight_decay=DECAYS[decay](m, r))
    _run(lambda: make(jopt, jreg, None), lambda ps: make(topt, treg, ps))


@pytest.mark.parametrize("rule", ["AdamW", "Momentum", "Lamb"])
def test_multi_precision_bf16_matches_jax(rule):
    make = RULES[rule]
    to, tp = _run(lambda: make(jopt, None), lambda ps: make(topt, ps),
                  bf16=True, tol=1e-5)
    st = to.state_dict()["state"]
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        assert st["master"][k].dtype == torch.float32
        # the parameter is its master rounded to bf16
        assert torch.equal(p.detach(), st["master"][k].to(torch.bfloat16))


def test_without_multi_precision_bf16_has_no_master():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    o = topt.SGD(learning_rate=0.1, parameters=[("w", p)],
                 multi_precision=False)
    p.grad = torch.ones(4, dtype=torch.bfloat16)
    o.step()
    assert o.state_dict()["state"]["master"]["w"] is None
    assert torch.equal(p.detach(), torch.full((4,), 0.8984375,
                                              dtype=torch.bfloat16))


def test_found_inf_step_keeps_the_state_bit_for_bit():
    params, grads = _data(4)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        torch.bfloat16)) for k, v in params.items()}
    to = topt.AdamW(learning_rate=0.01, parameters=list(tp.items()),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[0][k]).to(torch.bfloat16)
    to.step(found_inf=torch.tensor(False))
    before = {k: p.detach().clone() for k, p in tp.items()}
    sd = to.state_dict()["state"]
    snap = {"step": sd["step"].clone(),
            "slots": {k: {s: v.clone() for s, v in sl.items()}
                      for k, sl in sd["slots"].items()},
            "master": {k: m.clone() for k, m in sd["master"].items()}}
    for k, p in tp.items():
        g = torch.from_numpy(grads[1][k]).to(torch.bfloat16)
        g.view(-1)[0] = float("inf")
        p.grad = g
    to.step(found_inf=torch.tensor(True))
    after = to.state_dict()["state"]
    assert torch.equal(after["step"], snap["step"]) and int(
        after["step"]) == 1
    for k, p in tp.items():
        assert torch.equal(p.detach(), before[k])
        assert torch.equal(after["master"][k], snap["master"][k])
        for s in snap["slots"][k]:
            assert torch.equal(after["slots"][k][s], snap["slots"][k][s])
    # a clean step afterwards moves on
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[2][k]).to(torch.bfloat16)
    to.step(found_inf=torch.tensor(False))
    assert int(to.state_dict()["state"]["step"]) == 2


def _clone_state(sd):
    st = sd["state"]
    return {"state": {
        "step": st["step"].clone(),
        "slots": {k: {s: v.clone() for s, v in sl.items()}
                  for k, sl in st["slots"].items()},
        "master": {k: None if m is None else m.clone()
                   for k, m in st["master"].items()}},
        **({"lr": dict(sd["lr"])} if "lr" in sd else {})}


@pytest.mark.parametrize("rule", ["AdamW", "SGD", "RMSProp"])
def test_state_dict_round_trip_continues_the_trajectory(rule):
    make = RULES[rule]
    params, grads = _data(5)

    def fresh():
        return {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}

    def feed(tp, gs):
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k].copy())

    a = fresh()
    oa = make(topt, list(a.items()))
    for gs in grads:
        feed(a, gs)
        oa.step()
    b = fresh()
    ob = make(topt, list(b.items()))
    for gs in grads[:2]:
        feed(b, gs)
        ob.step()
    saved = _clone_state(ob.state_dict())
    weights = {k: p.detach().clone() for k, p in b.items()}
    c = {k: torch.nn.Parameter(w) for k, w in weights.items()}
    oc = make(topt, list(c.items()))
    oc.set_state_dict(saved)
    for gs in grads[2:]:
        feed(c, gs)
        oc.step()
    for k in SHAPES:
        assert torch.equal(c[k].detach(), a[k].detach()), k


def test_jax_state_resumes_in_the_port_and_back():
    # two JAX steps, then the state moves into the port (as a JAX
    # checkpoint would bring it), two port steps, and back into JAX for a
    # fifth: every parameter against five JAX steps straight
    params, grads = _data(6)
    grads = grads + _data(7)[1][:1]
    jo = jopt.AdamW(learning_rate=0.01, weight_decay=0.1)
    japply = jax.jit(jo.apply_gradients)

    def jgrads(gs):
        return {k: jnp.asarray(v) for k, v in gs.items()}

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    straight = (jp, js)
    for gs in grads:
        straight = japply(jgrads(gs), *straight)
    for gs in grads[:2]:
        jp, js = japply(jgrads(gs), jp, js)
    tp = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v).copy()))
          for k, v in jp.items()}
    to = topt.AdamW(learning_rate=0.01, weight_decay=0.1,
                    parameters=list(tp.items()))
    optimizer_state_from_jax(jax.tree_util.tree_map(np.asarray, js), to)
    for gs in grads[2:4]:
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k].copy())
        to.step()
    back = optimizer_state_to_jax(to)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 4
    jp = {k: jnp.asarray(p.detach().numpy()) for k, p in tp.items()}
    js = jax.tree_util.tree_map(jnp.asarray, back)
    jp, js = japply(jgrads(grads[4]), jp, js)
    for k in SHAPES:
        _close(jp[k], straight[0][k], f"param {k}")
        for s in ("moment1", "moment2"):
            _close(js["slots"][k][s], straight[1]["slots"][k][s],
                   f"{s} {k}")


# ---------------------------------------------------------------------------
# lr schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=10,
                                       learning_rate=2.0),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [3, 11, 30],
                                                 gamma=0.2),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.93),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=37,
                                                   end_lr=0.01, power=2.0),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        2e-4, T_max=40, eta_min=2e-5),
    "LinearWarmup": lambda m: m.LinearWarmup(0.3, warmup_steps=9,
                                             start_lr=0.0, end_lr=0.3),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(2e-4, T_max=30, eta_min=2e-5),
        warmup_steps=8, start_lr=1e-6, end_lr=2e-4),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20], [0.1, 0.05,
                                                           0.01]),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, patience=2,
                                                   factor=0.5),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.07),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.3),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.97),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_match_jax(name):
    js, ts = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    metrics = np.abs(np.sin(np.arange(50.0))) + 1.0 / (1 + np.arange(50.0))
    for step in range(50):
        # the functional values: float32 on both sides; transcendental
        # functions (cos, exp, pow) of XLA and numpy may differ in the
        # last ulp, 4 ulps (2^-21 relative) is the bound
        ref = np.float32(js._compute(step))
        got = ts(step)
        assert got.dtype == np.float32, name
        assert abs(float(got) - float(ref)) <= 2.0 ** -21 * abs(float(ref)), (
            f"{name} at {step}: {got!r} vs {ref!r}")
        # the stateful values after the same step() calls
        assert js.last_epoch == ts.last_epoch
        assert abs(ts.get_lr() - js.get_lr()) <= 2.0 ** -21 * abs(
            js.get_lr())
        if name == "ReduceOnPlateau":
            js.step(metrics[step])
            ts.step(metrics[step])
        else:
            js.step()
            ts.step()
    restored = SCHEDULES[name](tlr)
    restored.set_state_dict(ts.state_dict())
    assert restored.last_epoch == ts.last_epoch == 50
    if name != "ReduceOnPlateau":
        assert restored.get_lr() == ts.get_lr()


def test_scheduler_drives_the_optimizer_lr():
    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(2e-4, 6, eta_min=2e-5),
                              2, start_lr=0.0, end_lr=2e-4)
    params, grads = _data(8)
    js_, ts_ = sched(jlr), sched(tlr)
    jo = jopt.AdamW(learning_rate=js_, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    to = topt.AdamW(learning_rate=ts_, weight_decay=0.1,
                    parameters=list(tp.items()))
    used = []
    for gs in grads:
        # the JAX stateful path: the lr of a step is the scheduler's
        # get_lr(); the user steps the scheduler after
        jp, jst = jo.apply_gradients({k: jnp.asarray(v)
                                      for k, v in gs.items()}, jp, jst,
                                     lr=js_.get_lr())
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k].copy())
        to.step()
        used.append(to.last_lr)
        js_.step()
        ts_.step()
    assert used == [float(sched(tlr)(i)) for i in range(STEPS)]
    # warmup from 0, then the cosine's first value, its peak
    assert used[0] == 0.0 and abs(used[2] - 2e-4) <= 1e-10
    for k in SHAPES:
        _close(tp[k].detach(), jp[k], f"param {k}")
    with pytest.raises(Exception, match="LRScheduler"):
        to.set_lr(0.1)
    assert to.state_dict()["lr"] == {"last_epoch": STEPS}


def test_set_lr_and_unnamed_parameters():
    p = torch.nn.Parameter(torch.zeros(3))
    o = topt.SGD(learning_rate=0.5, parameters=[p])
    o.set_lr(0.25)
    assert o.get_lr() == 0.25
    assert list(o.state_dict()["state"]["slots"]) == ["param_0"]
    p.grad = torch.ones(3)
    o.step()
    # the torch convention: the step leaves .grad (the JAX step clears it)
    assert torch.equal(p.grad, torch.ones(3))
    assert torch.equal(p.detach(), torch.full((3,), -0.25))
