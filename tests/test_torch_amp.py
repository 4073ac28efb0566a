"""Port parity of ``amp.decorate`` and ``GradScaler``, on the CPU, against
the JAX package:

- the loss-scaling state machine, functional form: scale, good and bad
  counts after every step of flag sequences that overflow, back off to the
  floor of 1 and grow, exactly;
- ``unscale_and_check``: the unscaled gradients bit for bit, and the flag;
- the stateful form (``scale``, ``step``, ``unscale_`` then ``step``) over
  bound parameters with an Adam optimizer, gradients with injected infs:
  the scaler's state exactly and the parameters within float32 ulps, so a
  skipped step moves neither the parameters nor Adam's step count;
- ``decorate``: what O2 casts, the optimizer's master weights;
- a 3-step O2 ``gpt_tiny`` loss trajectory (bf16 parameters, float32
  masters, a GradScaler) against the JAX O2 step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.layer import Parameter as JParameter
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.training import train_step

SCALERS = {
    "default": dict(),
    "fast": dict(init_loss_scaling=8.0, incr_every_n_steps=2,
                 decr_every_n_nan_or_inf=1),
    "slow-quarter": dict(init_loss_scaling=4.0, incr_every_n_steps=3,
                         decr_every_n_nan_or_inf=2, decr_ratio=0.25,
                         incr_ratio=3.0),
    "static": dict(init_loss_scaling=16.0, use_dynamic_loss_scaling=False),
    "disabled": dict(enable=False),
}
# overflow runs long enough to reach the floor of 1, then growth
FLAGS = [False, False, True, True, True, False, False, False, True, False,
         True, True, True, True, True, True, True, False, False, False,
         False, False, False, False, True, False, False]


def _state(st):
    return (float(st["scale"]), int(st["good"]), int(st["bad"]))


@pytest.mark.parametrize("cfg", sorted(SCALERS))
def test_functional_state_sequence_matches_jax(cfg):
    js, ts = jamp.GradScaler(**SCALERS[cfg]), tamp.GradScaler(**SCALERS[cfg])
    jst, tst = js.init_state(), ts.init_state()
    assert _state(tst) == _state(jst)
    scales = []
    for i, f in enumerate(FLAGS):
        jst = js.update_state(jst, jnp.asarray(f))
        tst = ts.update_state(tst, torch.tensor(f))
        assert _state(tst) == _state(jst), f"{cfg} at step {i}"
        scales.append(_state(tst)[0])
    if cfg == "fast":
        # the sequence reaches the floor and grows from it
        assert min(scales) == 1.0 and scales[-1] > 1.0


def test_unscale_and_check_matches_jax_bit_for_bit():
    r = np.random.RandomState(0)
    grads = [r.randn(7, 5).astype(np.float32) * 1024,
             r.randn(9).astype(np.float32)]
    js, ts = jamp.GradScaler(init_loss_scaling=3.0), tamp.GradScaler(
        init_loss_scaling=3.0)
    for bad in (False, True):
        gs = [g.copy() for g in grads]
        if bad:
            gs[1][4] = np.inf
        ju, jf = js.unscale_and_check({str(i): jnp.asarray(g)
                                       for i, g in enumerate(gs)},
                                      js.init_state())
        tu, tf = ts.unscale_and_check([torch.from_numpy(g) for g in gs],
                                      ts.init_state())
        assert bool(tf) == bool(jf) == bad
        for i, t in enumerate(tu):
            np.testing.assert_array_equal(t.numpy(), np.asarray(ju[str(i)]))
    # bf16 gradients: unscaled in float32, rounded back to bf16
    g = torch.from_numpy(grads[0]).to(torch.bfloat16)
    (tb,), _ = ts.unscale_and_check([g], ts.init_state())
    (jb,), _ = js.unscale_and_check(
        [jnp.asarray(grads[0]).astype(jnp.bfloat16)], js.init_state())
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb, np.float32))


# per step: which gradient element (if any) is set to inf, and whether the
# step goes through unscale_ first (the grad-clipping idiom)
STEPS = [(None, False), (None, True), ((0, 3), False), ((1, 0), True),
         (None, False), ((0, 0), False), ((1, 1), False), (None, True),
         (None, False), (None, False)]


@pytest.mark.parametrize("cfg", ["fast", "slow-quarter", "disabled"])
def test_stateful_steps_match_jax(cfg):
    r = np.random.RandomState(1)
    shapes = [(6, 4), (4,)]
    init = [r.randn(*s).astype(np.float32) for s in shapes]
    js, ts = jamp.GradScaler(**SCALERS[cfg]), tamp.GradScaler(**SCALERS[cfg])
    jps = [JParameter(jnp.asarray(v), name=f"p{i}")
           for i, v in enumerate(init)]
    jo = jopt.Adam(learning_rate=0.01, parameters=jps)
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    to = topt.Adam(learning_rate=0.01,
                   parameters=[(f"p{i}", p) for i, p in enumerate(tps)])
    loss = torch.tensor(2.5)
    assert float(ts.scale(loss)) == float(js.scale(jnp.asarray(2.5)))
    scale = float(js.get_loss_scaling())
    for k, (inf_at, unscale_first) in enumerate(STEPS):
        gs = [r.randn(*s).astype(np.float32) * scale for s in shapes]
        if inf_at is not None:
            gs[inf_at[0]].reshape(-1)[inf_at[1]] = np.inf
        for p, g in zip(jps, gs):
            p._grad = jnp.asarray(g)
        for p, g in zip(tps, gs):
            p.grad = torch.from_numpy(g.copy())
        if unscale_first:
            js.unscale_(jo)
            ts.unscale_(to)
        js.step(jo)
        ts.step(to)
        assert ts.get_loss_scaling() == js.get_loss_scaling(), k
        assert _state(ts.state_dict()) == _state(js.state_dict()), k
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {k}")
        scale = ts.get_loss_scaling()
    # a skipped step leaves Adam's step count, as the JAX host branch does
    skipped = sum(1 for inf_at, _ in STEPS if inf_at is not None) \
        if cfg != "disabled" else 0
    assert int(to.state_dict()["state"]["step"]) == \
        int(jo.state_dict()["state"]["step"]) == len(STEPS) - skipped


def test_scaler_state_dict_and_accessors():
    sc = tamp.GradScaler(init_loss_scaling=8.0)
    sc.set_incr_ratio(3.0)
    assert sc.get_incr_ratio() == 3.0
    with pytest.raises(Exception):
        sc.set_incr_ratio(0.5)
    sc.set_decr_ratio(0.25)
    assert sc.get_decr_ratio() == 0.25
    sc.set_init_loss_scaling(1024.0)
    assert sc.get_init_loss_scaling() == sc.get_loss_scaling() == 1024.0
    sc.set_incr_every_n_steps(7)
    sc.set_decr_every_n_nan_or_inf(5)
    assert (sc.get_incr_every_n_steps(),
            sc.get_decr_every_n_nan_or_inf()) == (7, 5)
    assert sc.is_use_dynamic_loss_scaling() and sc.is_enable()
    other = tamp.GradScaler()
    other.load_state_dict({"scale": np.float32(64.0), "good": np.int32(3),
                           "bad": np.int32(1)})
    assert _state(other.state_dict()) == (64.0, 3, 1)


def test_decorate_casts_o2_and_sets_master_weights():
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    o = topt.AdamW(parameters=m.named_parameters(), multi_precision=False)
    same = tamp.decorate(m, level="O1")
    assert same is m and all(p.dtype == torch.float32
                             for p in m.parameters())
    ids = [id(p) for p in m.parameters()]
    m2, o2 = tamp.decorate(m, o, level="O2")
    assert m2 is m and o2 is o and o.multi_precision
    assert [id(p) for p in m.parameters()] == ids
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    with pytest.raises(Exception):
        tamp.decorate(m, level="O3")


@pytest.fixture
def _no_mesh():
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def test_gpt_tiny_o2_trajectory_matches_jax(_no_mesh):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0, dtype="bfloat16")
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.train()
    r = np.random.RandomState(3)
    state = {}
    for k, v in sorted(jm.state_dict().items()):
        a = r.randn(*v.shape).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        state[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    jamp.decorate(jm, level="O2")
    ids = r.randint(0, 1024, (2, 128)).astype(np.int32)
    labels = r.randint(0, 1024, (2, 128)).astype(np.int32)
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01)
    jsc = jamp.GradScaler()

    @jax.jit
    def jstep(p, st, sst):
        def loss_fn(p):
            with jamp.auto_cast(level="O2", dtype="bfloat16"):
                loss, _ = jm.apply(p, jnp.asarray(ids),
                                   labels=jnp.asarray(labels))
            return jsc.scale_value(loss, sst), loss
        (_, loss), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        g, found = jsc.unscale_and_check(g, sst)
        new_p, new_st = jo.apply_gradients(g, p, st)
        keep = lambda a, b: jnp.where(found, a, b)  # noqa: E731
        p = jax.tree_util.tree_map(keep, p, new_p)
        st = jax.tree_util.tree_map(keep, st, new_st)
        return loss, p, st, jsc.update_state(sst, found)

    p = jm.state_dict()
    st, sst = jo.init(p), jsc.init_state()
    jl = []
    for _ in range(3):
        loss, p, st, sst = jstep(p, st, sst)
        jl.append(float(loss))

    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**kw), device="cpu"), state)
    to = topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=tm.named_parameters())
    tm, to = tamp.decorate(tm, to, level="O2")
    tsc = tamp.GradScaler()
    ti, tl_ = torch.from_numpy(ids), torch.from_numpy(labels)
    tl = [float(train_step(tm, to, ti, tl_, level="O2", scaler=tsc))
          for _ in range(3)]
    assert all(p_.dtype == torch.bfloat16 for p_ in tm.parameters())
    masters = to.state_dict()["state"]["master"]
    assert all(v.dtype == torch.float32 for v in masters.values())
    assert _state(tsc.state_dict()) == _state(sst)
    # bf16 parameters and activations on both sides, rounded at the same
    # ops from float32 sums in other orders: the O1 loss test's bound,
    # 2^-9 of the loss (1.5e-4 relative measured)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 2.0 ** -9 * abs(b), (tl, jl)
    assert tl[2] < tl[0]
