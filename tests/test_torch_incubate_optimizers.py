"""``LookAhead``, ``ModelAverage`` and ``DistributedFusedLamb`` of the port
(stateful: ``step()`` over the bound parameters' ``.grad``) against the
JAX functional versions (``init`` / ``apply_gradients``) fed the same
seeded numpy gradients, over several steps, on the CPU.

Over an SGD inner step (one float32 op, exact in both packages)
LookAhead's weights, synced weights included, and ModelAverage's sums and
averages are bit for bit the JAX ones; over Adam within ``RTOL = 1e-6``.
DistributedFusedLamb's parameters and moments agree within ``rtol 2e-5,
atol 1e-6`` (its segment sums add in another order than
``jax.ops.segment_sum``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate.optimizer as jopt_inc
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.incubate as tinc
import paddle_tpu_torch.incubate.optimizer as topt_inc
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.framework.dtype import device_scope

SHAPES = {"w": (6, 4), "b": (4,), "e": (3, 2, 2)}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    # a hybrid mesh left set by an earlier JAX test file on this xdist
    # worker would shard the JAX side (and refuse its ServingEngine in
    # later files); these tests compare single-device runs
    from paddle_tpu.distributed import topology
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(None)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with device_scope("cpu"):
        yield
    torch.set_num_threads(prev)


def _init():
    r = np.random.RandomState(0)
    return {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    r = np.random.RandomState(100 + step)
    return {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _port_params(values):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in values.items()}


def _set_grads(params, grads):
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())


def _exact(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def _inner(kind, tparams):
    named = list(tparams.items())
    if kind == "sgd":
        return jopt.SGD(learning_rate=0.1), topt.SGD(learning_rate=0.1,
                                                     parameters=named)
    return (jopt.Adam(learning_rate=0.05),
            topt.Adam(learning_rate=0.05, parameters=named))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_lookahead_matches_jax_and_syncs_exactly(kind):
    values = _init()
    tparams = _port_params(values)
    jin, tin = _inner(kind, tparams)
    jla = jopt_inc.LookAhead(jin, alpha=0.4, k=3)
    tla = tinc.LookAhead(tin, alpha=0.4, k=3)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    st = jla.init(jp)
    for step in range(1, 8):
        g = _grads(step)
        jp, st = jla.apply_gradients({k: jnp.asarray(v) for k, v in
                                      g.items()}, jp, st)
        _set_grads(tparams, g)
        tla.step()
        for k in SHAPES:
            if kind == "sgd" or step % 3 == 0:
                # slow weights and synced fast weights: bit for bit
                _exact(tla.slow[k], st["slow"][k])
            if kind == "sgd":
                _exact(tparams[k], jp[k])
            else:
                np.testing.assert_allclose(tparams[k].detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-6)
        if step % 3 == 0:
            for k in SHAPES:    # synced: fast == slow
                _exact(tparams[k], tla.slow[k])
    assert tla.step_count == 7 and int(st["step"]) == 7
    sd = tla.state_dict()
    other = tinc.LookAhead(_inner(kind, _port_params(values))[1], 0.4, 3)
    other.set_state_dict(sd)
    assert other.step_count == 7 and torch.equal(other.slow["w"],
                                                 tla.slow["w"])


def test_lookahead_rejects_bad_arguments():
    tin = _inner("sgd", _port_params(_init()))[1]
    with pytest.raises(Exception):
        tinc.LookAhead(tin, alpha=1.5)
    with pytest.raises(Exception):
        tinc.LookAhead(tin, k=0)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_model_average_matches_jax(kind):
    values = _init()
    tparams = _port_params(values)
    jin, tin = _inner(kind, tparams)
    kw = dict(average_window_rate=0.3, min_average_window=2,
              max_average_window=4)
    jma = jopt_inc.ModelAverage(jin, **kw)
    tma = tinc.ModelAverage(tin, **kw)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    st = jma.init(jp)
    for step in range(1, 10):
        g = _grads(step)
        jp, st = jma.apply_gradients({k: jnp.asarray(v) for k, v in
                                      g.items()}, jp, st)
        _set_grads(tparams, g)
        tma.step()
        avg_t, avg_j = tma.average(), jma.average(st, jp)
        for k in SHAPES:
            if kind == "sgd":
                _exact(tma.sum[k], st["sum"][k])
                _exact(avg_t[k], avg_j[k])
            else:
                np.testing.assert_allclose(avg_t[k].numpy(),
                                           np.asarray(avg_j[k]), rtol=1e-6,
                                           atol=1e-6)
    assert tma.count == int(st["count"]) == 9


def test_model_average_apply_and_restore_are_exact():
    tparams = _port_params(_init())
    tma = tinc.ModelAverage(_inner("adam", tparams)[1],
                            average_window_rate=0.5)
    for step in range(1, 5):
        _set_grads(tparams, _grads(step))
        tma.step()
    trained = {k: p.detach().clone() for k, p in tparams.items()}
    avg = tma.average()
    with tma.apply():
        for k, p in tparams.items():
            assert torch.equal(p.detach(), avg[k])
    for k, p in tparams.items():
        assert torch.equal(p.detach(), trained[k])
    tma.apply(need_restore=False)
    assert torch.equal(tparams["w"].detach(), avg["w"])
    tma.restore()
    assert torch.equal(tparams["w"].detach(), trained["w"])


def _lamb_pair(**kw):
    values = _init()
    tparams = _port_params(values)
    j = jopt_inc.DistributedFusedLamb(**kw)
    t = topt_inc.DistributedFusedLamb(parameters=list(tparams.items()), **kw)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    return j, jp, j.init(jp), t, tparams


def _lamb_close(t, tparams, jp, st):
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=2e-5, atol=1e-6)
    # the flat buffers hold the parameters in each package's order: the
    # port's parameter order, the JAX tree's sorted keys
    def segments(order):
        out, off = {}, 0
        for k in order:
            n = int(np.prod(SHAPES[k]))
            out[k] = slice(off, off + n)
            off += n
        return out
    t_seg, j_seg = segments(list(SHAPES)), segments(sorted(SHAPES))
    for slot in ("master", "moment1", "moment2"):
        for k in SHAPES:
            np.testing.assert_allclose(
                t._state[slot][t_seg[k]].numpy(),
                np.asarray(st[slot])[j_seg[k]], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "clip_exclude_align", "scale"])
def test_distributed_fused_lamb_matches_jax(case):
    kw = dict(learning_rate=0.02, lamb_weight_decay=0.05)
    if case == "clip_exclude_align":
        kw.update(grad_clip=jopt.ClipGradByGlobalNorm(0.5),
                  exclude_from_weight_decay_fn=lambda n: n == "b",
                  alignment=16)
    j, jp, st, t, tparams = _lamb_pair(
        **{k: v for k, v in kw.items() if k != "grad_clip"},
        **({"grad_clip": None} if case != "clip_exclude_align" else {}))
    if case == "clip_exclude_align":
        j._max_gnorm = t._max_gnorm = 0.5
    if case == "scale":
        j.set_scale(4.0)
        t.set_scale(4.0)
    for step in range(1, 6):
        g = _grads(step)
        jp, st = j.apply_gradients({k: jnp.asarray(v) for k, v in
                                    g.items()}, jp, st)
        _set_grads(tparams, g)
        t.step()
        _lamb_close(t, tparams, jp, st)
    assert int(t._state["step"]) == int(st["step"]) == 5


def test_distributed_fused_lamb_clip_by_global_norm_object():
    tparams = _port_params(_init())
    t = topt_inc.DistributedFusedLamb(
        parameters=list(tparams.items()),
        grad_clip=topt.ClipGradByGlobalNorm(0.5))
    assert t._max_gnorm == 0.5
    with pytest.raises(Exception):
        topt_inc.DistributedFusedLamb(parameters=list(tparams.items()),
                                      grad_clip=topt.ClipGradByNorm(1.0))
    for flag in ("clip_after_allreduce", "use_master_param_norm"):
        with pytest.raises(Exception):
            topt_inc.DistributedFusedLamb(parameters=list(tparams.items()),
                                          **{flag: False})


def test_distributed_fused_lamb_skips_a_nonfinite_step_on_the_card_side():
    j, jp, st, t, tparams = _lamb_pair(learning_rate=0.02)
    g = _grads(1)
    _set_grads(tparams, g)
    t.step()
    jp, st = j.apply_gradients({k: jnp.asarray(v) for k, v in g.items()},
                               jp, st)
    before = {k: p.detach().clone() for k, p in tparams.items()}
    bad = {k: np.full(s, np.inf, np.float32) for k, s in SHAPES.items()}
    jp2, st2 = j.apply_gradients({k: jnp.asarray(v) for k, v in
                                  bad.items()}, jp, st)
    _set_grads(tparams, bad)
    t.step()
    for k in SHAPES:
        assert torch.equal(tparams[k].detach(), before[k])
    assert int(t._state["step"]) == int(st2["step"]) == 1
    _lamb_close(t, tparams, jp2, st2)
    t.clear_grad()
    assert all(p.grad is None for p in tparams.values())


def test_distributed_fused_lamb_with_an_lr_scheduler_matches_jax():
    from paddle_tpu.optimizer import lr as jlr
    from paddle_tpu_torch.optimizer import lr as tlr
    values = _init()
    tparams = _port_params(values)
    j = jopt_inc.DistributedFusedLamb(
        learning_rate=jlr.StepDecay(learning_rate=0.1, step_size=1,
                                    gamma=0.5))
    t = topt_inc.DistributedFusedLamb(
        learning_rate=tlr.StepDecay(learning_rate=0.1, step_size=1,
                                    gamma=0.5),
        parameters=list(tparams.items()))
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    st = j.init(jp)
    for step in range(1, 4):
        g = _grads(step)
        jp, st = j.apply_gradients({k: jnp.asarray(v) for k, v in
                                    g.items()}, jp, st)
        _set_grads(tparams, g)
        t.step()
        _lamb_close(t, tparams, jp, st)


def test_incubate_exports_the_jax_names():
    import paddle_tpu.incubate as jinc
    assert tinc.LookAhead is topt_inc.LookAhead
    assert tinc.ModelAverage is topt_inc.ModelAverage
    assert set(jinc.__all__) == set(tinc.__all__)
