"""Port parity for the MoE part of slice 7, on the CPU: the same numpy
weights, logits and data through the JAX package's
``paddle_tpu/distributed/moe.py`` and GPT with MoE layers, and through the
port's.

- ``limit_by_capacity``, ``switch_gating`` and ``gshard_gating``: kept
  masks, positions and dispatch exact, combine and aux within float32
  rounding, on random logits, on logits with ties (``argmax`` takes the
  first maximum) and at capacities that drop tokens;
- the index route (``route``, what ``MoELayer`` runs) against the one-hot
  gates, exactly;
- ``MoELayer``: output, aux and the gradients of the gate, ``w1``, ``b1``,
  ``w2``, ``b2`` and the input against the JAX layer (float32), and the
  bf16 output within one bf16 unit;
- GPT with MoE layers at ``gpt_tiny`` sizes: the loss and every gradient in
  float32 (``moe_every`` 2 and 1, switch gating, with ``use_recompute``,
  with ``use_fused_block``, whose MoE layers run unfused as in the JAX
  package), a 3-step AdamW loss trajectory, the bf16 O1 loss, and greedy
  ``generate`` and ``ServingEngine`` tokens exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.inference.engine import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import UnavailableError, UnimplementedError
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state, moe_training_workload
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models.gpt import (GPTMLP, GPTConfig, GPTForCausalLM,
                                         gpt_tiny)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.training import train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work.  Under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores and spin: six translation recipes run at once took 916 s
    each with eight threads and 5 s each with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, S = 2, 64
# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"): losses and gradients differ by summation order only (~2e-6 of
# each tensor's range through two layers, the routing identical); 1e-4 of
# the range plus 1e-7 is the bound, far below what a wrong slot, gate or
# dropped token moves (a whole expert row)
F32_TOL = 1e-4
# aux is E * sum_e mean(mask_e) * mean(probs_e): float32 means of the same
# softmax in other summation orders, a few ulps
AUX_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _no_mesh():
    # JAX model parity runs serially; earlier files may leave a mesh
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def _close(got, ref, what, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * float(np.abs(ref).max()) + 1e-7
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
def _logits(kind, t=48, e=4, seed=0):
    r = np.random.RandomState(seed)
    if kind == "ties":
        # few distinct values: most rows hold a tied maximum (and a tied
        # runner-up), so the first-maximum rule decides both choices
        return r.randint(0, 3, (t, e)).astype(np.float32)
    if kind == "skewed":
        # most tokens prefer expert 0: it overflows at any capacity < t
        a = r.randn(t, e).astype(np.float32)
        a[:, 0] += 2.0
        return a
    return r.randn(t, e).astype(np.float32)


@pytest.mark.parametrize("capacity", [1, 5, 48])
def test_limit_by_capacity_matches_jax(capacity):
    r = np.random.RandomState(capacity)
    mask = np.eye(4, dtype=np.float32)[r.randint(0, 4, 40)]
    jk, jp = jmoe.limit_by_capacity(jnp.asarray(mask), capacity)
    tk, tp = tmoe.limit_by_capacity(_t(mask), capacity)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.int32


@pytest.mark.parametrize("gate", ["switch", "gshard"])
@pytest.mark.parametrize("kind,capacity", [("random", 24), ("ties", 7),
                                           ("skewed", 10), ("random", 3)])
def test_gating_matches_jax(gate, kind, capacity):
    logits = _logits(kind)
    jfn = {"switch": jmoe.switch_gating, "gshard": jmoe.gshard_gating}[gate]
    tfn = {"switch": tmoe.switch_gating, "gshard": tmoe.gshard_gating}[gate]
    jd, jc, ja = jfn(jnp.asarray(logits), capacity)
    td, tc, ta = tfn(_t(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # combine: nonzero exactly where dispatch is; its values are softmax
    # entries (GShard: their normalised pair) whose float32 exp sums run in
    # another order, an ulp or two of values <= 1 apart
    np.testing.assert_array_equal(tc.numpy() != 0, np.asarray(jd) != 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)
    if capacity < 24:
        # the tight capacities drop tokens, which is the point
        assert td.sum() < logits.shape[0] * (2 if gate == "gshard" else 1)


@pytest.mark.parametrize("gate", ["switch", "gshard"])
@pytest.mark.parametrize("kind,capacity", [("random", 24), ("ties", 7),
                                           ("skewed", 10)])
def test_index_route_is_the_one_hot_gating(gate, kind, capacity):
    logits = _t(_logits(kind, seed=3))
    dispatch, combine, aux = {"switch": tmoe.switch_gating,
                              "gshard": tmoe.gshard_gating}[gate](
        logits, capacity)
    r = tmoe.route(logits, capacity, gate)
    t, e = logits.shape
    d = torch.zeros(t, e, capacity)
    c = torch.zeros(t, e, capacity)
    rows = torch.arange(t)
    for ex, sl, k, g in zip(r.expert, r.slot, r.kept, r.gate):
        assert bool(((sl < capacity) | (k == 0)).all())
        d[rows, ex, sl] += k
        c[rows, ex, sl] += g * k
    assert torch.equal(d, dispatch)
    assert torch.equal(c, combine)
    assert torch.equal(r.aux, aux)


def test_route_rejects_an_unknown_gate():
    with pytest.raises(Exception, match="unknown gate"):
        tmoe.route(torch.zeros(4, 2), 2, "top3")


# ---------------------------------------------------------------------------
# MoELayer
# ---------------------------------------------------------------------------
def _layer_pair(gate, capacity_factor, seed=0, e=4, h=32, f=64):
    jl = jmoe.MoELayer(h, f, e, gate=gate, capacity_factor=capacity_factor)
    tl = tmoe.MoELayer(h, f, e, gate=gate, capacity_factor=capacity_factor,
                       device="cpu")
    r = np.random.RandomState(seed)
    state = {k: (0.3 * r.randn(*v.shape)).astype(np.float32)
             for k, v in jl.state_dict().items()}
    jl.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    load_jax_state(tl, state)
    x = r.randn(3, 20, h).astype(np.float32)
    return jl, tl, state, x


@pytest.mark.parametrize("gate,capacity_factor", [("gshard", 2.0),
                                                  ("gshard", 0.5),
                                                  ("switch", 0.75)])
def test_moe_layer_output_aux_and_grads_match_jax(gate, capacity_factor):
    jl, tl, state, x = _layer_pair(gate, capacity_factor)
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jl.apply(p, xx, method="forward_with_aux")
        return jnp.sum(out * g) + 3.0 * aux, (out, aux)

    (_, (jo, ja)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    to, ta = tl.forward_with_aux(tx)
    ((to * _t(g)).sum() + 3.0 * ta).backward()
    _close(to.detach(), jo, "output")
    np.testing.assert_allclose(float(ta.detach()), float(ja), rtol=AUX_RTOL)
    _close(tx.grad, jgx, "d input")
    params = dict(tl.named_parameters())
    assert set(params) == set(jgp) == {
        "gate_weight", "experts.w1", "experts.b1", "experts.w2",
        "experts.b2"}
    for k in sorted(jgp):
        _close(params[k].grad, jgp[k], f"grad {k}")


def test_moe_layer_bf16_output_within_one_bf16_unit():
    jl, tl, _, x = _layer_pair("gshard", 1.0, seed=5)
    jo, ja = jl.forward_with_aux(jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        to, ta = tl.forward_with_aux(_t(x).to(torch.bfloat16))
    assert to.dtype == torch.bfloat16
    # the expert products run in bf16 on both sides (float32 sums, one
    # rounding each); the copies into the expert buffer are exact and the
    # combine sums the same two products: one bf16 unit (2^-7 of the
    # range) bounds what summation order moves, a misrouted row moves far
    # more.  The routing itself is float32 on both sides.
    ref = np.asarray(jo.astype(jnp.float32))
    _close(to.float(), ref, "bf16 output", tol=2.0 ** -7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)


def test_aux_collection_scope():
    _, tl, _, x = _layer_pair("gshard", 2.0)
    assert tmoe._record_aux(torch.ones(())) is False     # no scope
    with tmoe.collect_aux_losses() as outer:
        tl(_t(x))
        with tmoe.collect_aux_losses() as inner:
            tl(_t(x))
        tl(_t(x))
    assert len(outer) == 2 and len(inner) == 1


def test_capacity_matches_jax():
    for gate in ("switch", "gshard"):
        for cf in (0.5, 1.0, 2.0, 1.25):
            jl = jmoe.MoELayer(8, 16, 8, gate=gate, capacity_factor=cf)
            tl = tmoe.MoELayer(8, 16, 8, gate=gate, capacity_factor=cf,
                               device="cpu")
            for tokens in (1, 7, 64, 16384):
                assert tl.capacity(tokens) == jl.capacity(tokens)
    # the full row: 16384 tokens, 8 experts, GShard at 2.0
    row = tmoe.MoELayer(8, 16, 8, gate="gshard", capacity_factor=2.0,
                        device="cpu")
    assert row.capacity(8 * 2048) == 8192


# ---------------------------------------------------------------------------
# GPT with MoE layers
# ---------------------------------------------------------------------------
MOE = dict(moe_num_experts=4, moe_capacity_factor=0.75)
CASES = {
    "every2": dict(moe_every=2),
    "every1": dict(moe_every=1),
    "switch": dict(moe_every=2, moe_gate="switch"),
    "recompute": dict(moe_every=1, use_recompute=True),
    "fused": dict(moe_every=2, use_fused_block=True),
    "flash": dict(moe_every=2, use_pallas_attention=True),
}


def _models(extra, dtype="float32", seed=0):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0, dtype=dtype, **MOE,
              **extra)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.train()
    r = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jm.state_dict().items()):
        a = r.randn(*v.shape).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        state[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**kw), device="cpu"), state)
    tm.train()
    r = np.random.RandomState(seed + 1)
    ids = r.randint(0, 1024, (B, S)).astype(np.int32)
    labels = r.randint(0, 1024, (B, S)).astype(np.int32)
    return jm, tm, ids, labels


def _jax_loss_fn(jm, ids, labels, o1=False):
    def loss_fn(p):
        if o1:
            with jamp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = jm.apply(p, jnp.asarray(ids),
                                   labels=jnp.asarray(labels))
        else:
            loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(labels))
        return loss
    return loss_fn


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_gpt_loss_and_every_grad_match_jax(case):
    jm, tm, ids, labels = _models(CASES[case])
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, ids, labels)))(
        jm.state_dict())
    tl, _ = tm(_t(ids), labels=_t(labels))
    tl.backward()
    _close(tl.detach(), jl, "loss")
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jg)
    assert any(".mlp.experts.w1" in k for k in tgrads)
    for k in sorted(jg):
        _close(tgrads[k].grad, jg[k], f"grad {k}")


def test_moe_aux_enters_the_loss_once_per_moe_layer():
    _, tm, ids, labels = _models(CASES["recompute"])
    with torch.no_grad():
        with_aux, _ = tm(_t(ids), labels=_t(labels))
        tm.config.moe_aux_weight = 0.0
        without, _ = tm(_t(ids), labels=_t(labels))
        tm.config.moe_aux_weight = 0.01
        auxes = []
        x = tm.gpt.wte(_t(ids)) + tm.gpt.wpe[:S]
        for layer in tm.gpt.h:
            h = x + layer.attn(layer.ln_1(x))
            out, aux = layer.mlp.forward_with_aux(layer.ln_2(h))
            auxes.append(aux)
            x = h + out
    assert len(auxes) == tm.config.num_layers        # moe_every=1
    torch.testing.assert_close(with_aux - without, 0.01 * sum(auxes),
                               rtol=1e-5, atol=1e-7)


def test_moe_gpt_adamw_trajectory_matches_jax():
    jm, tm, ids, labels = _models(CASES["every2"], seed=2)
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01)
    loss_fn = _jax_loss_fn(jm, ids, labels)

    @jax.jit
    def jstep(p, st):
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, st = jo.apply_gradients(g, p, st)
        return loss, p, st

    p = jm.state_dict()
    st = jo.init(p)
    to = AdamW(learning_rate=1e-3, weight_decay=0.01,
               parameters=tm.parameters())
    ti, tlab = _t(ids), _t(labels)
    jl, tl = [], []
    for _ in range(3):
        loss, p, st = jstep(p, st)
        jl.append(float(loss))
        to.zero_grad(set_to_none=True)
        loss_t, _ = tm(ti, labels=tlab)
        loss_t.backward()
        to.step()
        tl.append(float(loss_t))
    # the losses, not every parameter (Adam moves rounding-noise gradients
    # by +-lr in either package, see test_torch_training.py)
    _close(tl, jl, "loss trajectory")
    assert tl[2] < tl[0]


def test_moe_gpt_o1_bf16_loss_matches_jax():
    jm, tm, ids, labels = _models(CASES["flash"], dtype="bfloat16", seed=4)
    jl = jax.jit(_jax_loss_fn(jm, ids, labels, o1=True))(jm.state_dict())
    with torch.no_grad(), tamp.auto_cast(level="O1", dtype="bfloat16"):
        tl, _ = tm(_t(ids), labels=_t(labels))
    # bf16 activations and expert products on both sides, rounded at the
    # same ops but summed in other orders: single elements land a bf16 unit
    # apart, and the mean over the tokens' losses moves far less; 2^-9 of
    # the loss bounds it (as the dense O1 test in test_torch_training.py).
    # The routing is float32 on both sides; a token routed elsewhere moves
    # the loss by more than the bound
    assert abs(float(tl) - float(jl)) <= 2.0 ** -9 * abs(float(jl))


def test_moe_workload_trains_on_the_cpu():
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True, moe_num_experts=4)
    model, opt, ids, labels = moe_training_workload("cpu", cfg, batch=2,
                                                    seq_len=128)
    assert [layer._is_moe for layer in model.gpt.h] == [False, True]
    losses = [float(train_step(model, opt, ids, labels)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


# ---------------------------------------------------------------------------
# the cache paths
# ---------------------------------------------------------------------------
GEN = dict(hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, vocab_size=256, hidden_dropout=0.0,
           attention_dropout=0.0, moe_num_experts=4, moe_every=1,
           moe_capacity_factor=1.0)


def _gen_models(extra):
    from paddle_tpu.models.gpt import GPTConfig as JaxConfig
    kw = {**GEN, **extra}
    jm = JaxGPT(JaxConfig(**kw))
    jm.eval()
    r = np.random.RandomState(11)
    state = {}
    for k, v in sorted(jm.state_dict().items()):
        a = r.randn(*v.shape).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        state[k] = (1.0 + 0.1 * a) if gain else 0.3 * a
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(GPTForCausalLM(GPTConfig(**kw), device="cpu"), state)
    return jm, tm


@pytest.mark.parametrize("extra", [dict(), dict(use_pallas_attention=True),
                                   dict(use_fused_block=True)],
                         ids=["sdpa", "pallas", "fused"])
def test_moe_greedy_generate_matches_jax(extra):
    jm, tm = _gen_models(extra)
    prompt = np.random.RandomState(1).randint(0, 256, (3, 8)).astype(
        np.int32)
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=8))
    got = tm.generate(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_serving_engine_tokens_match_jax():
    jm, tm = _gen_models(dict(use_fused_block=True))
    prompts = [list(np.random.RandomState(i).randint(0, 256, n))
               for i, n in enumerate((5, 11, 3))]
    kw = dict(max_seqs=4, kv_block_size=4, max_model_len=32)
    want = JaxEngine(jm, **kw).generate(prompts, 6)
    got = ServingEngine(tm, **kw).generate(prompts, 6)
    assert [list(map(int, g)) for g in got] == \
        [list(map(int, w)) for w in want]


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def test_moe_config_builds_at_full_width():
    # the moe row's layer at full width (depth cut to 2 for the CPU)
    cfg = GPTConfig(moe_num_experts=8, moe_every=2, moe_gate="gshard",
                    num_layers=2)
    m = GPTForCausalLM(cfg, device="cpu")
    layer = m.gpt.h[1].mlp
    assert isinstance(layer, tmoe.MoELayer)
    assert tuple(layer.experts.w1.shape) == (8, 768, 3072)
    assert isinstance(m.gpt.h[0].mlp, GPTMLP)
    assert not m.gpt.h[0]._is_moe and m.gpt.h[1]._is_moe


@pytest.mark.parametrize("field", ["sequence_parallel", "context_parallel"])
def test_parallel_fields_still_raise_with_moe(field):
    with pytest.raises(UnimplementedError, match=field):
        gpt_tiny(moe_num_experts=4, **{field: True})


def test_moe_workload_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="no CUDA device"):
        moe_training_workload(None, gpt_tiny(moe_num_experts=4), batch=1,
                              seq_len=8)
