"""Port parity for the training slice as a whole, on the CPU: the same numpy
weights and data through one training step of each package.

- the chunked LM loss ``linear_softmax_cross_entropy``: loss, dh and dW,
  with ignored labels and on a length that takes the unfused fallback;
- ``AdamW``: five steps on a random parameter dict;
- ``gpt_tiny`` in float32, with flash attention and without: the loss and
  every parameter's gradient against ``jax.value_and_grad`` of the JAX
  model (its flash kernels in Pallas interpret mode); a 3-step AdamW loss
  trajectory; the bf16 O1 loss;
- the explicit random streams: a training step with dropout leaves torch's
  global RNG state alone, and one seed gives one mask;
- what the port refuses: unported config fields.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import shift_labels as jax_shift_labels
from paddle_tpu.ops.fused import (linear_softmax_cross_entropy as
                                  jax_lce)
from paddle_tpu_torch import UnimplementedError
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny, shift_labels
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.fused import linear_softmax_cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.training import train_step

B, S = 2, 128
# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"); losses and gradients differ by summation order only (~2e-6
# of each tensor's range through two layers); 1e-4 of the range, plus 1e-7
# for tensors that are rounding noise on both sides, is the bound, far
# below what a missing mask, scale or term moves
F32_TOL = 1e-4


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


# ---------------------------------------------------------------------------
# linear_softmax_cross_entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [256, 100])      # chunked / unfused fallback
def test_linear_cross_entropy_matches_jax(s):
    r = np.random.RandomState(3)
    hidden = r.randn(2, s, 32).astype(np.float32)
    table = (0.3 * r.randn(200, 32)).astype(np.float32)
    labels = r.randint(0, 200, (2, s)).astype(np.int32)
    labels[0, :7] = -100                       # ignored tokens
    g = 1.7                                    # upstream gradient
    jl, jvjp = jax.vjp(lambda h, t: jax_lce(h, t, jnp.asarray(labels),
                                            seq_chunk=128 if s == 256
                                            else None),
                       jnp.asarray(hidden), jnp.asarray(table))
    jdh, jdw = jvjp(jnp.asarray(g, jnp.float32))
    ht = torch.from_numpy(hidden).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tl = linear_softmax_cross_entropy(ht, tt, torch.from_numpy(labels),
                                      seq_chunk=128 if s == 256 else None)
    (tl * g).backward()
    _close(tl.detach(), jl, "loss")
    _close(ht.grad, jdh, "dh")
    _close(tt.grad, jdw, "dW")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_adamw_five_steps_match_jax():
    r = np.random.RandomState(5)
    shapes = {"w": (16, 8), "b": (8,), "g": (3, 4, 5)}
    params = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jo = jopt.AdamW(learning_rate=1e-2, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    to = AdamW(learning_rate=1e-2, weight_decay=0.01,
               parameters=tp.values())
    japply = jax.jit(jo.apply_gradients)
    for gs in grads:
        jp, js = japply({k: jnp.asarray(v) for k, v in gs.items()}, jp, js)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k])
        to.step()
    for k in shapes:
        # float32 elementwise arithmetic in the same order: a few ulps
        _close(tp[k].detach(), jp[k], f"param {k}", tol=1e-6)
        _close(to.state[tp[k]]["slots"]["moment2"],
               js["slots"][k]["moment2"], f"moment2 {k}", tol=1e-6)


# ---------------------------------------------------------------------------
# gpt_tiny: one step, the trajectory, O1
# ---------------------------------------------------------------------------
def _models(pallas: bool, dtype="float32", seed=0):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0, dtype=dtype,
              use_pallas_attention=pallas)
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
                loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(
                    labels))
        else:
            loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(labels))
        return loss
    return loss_fn


@pytest.mark.parametrize("pallas", [True, False], ids=["flash", "sdpa"])
def test_gpt_tiny_loss_and_every_grad_match_jax(pallas):
    jm, tm, ids, labels = _models(pallas)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, ids, labels)))(
        jm.state_dict())
    tl, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert logits is None                  # the fused LM loss
    tl.backward()
    _close(tl.detach(), jl, "loss")
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jg)
    for k in sorted(jg):
        _close(tgrads[k].grad, jg[k], f"grad {k}")


def test_gpt_tiny_adamw_trajectory_matches_jax():
    jm, tm, ids, labels = _models(pallas=False, seed=2)
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
    ti, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    jl, tl = [], []
    for _ in range(3):
        loss, p, st = jstep(p, st)
        jl.append(float(loss))
        tl.append(float(_f32_step(tm, to, ti, tlab)))
    # the losses, not every parameter: Adam scales each update to about
    # lr whatever the gradient's size, so an element whose gradient is
    # rounding noise on both sides (the k bias: softmax ignores a shift of
    # every score in a row) moves by +-lr in either package
    _close(tl, jl, "loss trajectory")
    assert tl[2] < tl[0]


def _f32_step(model, optimizer, ids, labels):
    """``train_step`` without autocast, as the JAX float32 step."""
    optimizer.zero_grad(set_to_none=True)
    loss, _ = model(ids, labels=labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def test_gpt_tiny_o1_bf16_loss_matches_jax():
    jm, tm, ids, labels = _models(pallas=True, dtype="bfloat16", seed=4)
    jl = jax.jit(_jax_loss_fn(jm, ids, labels, o1=True))(jm.state_dict())
    with torch.no_grad(), tamp.auto_cast(level="O1", dtype="bfloat16"):
        tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    # bf16 activations and products on both sides, rounded at the same ops
    # but summed in other orders: single elements land a bf16 unit (2^-8
    # relative) apart, and the mean over 256 tokens' losses moves far less
    # (6.7e-5 relative measured); 2^-9 of the loss bounds it
    assert abs(float(tl) - float(jl)) <= 2.0 ** -9 * abs(float(jl))


@pytest.mark.parametrize("op", ["linear", "matmul", "layer_norm"])
def test_o1_casts_match_jax(op):
    # under O1 linear / matmul go down to bf16, layer_norm up to float32 and
    # back to the input dtype, exactly where the JAX ops cast
    r = np.random.RandomState(8)
    x = r.randn(4, 16).astype(np.float32)
    w = r.randn(16, 16).astype(np.float32)
    b = r.randn(16).astype(np.float32)
    args = {"linear": (x, w, b), "matmul": (x, w),
            "layer_norm": (x.astype(jnp.bfloat16), 16, w[0], b)}[op]
    j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
    t_args = [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        if isinstance(a, np.ndarray) else a for a in args]
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        ref = getattr(JF, op)(*j_args)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        got = getattr(F, op)(*t_args)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    # the same bf16 roundings: one bf16 unit of the range at most
    _close(got.float(), np.asarray(ref, np.float32), op, tol=2.0 ** -7)


def test_unfused_lm_loss_returns_logits():
    _, tm, ids, labels = _models(pallas=True)
    ti, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    with torch.no_grad():
        fused, none = tm(ti, labels=tlab)
        tm.config.fused_lm_loss = False
        loss, logits = tm(ti, labels=tlab)
        tm.config.fused_lm_loss = True
        bare = tm(ti)
    assert none is None and logits.shape == (B, S, 1024)
    assert torch.equal(logits, bare)
    _close(loss, fused.numpy(), "unfused loss")


def test_train_step_runs_o1_and_lowers_the_loss():
    _, tm, ids, labels = _models(pallas=True, dtype="bfloat16", seed=6)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=tm.parameters())
    ti, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    losses = [float(train_step(tm, opt, ti, tlab)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]


# ---------------------------------------------------------------------------
# explicit random streams
# ---------------------------------------------------------------------------
def test_dropout_training_step_leaves_global_rng_alone():
    cfg = gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1,
                   use_pallas_attention=True)
    m = GPTForCausalLM(cfg, device="cpu")
    m.train()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 1024, (2, 64)))
    before = torch.random.get_rng_state()
    a = fw_random.generator("cpu").get_state()
    loss, _ = m(ids, labels=ids)
    loss.backward()
    assert torch.equal(torch.random.get_rng_state(), before)
    # the framework's own stream moved instead
    assert not torch.equal(fw_random.generator("cpu").get_state(), a)


def test_one_seed_gives_one_mask():
    x = torch.ones(64, 64)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator()
    g2.manual_seed(11)
    assert torch.equal(F.dropout(x, 0.5, generator=g1),
                       F.dropout(x, 0.5, generator=g2))
    fw_random.seed(123)
    first = (F.dropout(x, 0.5), fw_random.draw_seed())
    fw_random.seed(123)
    second = (F.dropout(x, 0.5), fw_random.draw_seed())
    assert torch.equal(first[0], second[0]) and first[1] == second[1]


def test_shift_labels_matches_jax():
    labels = np.random.RandomState(0).randint(0, 50, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        shift_labels(torch.from_numpy(labels)).numpy(),
        np.asarray(jax_shift_labels(jnp.asarray(labels))))


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field", ["sequence_parallel", "context_parallel"])
def test_unported_config_fields_raise(field):
    with pytest.raises(UnimplementedError, match=field):
        gpt_tiny(**{field: True})
