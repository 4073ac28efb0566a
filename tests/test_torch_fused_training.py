"""Port parity for fused-block training (``use_fused_block=True`` in the
cache-free forward), on the CPU: the same numpy inputs through the JAX
package and the port.

- K1 ``fused_ln_linear``, K2 ``fused_linear_residual`` (hash dropout 0.3)
  and K3 ``fused_ffn_block`` (dropout1 0.2, dropout2 0.4): forward and every
  input gradient against ``jax.vjp`` of the JAX op, on both of the JAX
  package's routes (``PTPU_FUSED_BLOCK=reference``: the jnp composition;
  ``=pallas``: the Pallas kernels in interpret mode, whose ``custom_vjp``
  recomputes the composition);
- ``fused_attention_block`` with attention and hidden dropout 0.1: forward
  and every gradient; its CPU attention, ``_attention_ref``, at lengths
  that are no multiple of 8, causal or not, float32 and bf16;
- the three ops under O1 ``auto_cast``: output dtypes, values and
  gradients;
- the recompute ``autograd.Function`` the card runs, driven here with the
  plain versions in the kernel's place: the gradients of plain autograd;
- ``gpt_tiny(use_fused_block=True)`` at dropout 0: the loss and every
  parameter gradient, and a 3-step AdamW loss trajectory, against JAX;
  fused against the port's unfused model.

Seeds are explicit: JAX draws its own through threefry, so only a given
seed gives both packages one mask.
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
from paddle_tpu.ops import fused_block as jfb
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops import fused_block as tfb
from paddle_tpu_torch.optimizer import AdamW

EPS = 1e-5
# float32 on both sides with exact products (conftest pins JAX to
# "highest"); only summation order differs: 2e-5 of each tensor's range
# (the suite's F32_TOL), plus 1e-7 for tensors that are rounding noise on
# both sides
F32_TOL = 2e-5
# bf16: both sides round at the same ops, from float32 sums in other
# orders, so an element may land one bf16 unit (2^-7 of the range) apart
BF16_TOL = 2.0 ** -7

H, FFN, HEADS = 128, 512, 4


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
def _no_mesh():
    # the JAX fused block runs only without a mesh; earlier files may leave
    # one installed
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


@pytest.fixture(params=["reference", "pallas"])
def route(request, monkeypatch):
    monkeypatch.setenv(jfb.FUSED_BLOCK_ENV, request.param)
    return request.param


def _close(got, ref, what, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * float(np.abs(ref).max()) + 1e-7
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _arrays(seed, *shapes, std=0.1):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * std).astype(np.float32) for s in shapes]


def _gain(seed, n):
    return (1 + 0.1 * np.random.RandomState(seed).randn(n)).astype(
        np.float32)


# each op: its JAX and port function over the tensor inputs, the inputs
OPS = {
    "ln_linear": (
        lambda x, w, b, g, beta: jfb.fused_ln_linear(x, w, b, g, beta,
                                                     epsilon=EPS),
        lambda x, w, b, g, beta: tfb.fused_ln_linear(x, w, b, g, beta,
                                                     epsilon=EPS),
        lambda: [*_arrays(1, (2, 8, H), std=1.0),
                 *_arrays(2, (H, 3 * H), (3 * H,)), _gain(3, H),
                 *_arrays(4, (H,))]),
    "linear_residual": (
        lambda x, w, b, r: jfb.fused_linear_residual(
            x, w, b, r, dropout_p=0.3, seed=jnp.asarray(41, jnp.int32)),
        lambda x, w, b, r: tfb.fused_linear_residual(x, w, b, r,
                                                     dropout_p=0.3, seed=41),
        lambda: _arrays(5, (2, 8, H), (H, H), (H,), (2, 8, H))),
    "ffn": (
        lambda x, w1, b1, w2, b2, g, beta: jfb.fused_ffn_block(
            x, w1, b1, w2, b2, g, beta, dropout1=0.2, dropout2=0.4,
            epsilon=EPS, seed=jnp.asarray(9, jnp.int32)),
        lambda x, w1, b1, w2, b2, g, beta: tfb.fused_ffn_block(
            x, w1, b1, w2, b2, g, beta, dropout1=0.2, dropout2=0.4,
            epsilon=EPS, seed=9),
        lambda: [*_arrays(6, (2, 8, H), std=1.0),
                 *_arrays(7, (H, FFN), (FFN,), (FFN, H), (H,)), _gain(8, H),
                 *_arrays(9, (H,))]),
}


def _jax_vjp(fn, inputs, ct):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return out, vjp(jnp.asarray(ct, out.dtype))


def _port_grads(fn, inputs, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct).to(out.dtype))
    return out, [t.grad for t in ts]


def _cotangent(shape, seed=99):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_and_every_grad_match_jax(route, op):
    jfn, tfn, make = OPS[op]
    inputs = make()
    out, _ = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
    ct = _cotangent(out.shape)
    jout, jgrads = _jax_vjp(jfn, inputs, ct)
    tout, tgrads = _port_grads(tfn, inputs, ct)
    _close(tout.detach(), jout, f"{op} out")
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        _close(g, jg, f"{op} grad {i}")


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_under_o1_matches_jax(route, op):
    # O1 casts only w (K1), x and w (K2), w1 and w2 (K3): the output dtype
    # follows; gradients flow back through the casts into float32 inputs
    jfn, tfn, make = OPS[op]
    inputs = make()
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        out, _ = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
        ct = _cotangent(out.shape)
        jout, jgrads = _jax_vjp(jfn, inputs, ct)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        tout, tgrads = _port_grads(tfn, inputs, ct)
    assert str(tout.dtype).split(".")[-1] == str(jout.dtype)
    assert {"ln_linear": "bfloat16", "linear_residual": "float32",
            "ffn": "float32"}[op] == str(jout.dtype)
    _close(tout.detach().float(), np.asarray(jout, np.float32), f"{op} out",
           tol=BF16_TOL)
    if op == "ln_linear":
        # K1's bias gradient sums the bf16 cotangent over the 16 rows.
        # The JAX VJP of its bf16 broadcast add accumulates that sum in
        # bf16 on the CPU (~0.2 off the exact sum at this seed, three bf16
        # units of the range); torch accumulates in float32.  It is held
        # against the exact sum of the rounded cotangent instead
        jgrads = list(jgrads)
        jgrads[2] = np.asarray(jnp.asarray(ct, jnp.bfloat16), np.float32
                               ).reshape(-1, 3 * H).sum(0)
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        assert g.dtype == torch.float32
        _close(g, jg, f"{op} grad {i}", tol=BF16_TOL)


@pytest.mark.parametrize("op", sorted(OPS))
def test_recompute_function_gives_autograd_grads(op):
    # the card's autograd.Function, with the plain version standing in for
    # the kernel: its recompute backward equals autograd through the plain
    # version, and the static arguments (seed, rates) take no gradient
    kernel, plain, static = {
        "ln_linear": (tfb.ln_linear_reference, tfb.ln_linear_reference,
                      (EPS,)),
        "linear_residual": (tfb.linear_residual_reference,
                            tfb.linear_residual_reference,
                            (41, 0.3, tfb._SALT_RESID)),
        "ffn": (tfb.ffn_reference, tfb.ffn_reference,
                (9, "gelu", 0.2, 0.4, EPS)),
    }[op]
    inputs = [a.reshape(16, -1) if a.ndim == 3 else a
              for a in OPS[op][2]()]
    ct = None
    grads = []
    for fn in (lambda *t: tfb._Recompute.apply(kernel, plain, len(t), *t,
                                               *static),
               lambda *t: plain(*t, *static)):
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
        out = fn(*ts)
        if ct is None:
            ct = torch.from_numpy(_cotangent(tuple(out.shape)))
        out.backward(ct)
        grads.append([out.detach()] + [t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("s", [8, 13])   # 13: JAX takes _attention_ref
def test_attention_block_and_every_grad_match_jax(route, s):
    x, qkv_w, qkv_b, out_w, out_b, beta = _arrays(
        10, (2, s, H), (H, 3 * H), (3 * H,), (H, H), (H,), (H,))
    x = x * 10.0
    g = _gain(11, H)
    inputs = [x, qkv_w, qkv_b, out_w, out_b, g, beta]
    kw = dict(num_heads=HEADS, epsilon=EPS, attn_dropout=0.1,
              hidden_dropout=0.1)
    jfn = lambda *a: jfb.fused_attention_block(  # noqa: E731
        *a, **kw, seed=jnp.asarray(123, jnp.int32))
    tfn = lambda *a: tfb.fused_attention_block(*a, **kw,  # noqa: E731
                                               seed=123)
    ct = _cotangent((2, s, H))
    jout, jgrads = _jax_vjp(jfn, inputs, ct)
    tout, tgrads = _port_grads(tfn, inputs, ct)
    _close(tout.detach(), jout, "attention block out")
    for i, (gr, jg) in enumerate(zip(tgrads, jgrads)):
        _close(gr, jg, f"attention block grad {i}")


@pytest.mark.parametrize("s,causal,p,dtype", [
    (1, True, 0.2, "float32"), (13, True, 0.2, "float32"),
    (24, False, 0.2, "float32"), (13, True, 0.0, "float32"),
    (13, True, 0.2, "bfloat16")])
def test_attention_ref_matches_jax(s, causal, p, dtype):
    # the CPU route of the attention half at every length, the card's being
    # the flash kernels: the JAX package's _attention_ref, same mask
    q, k, v = _arrays(13, (2, s, HEADS, 16), (2, s, HEADS, 16),
                      (2, s, HEADS, 16), std=1.0)
    jout = jfb._attention_ref(
        *[jnp.asarray(a, dtype) for a in (q, k, v)], 0.25, causal, p,
        jnp.asarray(77, jnp.int32))
    tout = tfb._attention_ref(
        *[torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)],
        0.25, causal, p, 77)
    assert str(tout.dtype) == f"torch.{dtype}"
    _close(tout.float(), np.asarray(jout, np.float32), "attention",
           F32_TOL if dtype == "float32" else BF16_TOL)


def test_attention_block_dropout_follows_the_seed():
    inputs = [torch.from_numpy(a) for a in _arrays(
        12, (2, 8, H), (H, 3 * H), (3 * H,), (H, H), (H,), (H,), (H,))]
    kw = dict(num_heads=HEADS, attn_dropout=0.5, hidden_dropout=0.5)
    a = tfb.fused_attention_block(*inputs, **kw, seed=3)
    b = tfb.fused_attention_block(*inputs, **kw, seed=3)
    c = tfb.fused_attention_block(*inputs, **kw, seed=4)
    off = tfb.fused_attention_block(*inputs, **kw, training=False)
    plain = tfb.fused_attention_block(*inputs, num_heads=HEADS)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, plain)


# ---------------------------------------------------------------------------
# gpt_tiny with use_fused_block
# ---------------------------------------------------------------------------
B, S = 2, 128


def _models(fused=True, seed=0):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0,
              use_pallas_attention=True, use_fused_block=fused)
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


def _jax_loss_fn(jm, ids, labels):
    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ids), labels=jnp.asarray(labels))
        return loss
    return loss_fn


def _port_loss_and_grads(tm, ids, labels):
    loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in tm.named_parameters()}


def test_gpt_tiny_fused_loss_and_every_grad_match_jax(route):
    jm, tm, ids, labels = _models()
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, ids, labels)))(
        jm.state_dict())
    tl, tg = _port_loss_and_grads(tm, ids, labels)
    _close(tl, jl, "loss")
    assert set(tg) == set(jg)
    for k in sorted(jg):
        _close(tg[k], jg[k], f"grad {k}")


def test_gpt_tiny_fused_adamw_trajectory_matches_jax(route):
    jm, tm, ids, labels = _models(seed=2)
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
    jl, tl = [], []
    for _ in range(3):
        loss, p, st = jstep(p, st)
        jl.append(float(loss))
        to.zero_grad(set_to_none=True)
        loss, _ = _port_loss_and_grads(tm, ids, labels)
        to.step()
        tl.append(float(loss))
    # the losses, not every parameter: Adam moves a parameter whose
    # gradient is rounding noise on both sides by +-lr in either package
    _close(tl, jl, "loss trajectory")
    assert tl[2] < tl[0]


def test_gpt_tiny_fused_matches_unfused():
    _, fused, ids, labels = _models(fused=True, seed=3)
    _, unfused, _, _ = _models(fused=False, seed=3)
    fl, fg = _port_loss_and_grads(fused, ids, labels)
    ul, ug = _port_loss_and_grads(unfused, ids, labels)
    _close(fl, ul, "loss")
    for k in sorted(ug):
        _close(fg[k], ug[k], f"grad {k}")
