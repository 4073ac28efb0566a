"""Port parity of ``paddle_tpu_torch/ops/fused.py`` (the epilogues,
``fused_feedforward``, the rotary embedding) and of ``rotary=True`` in the
fused attention blocks, against the JAX functions on the same numpy
inputs, on the CPU.  The fused blocks are held against both JAX routes
(``PTPU_FUSED_BLOCK=reference`` and ``=pallas``, the Pallas kernels in
interpret mode).

Tolerances: float32 forward 2e-5 and gradients 5e-4, absolute and
relative (both sides multiply in float32, conftest pins JAX to "highest";
only summation order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops import fused_block as jfb
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.ops import fused_block as tfb

F32_TOL = 2e-5
GRAD_TOL = 5e-4
H, HEADS, EPS = 64, 4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["reference", "pallas"])
def route(request, monkeypatch):
    monkeypatch.setenv(jfb.FUSED_BLOCK_ENV, request.param)
    return request.param


def _a(seed, *shape, std=0.5):
    return (np.random.RandomState(seed).randn(*shape) * std).astype(
        np.float32)


def _close(got, ref, tol, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def _jax_grads(fn, inputs, ct):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return out, vjp(jnp.asarray(ct))


def _port_grads(fn, inputs, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct))
    return out, [t.grad for t in ts]


# ---------------------------------------------------------------------------
# rotary embedding
# ---------------------------------------------------------------------------
def test_rope_default_positions_match_jax():
    q, k = _a(0, 2, HEADS, 8, 16), _a(1, 2, HEADS, 8, 16)
    jq, jk = jfused.rotary_position_embedding(jnp.asarray(q), jnp.asarray(k))
    tq, tk = tfused.rotary_position_embedding(torch.from_numpy(q),
                                              torch.from_numpy(k))
    _close(tq, jq, F32_TOL, "q")
    _close(tk, jk, F32_TOL, "k")


def test_rope_host_position_ids_match_jax():
    q, k = _a(2, 2, HEADS, 8, 16), _a(3, 2, HEADS, 8, 16)
    pos = np.stack([np.arange(8) + 5, np.arange(8)[::-1] * 3])
    jq, jk = jfused.rotary_position_embedding(jnp.asarray(q), jnp.asarray(k),
                                              position_ids=pos, base=500.0)
    tq, tk = tfused.rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), position_ids=pos,
        base=500.0)
    _close(tq, jq, F32_TOL, "q")
    _close(tk, jk, F32_TOL, "k")


def test_rope_tensor_position_ids_match_jax_traced_ids():
    # JAX computes traced ids on the fly; the port does so for a tensor
    q, k = _a(4, 2, HEADS, 8, 16), _a(5, 2, HEADS, 8, 16)
    pos = (np.arange(8)[None] + np.array([[0], [11]])).astype(np.int32)
    jq, jk = jax.jit(jfused.rotary_position_embedding)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    tq, tk = tfused.rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k),
        position_ids=torch.from_numpy(pos))
    _close(tq, jq, F32_TOL, "q")
    _close(tk, jk, F32_TOL, "k")


def test_rope_tables_are_cached_and_match_jax():
    a = tfused._rope_tables(12, 16, 10000.0)
    assert tfused._rope_tables(12, 16, 10000.0) is a
    assert tfused._rope_tables_on(12, 16, 10000.0,
                                  torch.device("cpu"))[0].dtype \
        == torch.float32
    jcos, jsin = jfused._rope_tables(12, 16, 10000.0)
    _close(a[0], jcos, F32_TOL, "cos")
    _close(a[1], jsin, F32_TOL, "sin")


def test_rope_keeps_bf16():
    q = torch.from_numpy(_a(6, 1, 2, 4, 8)).to(torch.bfloat16)
    tq, _ = tfused.rotary_position_embedding(q, q)
    jq, _ = jfused.rotary_position_embedding(
        jnp.asarray(_a(6, 1, 2, 4, 8), jnp.bfloat16),
        jnp.asarray(_a(6, 1, 2, 4, 8), jnp.bfloat16))
    assert tq.dtype == torch.bfloat16
    _close(tq.float(), np.asarray(jq, np.float32), 2.0 ** -7, "bf16 q")


# ---------------------------------------------------------------------------
# epilogues and fused_feedforward
# ---------------------------------------------------------------------------
def test_bias_dropout_residual_layer_norm_eval_matches_jax():
    x, r, b = _a(7, 2, 5, H), _a(8, 2, 5, H), _a(9, H)
    g, beta = 1 + _a(10, H, std=0.1), _a(11, H, std=0.1)
    ref = jfused.fused_bias_dropout_residual_layer_norm(
        *map(jnp.asarray, (x, r, b, g, beta)), dropout_rate=0.3,
        training=False)
    got = tfused.fused_bias_dropout_residual_layer_norm(
        *map(torch.from_numpy, (x, r, b, g, beta)), dropout_rate=0.3,
        training=False)
    _close(got, ref, F32_TOL, "bias + dropout + residual + LN")


def test_bias_dropout_residual_eval_matches_jax():
    x, r, b = _a(12, 2, 5, H), _a(13, 2, 5, H), _a(14, H)
    ref = jfused.fused_bias_dropout_residual(
        *map(jnp.asarray, (x, r, b)), dropout_rate=0.3, training=False)
    got = tfused.fused_bias_dropout_residual(
        *map(torch.from_numpy, (x, r, b)), dropout_rate=0.3, training=False)
    _close(got, ref, F32_TOL, "bias + dropout + residual")


def test_bias_dropout_residual_drops_in_training():
    x = torch.ones(64, 64)
    out = tfused.fused_bias_dropout_residual(x, torch.zeros(64, 64),
                                             dropout_rate=0.5)
    kept = out != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0))


@pytest.mark.parametrize("pre", [True, False])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_feedforward_and_grads_match_jax(pre, act):
    inputs = [_a(15, 2, 5, H), _a(16, H, 128, std=0.1), _a(17, 128, std=0.1),
              _a(18, 128, H, std=0.1), _a(19, H, std=0.1),
              1 + _a(20, H, std=0.1), _a(21, H, std=0.1)]
    ct = _a(22, 2, 5, H)
    kw = dict(activation=act, pre_layer_norm=pre, epsilon=EPS)
    jout, jgrads = _jax_grads(
        lambda *a: jfused.fused_feedforward(*a, **kw), inputs, ct)
    tout, tgrads = _port_grads(
        lambda *a: tfused.fused_feedforward(*a, **kw), inputs, ct)
    _close(tout, jout, F32_TOL, "fused_feedforward")
    names = ("x", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")
    for name, g, jg in zip(names, tgrads, jgrads):
        _close(g, jg, GRAD_TOL, f"grad {name}")


# ---------------------------------------------------------------------------
# rotary=True in the fused attention blocks
# ---------------------------------------------------------------------------
def _block_inputs(seed, s):
    return [_a(seed, 2, s, H, std=1.0), _a(seed + 1, H, 3 * H, std=0.1),
            _a(seed + 2, 3 * H, std=0.1), _a(seed + 3, H, H, std=0.1),
            _a(seed + 4, H, std=0.1), 1 + _a(seed + 5, H, std=0.1),
            _a(seed + 6, H, std=0.1)]


@pytest.mark.parametrize("s", [8, 13])    # 13: JAX takes _attention_ref
def test_rotary_attention_block_and_grads_match_jax(route, s):
    inputs = _block_inputs(30, s)
    ct = _a(40, 2, s, H)
    kw = dict(num_heads=HEADS, epsilon=EPS, attn_dropout=0.1,
              hidden_dropout=0.1, rotary=True, rope_base=1000.0)
    jout, jgrads = _jax_grads(lambda *a: jfb.fused_attention_block(
        *a, **kw, seed=jnp.asarray(123, jnp.int32)), inputs, ct)
    tout, tgrads = _port_grads(lambda *a: tfb.fused_attention_block(
        *a, **kw, seed=123), inputs, ct)
    _close(tout, jout, F32_TOL, "rotary attention block")
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        _close(g, jg, GRAD_TOL, f"rotary attention block grad {i}")


def test_rotary_changes_the_attention_block():
    inputs = [torch.from_numpy(a) for a in _block_inputs(50, 8)]
    plain = tfb.fused_attention_block(*inputs, num_heads=HEADS)
    rot = tfb.fused_attention_block(*inputs, num_heads=HEADS, rotary=True)
    assert not torch.allclose(plain, rot, atol=1e-4)


def test_rotary_kvcache_steps_match_jax(route):
    # a prefill of 4 tokens, then 3 single-token steps, into a cache of 16:
    # outputs and both caches equal JAX's after every call
    x0, *params = _block_inputs(60, 4)
    xs = [x0] + [_a(70 + i, 2, 1, H, std=1.0) for i in range(3)]
    shape = (2, HEADS, 16, H // HEADS)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    used = 0
    for x in xs:
        jy, jk, jv = jfb.fused_attention_block_kvcache(
            jnp.asarray(x), *map(jnp.asarray, params), jk, jv,
            jnp.asarray(used, jnp.int32), num_heads=HEADS, rotary=True)
        ty, tk, tv = tfb.fused_attention_block_kvcache(
            torch.from_numpy(x), *map(torch.from_numpy, params), tk, tv,
            used, num_heads=HEADS, rotary=True)
        _close(ty, jy, F32_TOL, f"out at {used}")
        _close(tk, jk, F32_TOL, f"k cache at {used}")
        _close(tv, jv, F32_TOL, f"v cache at {used}")
        used += x.shape[1]


def test_rotary_kvcache_rotates_by_the_call_position_as_jax():
    # the reference rotates q and k by their position within the call, not
    # by used + t: a single-token step is rotated as position 0, where rope
    # is the identity, so rotary=True and rotary=False give the same step
    # (a defect of the JAX package that the port keeps; ROADMAP Queue 3)
    x0, *params = _block_inputs(80, 4)
    step = _a(90, 2, 1, H, std=1.0)
    outs = {}
    for rotary in (False, True):
        shape = (2, HEADS, 8, H // HEADS)
        jk = jv = jnp.zeros(shape, jnp.float32)
        _, jk, jv = jfb.fused_attention_block_kvcache(
            jnp.asarray(x0), *map(jnp.asarray, params), jk, jv,
            jnp.asarray(0, jnp.int32), num_heads=HEADS, rotary=True)
        jy, _, _ = jfb.fused_attention_block_kvcache(
            jnp.asarray(step), *map(jnp.asarray, params), jk, jv,
            jnp.asarray(4, jnp.int32), num_heads=HEADS, rotary=rotary)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        _, tk, tv = tfb.fused_attention_block_kvcache(
            torch.from_numpy(x0), *map(torch.from_numpy, params), tk, tv,
            0, num_heads=HEADS, rotary=True)
        ty, _, _ = tfb.fused_attention_block_kvcache(
            torch.from_numpy(step), *map(torch.from_numpy, params), tk, tv,
            4, num_heads=HEADS, rotary=rotary)
        _close(ty, jy, F32_TOL, f"step, rotary={rotary}")
        outs[rotary] = ty
    assert torch.equal(outs[False], outs[True])
