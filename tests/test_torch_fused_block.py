"""Port parity: the fused-block ops (paddle_tpu_torch/ops/fused_block.py,
plain versions) against the JAX functions on both of their routes —
``PTPU_FUSED_BLOCK=reference`` (the jnp composition) and ``=pallas`` (the
K1/K2/K3 Pallas kernels in interpret mode) — on the same numpy inputs, plus
the hash-dropout mask bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import fused_block as jfb
from paddle_tpu.ops.flash_attention import _keep_mask as jax_keep_mask
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.ops import fused_block as tfb

EPS = 1e-5
# float32 on both sides with exact products (conftest pins JAX to
# "highest"); only summation order differs — the JAX suite's own bound
F32_TOL = 2e-5


@pytest.fixture(params=["reference", "pallas"])
def route(request, monkeypatch):
    monkeypatch.setenv(jfb.FUSED_BLOCK_ENV, request.param)
    return request.param


def _params(h=128, ffn=512, seed=0):
    r = np.random.RandomState(seed)
    a = lambda *s: (r.randn(*s) * 0.07).astype(np.float32)  # noqa: E731
    return dict(qkv_w=a(h, 3 * h), qkv_b=a(3 * h), out_w=a(h, h),
                out_b=a(h), w1=a(h, ffn), b1=a(ffn), w2=a(ffn, h), b2=a(h),
                g=(1 + 0.1 * r.randn(h)).astype(np.float32), beta=a(h))


def _x(b=2, s=8, h=128, seed=1):
    return (np.random.RandomState(seed).randn(b, s, h) * 0.5).astype(
        np.float32)


def _j(v, dtype=jnp.float32):
    return jnp.asarray(v, dtype)


def _t(v, dtype=torch.float32):
    return torch.from_numpy(np.asarray(v)).to(dtype)


def _bf16_ulp_tol(ref) -> float:
    """One bfloat16 unit in the last place at the top of the range: both
    sides sum in float32 in different orders and round once to bf16."""
    return float(np.abs(np.asarray(ref, np.float32)).max()) * 2.0 ** -7


def test_ln_linear_matches_jax(route):
    x, p = _x(), _params()
    ref = jfb.fused_ln_linear(_j(x), _j(p["qkv_w"]), _j(p["qkv_b"]),
                              _j(p["g"]), _j(p["beta"]), epsilon=EPS)
    got = tfb.fused_ln_linear(_t(x), _t(p["qkv_w"]), _t(p["qkv_b"]),
                              _t(p["g"]), _t(p["beta"]), epsilon=EPS)
    assert got.shape == (2, 8, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ln_linear_bf16_input_keeps_weight_dtype(route):
    # the serving dtype flow: bf16 residual in, float32 weights -> f32 out
    x, p = _x(seed=2), _params(seed=2)
    ref = jfb.fused_ln_linear(_j(x, jnp.bfloat16), _j(p["qkv_w"]),
                              _j(p["qkv_b"]), _j(p["g"]), _j(p["beta"]),
                              epsilon=EPS)
    got = tfb.fused_ln_linear(_t(x, torch.bfloat16), _t(p["qkv_w"]),
                              _t(p["qkv_b"]), _t(p["g"]), _t(p["beta"]),
                              epsilon=EPS)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("rdtype", ["float32", "bfloat16"])
def test_linear_residual_matches_jax(route, rdtype):
    x, p = _x(seed=3), _params(seed=3)
    r = _x(seed=4)
    ref = jfb.fused_linear_residual(_j(x), _j(p["out_w"]), _j(p["out_b"]),
                                    _j(r, rdtype), training=False)
    got = tfb.fused_linear_residual(_t(x), _t(p["out_w"]), _t(p["out_b"]),
                                    _t(r, getattr(torch, rdtype)),
                                    training=False)
    assert str(got.dtype) == f"torch.{rdtype}"
    tol = F32_TOL if rdtype == "float32" else _bf16_ulp_tol(
        np.asarray(ref, np.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=F32_TOL,
                               atol=tol)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_ffn_matches_jax(route, xdtype):
    x, p = _x(seed=5), _params(seed=5)
    args_j = [_j(p[k]) for k in ("w1", "b1", "w2", "b2", "g", "beta")]
    args_t = [_t(p[k]) for k in ("w1", "b1", "w2", "b2", "g", "beta")]
    ref = jfb.fused_ffn_block(_j(x, xdtype), *args_j, epsilon=EPS,
                              training=False)
    got = tfb.fused_ffn_block(_t(x, getattr(torch, xdtype)), *args_t,
                              epsilon=EPS, training=False)
    assert str(got.dtype) == f"torch.{xdtype}"
    tol = F32_TOL if xdtype == "float32" else _bf16_ulp_tol(
        np.asarray(ref, np.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=F32_TOL,
                               atol=tol)


@pytest.mark.parametrize("seed", [0, 7, 123456789, -5, 2 ** 31 - 1])
@pytest.mark.parametrize("salt", [tfb._SALT_RESID, tfb._SALT_FFN1,
                                  tfb._SALT_FFN2, 3])
def test_keep_mask_bit_exact(seed, salt):
    rows = np.arange(40, dtype=np.int32)[:, None]
    cols = np.arange(300, dtype=np.int32)[None, :]
    for p in (0.1, 0.5, 0.9):
        ref = jax_keep_mask(jnp.asarray(seed, jnp.int32).astype(jnp.uint32),
                            jnp.uint32(salt), jnp.asarray(rows),
                            jnp.asarray(cols), p)
        got = tfb._keep_mask(seed, salt, torch.from_numpy(rows),
                             torch.from_numpy(cols), p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_linear_residual_dropout_matches_jax(route):
    x, p, r = _x(seed=6), _params(seed=6), _x(seed=7)
    ref = jfb.fused_linear_residual(_j(x), _j(p["out_w"]), _j(p["out_b"]),
                                    _j(r), dropout_p=0.3, training=True,
                                    seed=jnp.asarray(41, jnp.int32))
    got = tfb.fused_linear_residual(_t(x), _t(p["out_w"]), _t(p["out_b"]),
                                    _t(r), dropout_p=0.3, training=True,
                                    seed=41)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ffn_dropout_matches_jax(route):
    x, p = _x(seed=8), _params(seed=8)
    args_j = [_j(p[k]) for k in ("w1", "b1", "w2", "b2", "g", "beta")]
    args_t = [_t(p[k]) for k in ("w1", "b1", "w2", "b2", "g", "beta")]
    ref = jfb.fused_ffn_block(_j(x), *args_j, dropout1=0.2, dropout2=0.4,
                              epsilon=EPS, training=True,
                              seed=jnp.asarray(9, jnp.int32))
    got = tfb.fused_ffn_block(_t(x), *args_t, dropout1=0.2, dropout2=0.4,
                              epsilon=EPS, training=True, seed=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_cpu_tensors_take_plain_versions():
    x, p = _x(seed=10), _params(seed=10)
    before = dict(_kernels.launches)
    out = tfb.fused_ffn_block(_t(x), *[_t(p[k]) for k in
                                       ("w1", "b1", "w2", "b2", "g", "beta")],
                              training=False)
    ref = tfb.ffn_reference(_t(x).reshape(-1, 128),
                            *[_t(p[k]) for k in ("w1", "b1", "w2", "b2", "g",
                                                 "beta")])
    np.testing.assert_array_equal(out.reshape(-1, 128).numpy(), ref.numpy())
    assert _kernels.launches == before


@pytest.mark.parametrize("wrapper", ["ln_linear", "linear_residual", "ffn"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    x, p = _t(_x().reshape(-1, 128)), {k: _t(v) for k, v in
                                       _params().items()}
    call = {"ln_linear": lambda: tfb.ln_linear_cuda(
                x, p["qkv_w"], p["qkv_b"], p["g"], p["beta"], EPS),
            "linear_residual": lambda: tfb.linear_residual_cuda(
                x, p["out_w"], p["out_b"], x),
            "ffn": lambda: tfb.ffn_cuda(x, p["w1"], p["b1"], p["w2"],
                                        p["b2"], p["g"], p["beta"])}[wrapper]
    with pytest.raises(ValueError, match="must be on"):
        call()
