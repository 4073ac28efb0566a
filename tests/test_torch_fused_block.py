"""Port parity: the fused-block ops (paddle_tpu_torch/ops/fused_block.py,
plain versions) against the JAX functions on both of their routes —
``PTPU_FUSED_BLOCK=reference`` (the jnp composition) and ``=pallas`` (the
K1/K2/K3 Pallas kernels in interpret mode) — on the same numpy inputs, plus
the hash-dropout mask bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import amp as jamp
from paddle_tpu.ops import fused_block as jfb
from paddle_tpu.ops.flash_attention import _keep_mask as jax_keep_mask
from paddle_tpu_torch import _kernels
from paddle_tpu_torch import amp as tamp
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


@pytest.mark.parametrize("cast", ["auto_cast", "bf16_weights"])
@pytest.mark.parametrize("drops", [(0.0, 0.0), (0.0, 0.1), (0.2, 0.1)])
def test_ffn_o1_bf16_flow_matches_jax(route, cast, drops):
    # the dtype flow of fused training under O1, which on the card takes
    # the tensor-core K3: a bf16 residual x, w1 and w2 in bf16 (cast by
    # auto_cast, or given so), float32 biases and LN parameters, a bf16
    # output; at gpt_tiny's widths (h = 128, ffn = 512), the dropout of the
    # fused training leg (dropout2) and both
    x, p = _x(seed=11), _params(seed=11)
    d1, d2 = drops
    names = ("w1", "b1", "w2", "b2", "g", "beta")
    wdt = {"w1", "w2"} if cast == "bf16_weights" else set()
    args_j = [_j(p[k], jnp.bfloat16 if k in wdt else jnp.float32)
              for k in names]
    args_t = [_t(p[k], torch.bfloat16 if k in wdt else torch.float32)
              for k in names]
    on = cast == "auto_cast"
    with jamp.auto_cast(enable=on, level="O1", dtype="bfloat16"):
        ref = jfb.fused_ffn_block(_j(x, jnp.bfloat16), *args_j, dropout1=d1,
                                  dropout2=d2, epsilon=EPS, training=True,
                                  seed=jnp.asarray(13, jnp.int32))
    with tamp.auto_cast(enable=on, level="O1", dtype="bfloat16"):
        got = tfb.fused_ffn_block(_t(x, torch.bfloat16), *args_t,
                                  dropout1=d1, dropout2=d2, epsilon=EPS,
                                  training=True, seed=13)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=_bf16_ulp_tol(ref))


# (w1 dtype, w2 dtype, h, ffn, byte offset of w1's data, route)
ROUTES = [
    (torch.bfloat16, torch.bfloat16, 768, 3072, 0, "ffn_mma"),  # training
    (torch.bfloat16, torch.bfloat16, 128, 512, 0, "ffn_mma"),   # gpt_tiny
    (torch.bfloat16, torch.bfloat16, 768, 200, 0, "ffn_mma"),
    (torch.bfloat16, torch.bfloat16, 128, 8, 0, "ffn_mma"),
    (torch.float32, torch.float32, 768, 3072, 0, "ffn"),    # serving, generate
    (torch.bfloat16, torch.float32, 768, 3072, 0, "ffn"),
    (torch.float32, torch.bfloat16, 768, 3072, 0, "ffn"),
    (torch.float16, torch.float16, 768, 3072, 0, "ffn"),
    (torch.bfloat16, torch.bfloat16, 64, 256, 0, "ffn"),     # h not built
    (torch.bfloat16, torch.bfloat16, 1024, 4096, 0, "ffn"),
    (torch.bfloat16, torch.bfloat16, 256, 1024, 0, "ffn"),
    (torch.bfloat16, torch.bfloat16, 512, 2048, 0, "ffn"),
    (torch.bfloat16, torch.bfloat16, 128, 100, 0, "ffn"),    # ffn % 8 != 0
    (torch.bfloat16, torch.bfloat16, 128, 512, 2, "ffn"),    # misaligned
]


@pytest.mark.parametrize("w1dtype,w2dtype,h,ffn,offset,want", ROUTES)
def test_ffn_route(w1dtype, w2dtype, h, ffn, offset, want):
    # the host-side rule that sends a CUDA call to ffn_mma or ffn, from
    # dtypes, shapes and addresses alone (CPU tensors stand in for the
    # card's: the rule reads no device)
    size = torch.empty((), dtype=w1dtype).element_size()
    flat = torch.zeros(h * ffn + offset // size, dtype=w1dtype)
    w1 = flat[offset // size:].view(h, ffn)
    w2 = torch.zeros(ffn, h, dtype=w2dtype)
    assert (w1.data_ptr() % 16 == 0) == (offset == 0)
    assert tfb.ffn_route(w1, w2) == want


def _weight(dtype, rows, cols, offset):
    """A (rows, cols) weight whose data starts ``offset`` bytes into a
    fresh buffer (CPU tensors stand in for the card's: the route rules
    read no device)."""
    size = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(rows * cols + offset // size, dtype=dtype)
    w = flat[offset // size:].view(rows, cols)
    assert (w.data_ptr() % 16 == 0) == (offset == 0)
    return w


# (w dtype, h, cols, byte offset of w's data, route)
LN_LINEAR_ROUTES = [
    (torch.bfloat16, 768, 2304, 0, "ln_linear_mma"),   # fused training QKV
    (torch.bfloat16, 128, 384, 0, "ln_linear_mma"),    # gpt_tiny
    (torch.bfloat16, 768, 200, 0, "ln_linear_mma"),    # ragged column tile
    (torch.bfloat16, 128, 8, 0, "ln_linear_mma"),
    (torch.float32, 768, 2304, 0, "ln_linear"),        # serving, generate
    (torch.float16, 768, 2304, 0, "ln_linear"),
    (torch.bfloat16, 64, 192, 0, "ln_linear"),         # h not built
    (torch.bfloat16, 256, 768, 0, "ln_linear"),
    (torch.bfloat16, 1024, 3072, 0, "ln_linear"),
    (torch.bfloat16, 768, 100, 0, "ln_linear"),        # cols % 8 != 0
    (torch.bfloat16, 768, 2304, 2, "ln_linear"),       # misaligned
    (torch.bfloat16, 128, 384, 8, "ln_linear"),
]


@pytest.mark.parametrize("wdtype,h,cols,offset,want", LN_LINEAR_ROUTES)
def test_ln_linear_route(wdtype, h, cols, offset, want):
    # the host-side rule that sends a CUDA call of K1 to ln_linear_mma or
    # ln_linear, from w's dtype, shape and address alone
    assert tfb.ln_linear_route(_weight(wdtype, h, cols, offset)) == want


# (x dtype, w dtype, k, cols, byte offset of x's data, of w's data, route)
LINEAR_RESIDUAL_ROUTES = [
    (torch.bfloat16, torch.bfloat16, 768, 768, 0, 0,
     "linear_residual_mma"),                              # fused training
    (torch.bfloat16, torch.bfloat16, 128, 128, 0, 0,
     "linear_residual_mma"),                              # gpt_tiny
    (torch.bfloat16, torch.bfloat16, 768, 200, 0, 0, "linear_residual_mma"),
    (torch.float32, torch.float32, 768, 768, 0, 0,
     "linear_residual"),                                  # serving, generate
    (torch.float32, torch.bfloat16, 768, 768, 0, 0, "linear_residual"),
    (torch.bfloat16, torch.float32, 768, 768, 0, 0, "linear_residual"),
    (torch.float16, torch.float16, 768, 768, 0, 0, "linear_residual"),
    (torch.bfloat16, torch.bfloat16, 96, 96, 0, 0,
     "linear_residual"),                                  # k not built
    (torch.bfloat16, torch.bfloat16, 512, 512, 0, 0, "linear_residual"),
    (torch.bfloat16, torch.bfloat16, 768, 100, 0, 0,
     "linear_residual"),                                  # cols % 8 != 0
    (torch.bfloat16, torch.bfloat16, 768, 768, 0, 2,
     "linear_residual"),                                  # w misaligned
    (torch.bfloat16, torch.bfloat16, 768, 768, 2, 0,
     "linear_residual"),                                  # x misaligned
    (torch.bfloat16, torch.bfloat16, 128, 128, 8, 0, "linear_residual"),
]


@pytest.mark.parametrize("xdtype,wdtype,k,cols,xoff,woff,want",
                         LINEAR_RESIDUAL_ROUTES)
def test_linear_residual_route(xdtype, wdtype, k, cols, xoff, woff, want):
    # the host-side rule that sends a CUDA call of K2 to linear_residual_mma
    # or linear_residual, from x's and w's dtypes, shapes and addresses
    x = _weight(xdtype, 37, k, xoff)
    assert tfb.linear_residual_route(x, _weight(wdtype, k, cols, woff)) \
        == want


# (row tiles, column tiles, SMs, splits): the fewest blocks per row tile
# that minimise whole waves x (column tiles + LN) a block
MMA_SPLITS = [
    (256, 9, 132, 1),      # N=16384, 2304 columns: 2 waves of 9 tiles
    (64, 9, 132, 2),       # N=4096: one wave of 5 tiles
    (1, 9, 132, 9),        # N=8: every tile its own block
    (1, 2, 132, 2),        # gpt_tiny's 384 columns
    (132, 9, 132, 1),      # one whole wave
    (133, 9, 132, 3),      # 4 waves of 3 tiles, not 2 of 9
]


@pytest.mark.parametrize("row_tiles,tiles,sms,want", MMA_SPLITS)
def test_ln_linear_mma_splits(monkeypatch, row_tiles, tiles, sms, want):
    monkeypatch.setattr(_kernels, "sm_count", lambda device: sms)
    assert tfb._mma_splits(torch.device("cpu"), row_tiles, tiles) == want


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


@pytest.mark.parametrize("wrapper", ["ln_linear", "linear_residual", "ffn",
                                     "ffn_bf16", "ffn_mma", "ln_linear_mma",
                                     "linear_residual_mma"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    x, p = _t(_x().reshape(-1, 128)), {k: _t(v) for k, v in
                                       _params().items()}
    w1b, w2b = p["w1"].bfloat16(), p["w2"].bfloat16()
    call = {"ln_linear": lambda: tfb.ln_linear_cuda(
                x, p["qkv_w"], p["qkv_b"], p["g"], p["beta"], EPS),
            "linear_residual": lambda: tfb.linear_residual_cuda(
                x, p["out_w"], p["out_b"], x),
            "ffn": lambda: tfb.ffn_cuda(x, p["w1"], p["b1"], p["w2"],
                                        p["b2"], p["g"], p["beta"]),
            # bf16 weights: routed to the tensor-core kernel, which refuses
            # a CPU tensor as well
            "ffn_bf16": lambda: tfb.ffn_cuda(x, w1b, p["b1"], w2b, p["b2"],
                                             p["g"], p["beta"]),
            "ffn_mma": lambda: tfb.ffn_mma_cuda(x, w1b, p["b1"], w2b,
                                                p["b2"], p["g"],
                                                p["beta"]),
            "ln_linear_mma": lambda: tfb.ln_linear_mma_cuda(
                x, p["qkv_w"].bfloat16(), p["qkv_b"], p["g"], p["beta"],
                EPS),
            "linear_residual_mma": lambda: tfb.linear_residual_mma_cuda(
                x.bfloat16(), p["out_w"].bfloat16(), p["out_b"], x)}[wrapper]
    with pytest.raises(ValueError, match="must be on"):
        call()
