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


# serving's dtype pair (a bf16 residual stream, float32 weights) at the rows
# of K1's two float32 routes on the card: the decode rows (ln_linear_stream)
# and a ragged prefill above the stream bound (ln_linear_tiled); the CPU
# runs the plain version, the reference both card kernels are held to
@pytest.mark.parametrize("n", [8, 130])
def test_ln_linear_float32_weight_rows_match_jax(route, n):
    x, p = _x(b=n, s=1, seed=15), _params(seed=15)
    w = _t(p["qkv_w"])
    assert tfb.ln_linear_route(w, n) == (
        "ln_linear_stream" if n <= tfb._LN_STREAM_MAX_ROWS
        else "ln_linear_tiled")
    ref = jfb.fused_ln_linear(_j(x, jnp.bfloat16), _j(p["qkv_w"]),
                              _j(p["qkv_b"]), _j(p["g"]), _j(p["beta"]),
                              epsilon=EPS)
    got = tfb.fused_ln_linear(_t(x, torch.bfloat16), w, _t(p["qkv_b"]),
                              _t(p["g"]), _t(p["beta"]), epsilon=EPS)
    assert got.shape == (n, 1, 384) and got.dtype == torch.float32
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


# (w1 dtype, w2 dtype, h, ffn, byte offset of w1's data, rows N, route):
# the prefill's 4096 rows, then the decode rows and N around the stream
# kernel's bound, then the tiled kernel's rows and what it refuses
_T = tfb._FFN_STREAM_MAX_ROWS
ROUTES = [
    (torch.bfloat16, torch.bfloat16, 768, 3072, 0, 4096,
     "ffn_mma"),                                              # training
    (torch.bfloat16, torch.bfloat16, 128, 512, 0, 4096, "ffn_mma"),  # tiny
    (torch.bfloat16, torch.bfloat16, 768, 200, 0, 4096, "ffn_mma"),
    (torch.bfloat16, torch.bfloat16, 128, 8, 0, 4096, "ffn_mma"),
    (torch.float32, torch.float32, 768, 3072, 0, 4096,
     "ffn_tiled"),                                # serving, generate prefill
    (torch.bfloat16, torch.float32, 768, 3072, 0, 4096, "ffn"),
    (torch.float32, torch.bfloat16, 768, 3072, 0, 4096, "ffn"),
    (torch.float16, torch.float16, 768, 3072, 0, 4096, "ffn"),
    (torch.bfloat16, torch.bfloat16, 64, 256, 0, 4096, "ffn"),  # h not built
    (torch.bfloat16, torch.bfloat16, 1024, 4096, 0, 4096, "ffn"),
    (torch.bfloat16, torch.bfloat16, 256, 1024, 0, 4096, "ffn"),
    (torch.bfloat16, torch.bfloat16, 512, 2048, 0, 4096, "ffn"),
    (torch.bfloat16, torch.bfloat16, 128, 100, 0, 4096,
     "ffn"),                                                  # ffn % 8 != 0
    (torch.bfloat16, torch.bfloat16, 128, 512, 2, 4096, "ffn"),  # misaligned
    # the weight-streaming arm: float32 weights at N <= _FFN_STREAM_MAX_ROWS
    (torch.float32, torch.float32, 768, 3072, 0, 8,
     "ffn_stream"),                               # serving, generate decode
    (torch.float32, torch.float32, 768, 3072, 0, 1, "ffn_stream"),
    (torch.float32, torch.float32, 768, 3072, 0, _T, "ffn_stream"),
    (torch.float32, torch.float32, 768, 3072, 0, _T + 1, "ffn_tiled"),
    (torch.float32, torch.float32, 128, 512, 0, 8, "ffn_stream"),  # tiny
    (torch.float32, torch.float32, 96, 200, 0, 3, "ffn_stream"),
    (torch.bfloat16, torch.bfloat16, 768, 3072, 0, 8,
     "ffn_mma"),                                  # bf16 keeps the tensor cores
    (torch.bfloat16, torch.float32, 768, 3072, 0, 8, "ffn"),
    (torch.float32, torch.bfloat16, 768, 3072, 0, 8, "ffn"),
    (torch.float32, torch.float32, 768, 3070, 0, 8, "ffn"),  # ffn % 4 != 0
    (torch.float32, torch.float32, 766, 3072, 0, 8, "ffn"),  # h % 4 != 0
    (torch.float32, torch.float32, 1280, 5120, 0, 8,
     "ffn_tiled"),                                # h > 1024: tiled at any N
    (torch.float32, torch.float32, 768, 3072, 4, 8, "ffn"),  # misaligned
    (torch.float32, torch.float32, 768, 3072, 8, 8, "ffn"),
    (torch.float32, torch.float32, 32, 64, 0, 8,
     "ffn_tiled"),                                # one group's scratch > 5%
    (torch.float32, torch.float32, 32, 64, 0, 6, "ffn_stream"),
    # the register-blocked arm: float32 weights above the bound (or that
    # the stream kernel cannot take), h % 8 == 0, ffn % 4 == 0, aligned
    (torch.float32, torch.float32, 768, 3072, 0, 512,
     "ffn_tiled"),                                # serving's largest bucket
    (torch.float32, torch.float32, 768, 3072, 0, 128, "ffn_tiled"),
    (torch.float32, torch.float32, 128, 512, 0, 130, "ffn_tiled"),  # tiny
    (torch.float32, torch.float32, 128, 512, 0, _T + 1, "ffn_tiled"),
    (torch.float32, torch.float32, 96, 200, 0, 300, "ffn_tiled"),
    (torch.float32, torch.float32, 1280, 5120, 0, 512, "ffn_tiled"),
    (torch.float32, torch.float32, 100, 400, 0, 8,
     "ffn_stream"),                               # h % 8 != 0: stream rows
    (torch.float32, torch.float32, 100, 400, 0, 512, "ffn"),  # and SIMT
    (torch.float32, torch.float32, 768, 3070, 0, 512,
     "ffn"),                                      # ffn % 4 != 0
    (torch.float32, torch.float32, 768, 3072, 4, 512, "ffn"),  # misaligned
    (torch.float32, torch.float32, 768, 3072, 8, 4096, "ffn"),
    (torch.bfloat16, torch.float32, 768, 3072, 0, 512, "ffn"),
    (torch.float16, torch.float16, 768, 3072, 0, 512, "ffn"),
]


@pytest.mark.parametrize("w1dtype,w2dtype,h,ffn,offset,n,want", ROUTES)
def test_ffn_route(w1dtype, w2dtype, h, ffn, offset, n, want):
    # the host-side rule that sends a CUDA call to ffn_mma, ffn_stream or
    # ffn, from dtypes, shapes, addresses and the row count alone (CPU
    # tensors stand in for the card's: the rule reads no device)
    size = torch.empty((), dtype=w1dtype).element_size()
    flat = torch.zeros(h * ffn + offset // size, dtype=w1dtype)
    w1 = flat[offset // size:].view(h, ffn)
    w2 = torch.zeros(ffn, h, dtype=w2dtype)
    assert (w1.data_ptr() % 16 == 0) == (offset == 0)
    assert tfb.ffn_route(w1, w2, n) == want


@pytest.mark.parametrize("n,want", [(8, "ffn"), (512, "ffn")])
def test_ffn_route_refuses_a_misaligned_w2(n, want):
    # W2's rows move in 16-byte copies in both float32 routes
    w1 = torch.zeros(768, 3072)
    w2 = torch.zeros(768 * 3072 + 1)[1:].view(3072, 768)
    assert w2.data_ptr() % 16 and tfb.ffn_route(w1, w2, n) == want


def _weight(dtype, rows, cols, offset):
    """A (rows, cols) weight whose data starts ``offset`` bytes into a
    fresh buffer (CPU tensors stand in for the card's: the route rules
    read no device)."""
    size = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(rows * cols + offset // size, dtype=dtype)
    w = flat[offset // size:].view(rows, cols)
    assert (w.data_ptr() % 16 == 0) == (offset == 0)
    return w


_LN_T = tfb._LN_STREAM_MAX_ROWS

# (w dtype, h, cols, byte offset of w's data, rows N of x, route): a prefill
# bucket's 512 rows, then the decode rows and N around K1's stream bound
LN_LINEAR_ROUTES = [
    (torch.bfloat16, 768, 2304, 0, 512, "ln_linear_mma"),  # fused training
    (torch.bfloat16, 128, 384, 0, 512, "ln_linear_mma"),   # gpt_tiny
    (torch.bfloat16, 768, 200, 0, 512, "ln_linear_mma"),   # ragged col tile
    (torch.bfloat16, 128, 8, 0, 512, "ln_linear_mma"),
    (torch.float32, 768, 2304, 0, 512,
     "ln_linear_tiled"),                          # serving, generate prefill
    (torch.float16, 768, 2304, 0, 512, "ln_linear"),
    (torch.bfloat16, 64, 192, 0, 512, "ln_linear"),        # h not built
    (torch.bfloat16, 256, 768, 0, 512, "ln_linear"),
    (torch.bfloat16, 1024, 3072, 0, 512, "ln_linear"),
    (torch.bfloat16, 768, 100, 0, 512, "ln_linear"),       # cols % 8 != 0
    (torch.bfloat16, 768, 2304, 2, 512, "ln_linear"),      # misaligned
    (torch.bfloat16, 128, 384, 8, 512, "ln_linear"),
    (torch.bfloat16, 768, 2304, 0, 8,
     "ln_linear_mma"),                            # bf16 keeps the tensor cores
    # a float32 w: the stream kernel up to the bound, the tiled one above
    (torch.float32, 768, 2304, 0, 1, "ln_linear_stream"),
    (torch.float32, 768, 2304, 0, 8,
     "ln_linear_stream"),                         # serving, generate decode
    (torch.float32, 768, 2304, 0, _LN_T, "ln_linear_stream"),
    (torch.float32, 768, 2304, 0, _LN_T + 1, "ln_linear_tiled"),
    (torch.float32, 768, 2304, 0, 64, "ln_linear_tiled"),
    (torch.float32, 768, 2304, 0, 4096, "ln_linear_tiled"),
    (torch.float32, 128, 384, 0, 8, "ln_linear_stream"),   # gpt_tiny
    (torch.float32, 128, 384, 0, 130, "ln_linear_tiled"),
    (torch.float32, 96, 200, 0, 3, "ln_linear_stream"),
    (torch.float32, 1024, 3072, 0, 8, "ln_linear_stream"),
    (torch.float32, 1280, 3840, 0, 8,
     "ln_linear_tiled"),                          # h above the stream widths
    (torch.float32, 768, 3076, 0, 8, "ln_linear_tiled"),   # cols likewise
    (torch.float32, 100, 300, 0, 8, "ln_linear_stream"),
    (torch.float32, 100, 300, 0, 512,
     "ln_linear"),                                # h % 8 != 0: no tiled rows
    (torch.float32, 1284, 2304, 0, 8, "ln_linear"),
    (torch.float32, 768, 2304, 4, 8, "ln_linear"),         # misaligned
    (torch.float32, 768, 2304, 8, 4096, "ln_linear"),
    (torch.float32, 768, 2302, 0, 8, "ln_linear"),         # cols % 4 != 0
    (torch.float16, 768, 2304, 0, 8, "ln_linear"),
]


@pytest.mark.parametrize("wdtype,h,cols,offset,n,want", LN_LINEAR_ROUTES)
def test_ln_linear_route(wdtype, h, cols, offset, n, want):
    # the host-side rule that sends a CUDA call of K1 to ln_linear_mma,
    # ln_linear_stream, ln_linear_tiled or ln_linear, from w's dtype, shape
    # and address and the row count alone
    assert tfb.ln_linear_route(_weight(wdtype, h, cols, offset), n) == want


# (x dtype, w dtype, k, cols, byte offset of x's data, of w's data, rows
# N of x, route): a prefill bucket's 512 rows, then the decode rows and N
# around the stream kernel's bound, then the tiled kernel's rows and what
# it refuses
_RT = tfb._RESID_STREAM_MAX_ROWS
LINEAR_RESIDUAL_ROUTES = [
    (torch.bfloat16, torch.bfloat16, 768, 768, 0, 0, 512,
     "linear_residual_mma"),                              # fused training
    (torch.bfloat16, torch.bfloat16, 128, 128, 0, 0, 512,
     "linear_residual_mma"),                              # gpt_tiny
    (torch.bfloat16, torch.bfloat16, 768, 200, 0, 0, 512,
     "linear_residual_mma"),
    (torch.float32, torch.float32, 768, 768, 0, 0, 512,
     "linear_residual_tiled"),                   # serving, generate prefill
    (torch.float32, torch.bfloat16, 768, 768, 0, 0, 512, "linear_residual"),
    (torch.bfloat16, torch.float32, 768, 768, 0, 0, 512,
     "linear_residual_tiled"),                   # the cache dtype's x
    (torch.float16, torch.float16, 768, 768, 0, 0, 512, "linear_residual"),
    (torch.bfloat16, torch.bfloat16, 96, 96, 0, 0, 512,
     "linear_residual"),                                  # k not built
    (torch.bfloat16, torch.bfloat16, 512, 512, 0, 0, 512, "linear_residual"),
    (torch.bfloat16, torch.bfloat16, 768, 100, 0, 0, 512,
     "linear_residual"),                                  # cols % 8 != 0
    (torch.bfloat16, torch.bfloat16, 768, 768, 0, 2, 512,
     "linear_residual"),                                  # w misaligned
    (torch.bfloat16, torch.bfloat16, 768, 768, 2, 0, 512,
     "linear_residual"),                                  # x misaligned
    (torch.bfloat16, torch.bfloat16, 128, 128, 8, 0, 512, "linear_residual"),
    # the weight-streaming arm: a float32 w at N <= _RESID_STREAM_MAX_ROWS,
    # x and r of either dtype
    (torch.float32, torch.float32, 768, 768, 0, 0, 8,
     "linear_residual_stream"),                   # serving, generate decode
    (torch.float32, torch.float32, 768, 768, 0, 0, 1,
     "linear_residual_stream"),
    (torch.float32, torch.float32, 768, 768, 0, 0, _RT,
     "linear_residual_stream"),
    (torch.float32, torch.float32, 768, 768, 0, 0, _RT + 1,
     "linear_residual_tiled"),
    (torch.bfloat16, torch.float32, 768, 768, 2, 0, 8,
     "linear_residual_stream"),                   # x is read element-wise
    (torch.float32, torch.float32, 96, 200, 4, 0, 3,
     "linear_residual_stream"),
    (torch.bfloat16, torch.bfloat16, 768, 768, 0, 0, 8,
     "linear_residual_mma"),                      # bf16 keeps the tensor cores
    (torch.float32, torch.bfloat16, 768, 768, 0, 0, 8, "linear_residual"),
    (torch.float32, torch.float32, 768, 766, 0, 0, 8,
     "linear_residual"),                                  # cols % 4 != 0
    (torch.float32, torch.float32, 768, 768, 0, 4, 8,
     "linear_residual"),                                  # w misaligned
    (torch.float32, torch.float32, 2048, 768, 0, 0, 8,
     "linear_residual_tiled"),                # k > 1024: tiled at any N
    (torch.float32, torch.float32, 768, 2048, 0, 0, 8,
     "linear_residual_tiled"),                            # cols > 1024
    # the register-blocked arm: a float32 w above the bound (or that the
    # stream kernel cannot take), k % 8 == 0, cols % 4 == 0, w aligned; x
    # of either dtype at any address (a misaligned x is copied)
    (torch.float32, torch.float32, 768, 768, 0, 0, 4096,
     "linear_residual_tiled"),                            # generate prefill
    (torch.float32, torch.float32, 768, 768, 0, 0, 128,
     "linear_residual_tiled"),
    (torch.bfloat16, torch.float32, 768, 768, 2, 0, 512,
     "linear_residual_tiled"),
    (torch.float32, torch.float32, 128, 128, 0, 0, 130,
     "linear_residual_tiled"),                            # gpt_tiny
    (torch.float32, torch.float32, 96, 200, 4, 0, 300,
     "linear_residual_tiled"),
    (torch.float32, torch.float32, 100, 200, 0, 0, 8,
     "linear_residual_stream"),               # k % 8 != 0: stream rows
    (torch.float32, torch.float32, 100, 200, 0, 0, 512,
     "linear_residual"),                                  # and SIMT
    (torch.float32, torch.float32, 768, 766, 0, 0, 512,
     "linear_residual"),                                  # cols % 4 != 0
    (torch.float32, torch.float32, 768, 768, 0, 4, 512,
     "linear_residual"),                                  # w misaligned
    (torch.float16, torch.float32, 768, 768, 0, 8, 4096, "linear_residual"),
]


@pytest.mark.parametrize("xdtype,wdtype,k,cols,xoff,woff,n,want",
                         LINEAR_RESIDUAL_ROUTES)
def test_linear_residual_route(xdtype, wdtype, k, cols, xoff, woff, n, want):
    # the host-side rule that sends a CUDA call of K2 to linear_residual_mma,
    # linear_residual_stream or linear_residual, from x's and w's dtypes,
    # shapes and addresses
    x = _weight(xdtype, n, k, xoff)
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


# clusters of 1, 2, 4 and 8 blocks that a card holds at once, one block an
# SM: GPCs that all take whole clusters (132 SMs), and uneven ones that
# leave SMs over at 4 and 8 (as cudaOccupancyMaxActiveClusters may report)
RESIDENT = {"even": ((1, 132), (2, 66), (4, 33), (8, 16)),
            "uneven": ((1, 132), (2, 66), (4, 30), (8, 14)),
            "few": ((1, 114), (2, 57), (4, 26), (8, 12))}
# GPT-125M, gpt_tiny, a ragged small width and one whose scratch bounds
# the groups hard
FFN_WIDTHS = [(768, 3072), (128, 512), (96, 200), (64, 1000)]


@pytest.mark.parametrize("resident", sorted(RESIDENT))
@pytest.mark.parametrize("n", [1, 3, 8, 16, 32, 64])
@pytest.mark.parametrize("h,ffn", FFN_WIDTHS)
def test_ffn_stream_grid(resident, n, h, ffn):
    # ffn_stream's grid, a pure function of (the card's resident clusters,
    # N, h, ffn): every W1 column and W2 row lies in exactly one block,
    # every cluster has work, the blocks fit in shared memory, no cluster
    # exceeds what the card holds, and the scratch stays under 5% of the
    # weight bytes
    held = dict(RESIDENT[resident])
    grid = tfb._ffn_stream_grid(RESIDENT[resident], n, h, ffn)
    assert grid is not None
    cluster, groups, per, rows = grid
    assert cluster in held and cluster <= tfb._STREAM_MAX_CLUSTER
    assert per % 4 == 0 and 0 < per <= tfb._STREAM_MAX_PER
    blocks = -(-ffn // per)                  # the blocks that own columns
    owned = [set(range(b * per, min(ffn, (b + 1) * per)))
             for b in range(groups * cluster)]
    assert set().union(*owned) == set(range(ffn))
    assert sum(map(len, owned)) == ffn       # no column in two blocks
    assert (groups - 1) * cluster < blocks <= groups * cluster
    assert tfb._ffn_stream_smem(h, per) <= tfb._SMEM_LIMIT
    assert 0 < rows <= 16 and rows <= n
    scratch, weights = groups * rows * h * 4, 2 * h * ffn * 4
    assert scratch < 0.05 * weights
    if (h, ffn) == (768, 3072) and resident != "few":
        # GPT-125M on a 132-SM card: one wave of clusters over most of it
        assert groups <= held[cluster]
        assert blocks >= 110 and rows == min(n, 16)
    elif (h, ffn) == (768, 3072):
        # 114 SMs hold no grid whose share fits: two waves, not more
        assert groups <= 2 * held[cluster]


def test_ffn_stream_grid_at_decode():
    # at generate's and serving's decode step (8 rows, GPT-125M) on a card
    # whose GPCs take whole clusters: 16 clusters of 8 blocks of 24 ffn
    # columns, 128 blocks; the scratch is 2.1% of the 18.9 MB of weights
    assert tfb._ffn_stream_grid(RESIDENT["even"], 8, 768, 3072) == \
        (8, 16, 24, 8)
    assert tfb._ffn_stream_grid(RESIDENT["uneven"], 8, 768, 3072) == \
        (8, 14, 28, 8)
    # W1's 24 columns, W2's 24 rows, LN(x) of 8 rows, the activation
    assert tfb._ffn_stream_smem(768, 24) == 4 * (768 * 24 + 24 * 768
                                                 + 8 * 768 + 24 * 8)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [1, 8, 33, 64])
@pytest.mark.parametrize("k,cols", [(768, 768), (128, 128), (96, 200),
                                    (1024, 1024), (768, 20)])
def test_linear_residual_stream_grid(sms, n, k, cols):
    # linear_residual_stream's grid, a pure function of (SMs, N, k, cols):
    # every (depth row, column) of W lies in exactly one block's chunk, at
    # most one block an SM, clusters of at most 8, rows of 32 columns or
    # more where cols allows, and the blocks fit in shared memory
    grid = tfb._stream_gemm_grid(sms, n, k, cols)
    assert grid is not None
    cluster, width, depth = grid
    assert 1 <= cluster <= tfb._STREAM_MAX_CLUSTER
    assert width % 4 == 0 and width >= min(32, cols)
    tiles = -(-cols // width)
    assert (tiles - 1) * width < cols <= tiles * width
    assert (cluster - 1) * depth < k <= cluster * depth
    assert cluster * tiles <= sms
    assert tfb._stream_gemm_smem(n, width, depth) \
        <= tfb._SMEM_LIMIT
    if (k, cols) == (768, 768):
        assert cluster * tiles >= 0.9 * sms


def test_linear_residual_stream_grid_at_decode():
    # GPT-125M's out-projection at 8 rows on 132 SMs: 22 column tiles of 36
    # (144-byte rows) x 6 depth chunks of 128 rows, 132 blocks of 18 KB
    assert tfb._stream_gemm_grid(132, 8, 768, 768) == (6, 36, 128)


# K1's weight-streaming kernel takes the same grid (ln_linear_stream shares
# linear_residual_stream's body): (SMs, N, h, cols) -> (cluster, width,
# depth, blocks)
LN_STREAM_GRIDS = [
    # GPT-125M's QKV projection at the decode rows and at the bound: 22
    # tiles of 108 columns (432-byte rows) x 6 chunks of 128 rows
    ((132, 8, 768, 2304), (6, 108, 128, 132)),
    ((132, 64, 768, 2304), (6, 108, 128, 132)),
    # gpt_tiny (h = 128, 384 columns): 12 tiles of 32 x 8 chunks of 16
    ((132, 8, 128, 384), (8, 32, 16, 96)),
    ((114, 8, 768, 2304), (6, 124, 128, 114)),
]


@pytest.mark.parametrize("args,want", LN_STREAM_GRIDS)
def test_ln_linear_stream_grid(monkeypatch, args, want):
    # as the wrapper asks it, with the card's SM count monkeypatched
    sms, n, k, cols = args
    monkeypatch.setattr(_kernels, "sm_count", lambda device: sms)
    grid = tfb._stream_gemm_grid(_kernels.sm_count(torch.device("cpu")), n,
                                 k, cols)
    cluster, width, depth = grid
    assert (cluster, width, depth, cluster * -(-cols // width)) == want
    # W's chunk, LN(x) of the rows over the chunk's depth, the partial
    assert tfb._stream_gemm_smem(n, width, depth) == 4 * (
        depth * width + -(-n // 8) * 8 * depth + n * width)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("k,cols", [(1024, 3072), (1024, 20), (4, 3072),
                                    (96, 200), (768, 2304)])
def test_ln_linear_stream_width_rule(sms, n, k, cols):
    # every width the route sends to ln_linear_stream (h <= _STREAM_MAX_H,
    # cols <= _LN_STREAM_MAX_COLS) at every N up to the bound has a grid
    # of at most one block an SM that fits shared memory
    assert k <= tfb._STREAM_MAX_H and cols <= tfb._LN_STREAM_MAX_COLS
    cluster, width, depth = tfb._stream_gemm_grid(sms, n, k, cols)
    assert cluster * -(-cols // width) <= sms
    assert (cluster - 1) * depth < k <= cluster * depth
    assert tfb._stream_gemm_smem(n, width, depth) <= tfb._SMEM_LIMIT


# (SMs, N, h, cols, depth chunks): ln_linear_tiled's 64 x 128 tiles, split
# by depth over a cluster until the card has about two blocks an SM
TILED_SPLITS = [
    (132, 4096, 768, 2304, 1),     # generate's prefill: 1,152 tiles
    (132, 1024, 768, 2304, 1),     # 288 tiles
    (132, 512, 768, 2304, 2),      # serving's largest bucket: 144 tiles
    (132, 384, 768, 2304, 3),      # 108 tiles
    (132, 256, 768, 2304, 4),      # 72 tiles
    (132, 128, 768, 2304, 8),      # 36 tiles: at most a portable cluster
    (132, 33, 768, 2304, 8),       # the first N above the stream bound
    (114, 384, 768, 2304, 2),
    (132, 130, 128, 384, 2),       # gpt_tiny: at least 4 slabs of 16 a chunk
    (132, 512, 40, 200, 1),        # fewer than 4 slabs: no split
]


@pytest.mark.parametrize("sms,n,k,cols,want", TILED_SPLITS)
def test_ln_linear_tiled_splits(monkeypatch, sms, n, k, cols, want):
    monkeypatch.setattr(_kernels, "sm_count", lambda device: sms)
    got = tfb._tiled_splits(_kernels.sm_count(torch.device("cpu")), n, k,
                            cols)
    assert got == want
    tiles = -(-n // tfb._TILED_ROWS) * -(-cols // tfb._TILED_COLS)
    slabs = -(-k // tfb._TILED_DEPTH)
    # every chunk has depth to take, and the cluster is portable
    assert 1 <= got <= tfb._STREAM_MAX_CLUSTER and (got - 1) * -(
        -slabs // got) < slabs
    assert got == 1 or 2 * tiles * got <= 5 * sms
    # three blocks an SM at GPT-125M's h
    assert 3 * tfb._tiled_smem(768) <= tfb._SMEM_LIMIT


# (SMs, N, h, ffn, depth chunks of the up pass, of the down pass): K3's
# two tiled passes, each split by depth over a cluster by _tiled_splits
# (the up pass over h into ffn columns, the down pass over ffn into h)
FFN_TILED_SPLITS = [
    (132, 4096, 768, 3072, 1, 1),   # generate's prefill: 1,536 / 384 tiles
    (132, 1024, 768, 3072, 1, 3),
    (132, 512, 768, 3072, 1, 6),    # serving's largest bucket: 192 / 48
    (132, 256, 768, 3072, 3, 8),
    (132, 128, 768, 3072, 6, 8),
    (132, 65, 768, 3072, 6, 8),     # the first N above the stream bound
    (114, 512, 768, 3072, 1, 5),
    (132, 130, 128, 512, 2, 8),     # gpt_tiny: at least 4 slabs of 16
]


@pytest.mark.parametrize("sms,n,h,ffn,up,down", FFN_TILED_SPLITS)
def test_ffn_tiled_splits(sms, n, h, ffn, up, down):
    assert tfb._tiled_splits(sms, n, h, ffn) == up
    assert tfb._tiled_splits(sms, n, ffn, h) == down
    for k, cols, got in ((h, ffn, up), (ffn, h, down)):
        tiles = -(-n // tfb._TILED_ROWS) * -(-cols // tfb._TILED_COLS)
        slabs = -(-k // tfb._TILED_DEPTH)
        assert 1 <= got <= tfb._STREAM_MAX_CLUSTER
        assert (got - 1) * -(-slabs // got) < slabs
        assert got == 1 or 2 * tiles * got <= 5 * sms


# (SMs, N, k, cols, depth chunks): K2's tiled kernel
RESID_TILED_SPLITS = [
    (132, 4096, 768, 768, 1),       # generate's prefill: 384 tiles
    (132, 512, 768, 768, 6),        # serving's largest bucket: 48 tiles
    (132, 256, 768, 768, 8),
    (132, 65, 768, 768, 8),
    (114, 512, 768, 768, 5),
    (132, 130, 128, 128, 2),        # gpt_tiny: 8 slabs, 4 a chunk
    (132, 512, 40, 200, 1),         # fewer than 4 slabs: no split
]


@pytest.mark.parametrize("sms,n,k,cols,want", RESID_TILED_SPLITS)
def test_linear_residual_tiled_splits(sms, n, k, cols, want):
    assert tfb._tiled_splits(sms, n, k, cols) == want


def test_tiled_smem_formulas():
    # the wrappers check the libraries' counts against these (ptt_*_smem):
    # the raw body (K2, K3's down pass) is the LN body (K1, K3's up pass)
    # without the rows' statistics and g / beta; three blocks of either
    # fit an SM at GPT-125M's h, and the drained ring holds a tile's
    # float32 partial for the depth split
    raw = tfb._tiled_raw_smem()
    assert raw == 4 * (3 * 16 * 128 + 2 * 16 * 64 + 3 * 64 * 16) == 45056
    assert tfb._tiled_smem(768) == raw + 4 * (2 * 64 + 2 * 768)
    assert 3 * tfb._tiled_smem(768) <= tfb._SMEM_LIMIT
    assert 4 * (3 * 16 * 128 + 2 * 16 * 64) >= 4 * 64 * 128


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


# the decode rows of serving and generate, which the weight-streaming
# kernels take on the card: one row, and eight; float32 weights (as there)
# with a float32 or bf16 residual stream, with and without dropout
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drops", [(0.0, 0.0), (0.2, 0.4)])
def test_ffn_decode_rows_match_jax(route, n, xdtype, drops):
    x, p = _x(b=n, s=1, seed=12), _params(seed=12)
    d1, d2 = drops
    names = ("w1", "b1", "w2", "b2", "g", "beta")
    ref = jfb.fused_ffn_block(_j(x, xdtype), *[_j(p[k]) for k in names],
                              dropout1=d1, dropout2=d2, epsilon=EPS,
                              training=True, seed=jnp.asarray(17, jnp.int32))
    got = tfb.fused_ffn_block(_t(x, getattr(torch, xdtype)),
                              *[_t(p[k]) for k in names], dropout1=d1,
                              dropout2=d2, epsilon=EPS, training=True,
                              seed=17)
    assert got.shape == (n, 1, 128) and str(got.dtype) == f"torch.{xdtype}"
    tol = F32_TOL if xdtype == "float32" else _bf16_ulp_tol(
        np.asarray(ref, np.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=F32_TOL,
                               atol=tol)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("rdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_drop", [0.0, 0.3])
def test_linear_residual_decode_rows_match_jax(route, n, rdtype, p_drop):
    x, p, r = _x(b=n, s=1, seed=13), _params(seed=13), _x(b=n, s=1, seed=14)
    ref = jfb.fused_linear_residual(_j(x), _j(p["out_w"]), _j(p["out_b"]),
                                    _j(r, rdtype), dropout_p=p_drop,
                                    training=True,
                                    seed=jnp.asarray(19, jnp.int32))
    got = tfb.fused_linear_residual(_t(x), _t(p["out_w"]), _t(p["out_b"]),
                                    _t(r, getattr(torch, rdtype)),
                                    dropout_p=p_drop, training=True, seed=19)
    assert got.shape == (n, 1, 128) and str(got.dtype) == f"torch.{rdtype}"
    tol = F32_TOL if rdtype == "float32" else _bf16_ulp_tol(
        np.asarray(ref, np.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=F32_TOL,
                               atol=tol)


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
                                     "linear_residual_mma", "ffn_stream",
                                     "ffn_simt", "linear_residual_stream",
                                     "linear_residual_simt",
                                     "ln_linear_stream", "ln_linear_tiled",
                                     "ln_linear_simt", "ffn_tiled",
                                     "linear_residual_tiled"])
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
                x.bfloat16(), p["out_w"].bfloat16(), p["out_b"], x),
            "ffn_stream": lambda: tfb.ffn_stream_cuda(
                x[:8], p["w1"], p["b1"], p["w2"], p["b2"], p["g"],
                p["beta"]),
            "ffn_simt": lambda: tfb.ffn_simt_cuda(
                x, p["w1"], p["b1"], p["w2"], p["b2"], p["g"], p["beta"]),
            "linear_residual_stream": lambda: tfb.linear_residual_stream_cuda(
                x[:8], p["out_w"], p["out_b"], x[:8]),
            "linear_residual_simt": lambda: tfb.linear_residual_simt_cuda(
                x, p["out_w"], p["out_b"], x),
            "ln_linear_stream": lambda: tfb.ln_linear_stream_cuda(
                x[:8], p["qkv_w"], p["qkv_b"], p["g"], p["beta"], EPS),
            "ln_linear_tiled": lambda: tfb.ln_linear_tiled_cuda(
                x, p["qkv_w"], p["qkv_b"], p["g"], p["beta"], EPS),
            "ln_linear_simt": lambda: tfb.ln_linear_simt_cuda(
                x, p["qkv_w"], p["qkv_b"], p["g"], p["beta"], EPS),
            "ffn_tiled": lambda: tfb.ffn_tiled_cuda(
                x, p["w1"], p["b1"], p["w2"], p["b2"], p["g"], p["beta"]),
            "linear_residual_tiled": lambda: tfb.linear_residual_tiled_cuda(
                x, p["out_w"], p["out_b"], x)}[wrapper]
    with pytest.raises(ValueError, match="must be on"):
        call()
