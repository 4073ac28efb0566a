"""The port's ``linalg``, ``fft`` and ``signal`` against the JAX package's
on the CPU, on the same seeded float32 numpy inputs.

Tolerances: 1e-4 relative and absolute for the factorizations and
solves (float32 LAPACK in both, in different orders), 1e-5 for the FFTs
and framing.  Decompositions whose factors are not unique (``eig``,
``eigh``, ``svd``, ``qr``) are held by reconstruction and invariants:
``V diag(w) V^-1``, ``U diag(S) Vh``, ``QR``, orthonormality, eigenvalue
sets; never factor by factor.  Where JAX, without x64, truncates an asked
int64 / float64 to 32 bits, the port returns what was asked (pinned
once)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework import dtype as fw_dtype
from paddle_tpu_torch.framework.errors import EnforceNotMet

TOL = dict(rtol=1e-4, atol=1e-4)
FTOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with fw_dtype.device_scope("cpu"):
        yield


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(seed, n=4, batch=()):
    a = _r(seed, *batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _np(x):
    return fw_dtype.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pair(name, *args, mod="linalg", ctol=TOL, **kw):
    got = getattr(getattr(tpt, mod) if mod else tpt, name)(
        *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    want = getattr(getattr(jpt, mod) if mod else jpt, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **ctol)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **ctol)
    return got


# -- linalg ----------------------------------------------------------------------
@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_and_cholesky_solve(upper):
    a = _spd(0)
    _pair("cholesky", a, upper=upper)
    factor = np.asarray(jpt.linalg.cholesky(jnp.asarray(a), upper=upper))
    _pair("cholesky_solve", _r(1, 4, 2), factor, upper=upper)


@pytest.mark.parametrize("name", ["det", "slogdet", "inv"])
def test_det_slogdet_inv_batched(name):
    _pair(name, _spd(2, batch=(3,)))


@pytest.mark.parametrize("b_shape", [(4, 2), (4,)])
def test_solve(b_shape):
    _pair("solve", _spd(3), _r(4, *b_shape))


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_triangular_solve(upper, transpose, unit):
    a = _r(5, 4, 4) + 4 * np.eye(4, dtype=np.float32)
    a = np.triu(a) if upper else np.tril(a)
    _pair("triangular_solve", a, _r(6, 4, 3), upper=upper,
          transpose=transpose, unitriangular=unit)


def test_multi_dot_matrix_power_pinv():
    _pair("multi_dot", [_r(7, 2, 3), _r(8, 3, 5), _r(9, 5, 2)])
    a = _spd(10)
    for n in (0, 1, 3, -2):
        _pair("matrix_power", a / 4, n, ctol=dict(rtol=1e-3, atol=1e-3))
    _pair("pinv", a, hermitian=True, ctol=dict(rtol=1e-3, atol=1e-3))
    _pair("pinv", _r(11, 5, 3), ctol=dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("shape", [(6, 3), (3, 6)])
def test_lstsq_all_four_outputs(shape):
    a, b = _r(12, *shape), _r(13, shape[0], 2)
    got = tpt.linalg.lstsq(torch.as_tensor(a), torch.as_tensor(b))
    want = jpt.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("driver", ["gels", "gelsd"])
def test_lstsq_ignores_driver_as_the_jax_package_does(driver):
    a, b = torch.as_tensor(_r(12, 6, 3)), torch.as_tensor(_r(13, 6, 2))
    for g, w in zip(tpt.linalg.lstsq(a, b, driver=driver),
                    tpt.linalg.lstsq(a, b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_lu_pivots_are_one_based_and_unpack():
    a = _r(14, 2, 4, 4)
    lu_t, piv_t, info = tpt.linalg.lu(torch.as_tensor(a), get_infos=True)
    lu_j, piv_j = jpt.linalg.lu(jnp.asarray(a))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    assert int(piv_t.min()) >= 1 and info.tolist() == [0, 0]
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(lu_j), **TOL)
    p, l, u = tpt.linalg.lu_unpack(lu_t, piv_t)
    np.testing.assert_allclose((p @ l @ u).numpy(), a, **TOL)
    for g, w in zip((p, l, u), jpt.linalg.lu_unpack(lu_j, piv_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tpt.linalg.lu_unpack(lu_t, piv_t, unpack_pivots=False)[0] is None
    assert tpt.linalg.lu_unpack(lu_t, piv_t, unpack_ludata=False)[1] is None


def test_matrix_rank():
    low = np.outer(_r(15, 5), _r(16, 5)) + np.outer(_r(17, 5), _r(18, 5))
    _pair("matrix_rank", low.astype(np.float32), ctol=dict(rtol=0, atol=0))
    _pair("matrix_rank", low.astype(np.float32), tol=1e-3)
    sym = np.diag([3.0, -2.0, 0.0, 1e-9]).astype(np.float32)
    _pair("matrix_rank", sym, hermitian=True)
    _pair("matrix_rank", sym, tol=0.5, hermitian=True)
    _pair("matrix_rank", np.stack([sym, np.eye(4, dtype=np.float32)]),
          tol=np.array([0.5, 2.0], np.float32), hermitian=True)


@pytest.mark.parametrize("p", [None, 2, -2, "fro", "nuc", 1, np.inf])
def test_cond(p):
    _pair("cond", _spd(19), p, ctol=dict(rtol=1e-3, atol=1e-3))


def test_cov_and_corrcoef():
    x = _r(20, 3, 8)
    _pair("cov", x)
    _pair("cov", x.T, rowvar=False, ddof=False)
    _pair("cov", x, fweights=np.array([1, 2, 1, 3, 1, 1, 2, 1]),
          aweights=np.linspace(0.5, 1.5, 8).astype(np.float32))
    _pair("corrcoef", x)
    _pair("corrcoef", x.T, rowvar=False)


@pytest.mark.parametrize("kw", [
    dict(), dict(p="fro"), dict(p=1), dict(p=np.inf), dict(keepdim=True),
    dict(p=2, axis=1), dict(p=1, axis=-1, keepdim=True),
    dict(p="fro", axis=(0, 1)), dict(p="nuc", axis=[1, 2]),
    dict(p=2, axis=(1, 2))])
def test_linalg_norm(kw):
    _pair("norm", _r(21, 2, 3, 4), **kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(p=1), dict(keepdim=True), dict(axis=1), dict(axis=[0, 1]),
    dict(p=np.inf, axis=0)])
def test_top_level_norm(kw):
    _pair("norm", _r(22, 3, 4), mod=None, **kw)


def test_eigh_by_reconstruction():
    a = _spd(23, 5)
    w, v = tpt.linalg.eigh(torch.as_tensor(a))
    jw, _ = jpt.linalg.eigh(jnp.asarray(a))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose((v @ torch.diag(w) @ v.T).numpy(), a,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose((v.T @ v).numpy(), np.eye(5), atol=1e-5)
    _pair("eigvalsh", a, UPLO="U")


def test_eig_by_reconstruction():
    a = _r(24, 4, 4)
    w, v = tpt.linalg.eig(torch.as_tensor(a))
    jw = np.asarray(jpt.linalg.eigvals(jnp.asarray(a)))
    np.testing.assert_allclose(np.sort_complex(w.numpy()),
                               np.sort_complex(jw), **TOL)
    at = torch.as_tensor(a).to(torch.complex64)
    np.testing.assert_allclose((at @ v).numpy(), (v * w).numpy(), **TOL)
    np.testing.assert_allclose(
        np.sort_complex(tpt.linalg.eigvals(torch.as_tensor(a)).numpy()),
        np.sort_complex(jw), **TOL)


@pytest.mark.parametrize("full", [False, True])
def test_svd_by_reconstruction(full):
    a = _r(25, 5, 3)
    u, s, vh = tpt.linalg.svd(torch.as_tensor(a), full_matrices=full)
    _, js, _ = jpt.linalg.svd(jnp.asarray(a), full_matrices=full)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose((u[:, :3] * s @ vh[:3]).numpy(), a, **TOL)
    assert tuple(u.shape) == ((5, 5) if full else (5, 3))


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_by_reconstruction(mode):
    a = _r(26, 5, 3)
    out = tpt.linalg.qr(torch.as_tensor(a), mode=mode)
    jout = jpt.linalg.qr(jnp.asarray(a), mode=mode)
    r = out if mode == "r" else out[1]
    jr = jout if mode == "r" else jout[1]
    np.testing.assert_allclose(np.abs(np.diag(r.numpy())),
                               np.abs(np.diag(np.asarray(jr))), **TOL)
    if mode != "r":
        q = out[0]
        np.testing.assert_allclose((q @ r).numpy(), a, **TOL)
        np.testing.assert_allclose((q.T @ q).numpy(), np.eye(q.shape[1]),
                                   atol=1e-5)


def test_inverse_and_half_precision_factorizations():
    a = _spd(27)
    _pair("inverse", a, mod=None)
    # bf16 in, factored in float32, bf16 out
    inv = tpt.linalg.inv(torch.as_tensor(a).to(torch.bfloat16))
    assert inv.dtype == torch.bfloat16
    np.testing.assert_allclose(inv.float().numpy(), np.linalg.inv(a),
                               rtol=0.05, atol=0.01)


# -- fft -------------------------------------------------------------------------
_C = _r(28, 4, 6) + 1j * _r(29, 4, 6)


@pytest.mark.parametrize("name,arg,kw", [
    (name, arg, kw)
    for name, arg in [("fft", _C), ("ifft", _C), ("rfft", _r(30, 4, 6)),
                      ("irfft", _C), ("hfft", _C), ("ihfft", _r(31, 4, 6))]
    for kw in (dict(), dict(n=8, axis=0, norm="ortho"),
               dict(n=5, norm="forward"))] + [
    (name, arg, kw)
    for name, arg in [("fft2", _C), ("ifft2", _C), ("rfft2", _r(32, 3, 4, 6)),
                      ("irfft2", _C), ("fftn", _C), ("ifftn", _C),
                      ("rfftn", _r(33, 3, 4, 6)), ("irfftn", _C),
                      ("hfft2", _C), ("ihfft2", _r(34, 4, 6)),
                      ("hfftn", _C), ("ihfftn", _r(35, 3, 4, 6))]
    for kw in (dict(), dict(s=(4, 8), norm="ortho"),
               dict(axes=(0, -1), norm="forward"))] + [
    ("fftshift", _r(36, 4, 5), dict()), ("ifftshift", _r(37, 4, 5), dict()),
    ("fftshift", _r(38, 4, 5), dict(axes=(1,))),
    ("ifftshift", _r(39, 4, 5), dict(axes=[0]))])
def test_fft_functions_match_jax(name, arg, kw):
    if "axes" in kw and name.endswith("n") and np.ndim(arg) == 2:
        kw = dict(kw, axes=(0, 1))
    _pair(name, arg.astype(np.complex64 if np.iscomplexobj(arg)
                           else np.float32), mod="fft", ctol=FTOL, **kw)


@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
def test_fftfreq_dtype(name):
    _pair(name, 8, 0.5, mod="fft", ctol=FTOL)
    got = getattr(tpt.fft, name)(9, 0.1, dtype="float64")
    want = getattr(jpt.fft, name)(9, 0.1, dtype="float64")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # by design: the port returns the float64 that was asked for; JAX
    # without x64 truncates it to float32
    assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float32


def test_fft_covers_the_jax_functions():
    names = [n for n in jpt.fft.__all__] + ["hfft2", "ihfft2", "hfftn",
                                            "ihfftn"]
    assert len(set(names)) == 22
    assert all(callable(getattr(tpt.fft, n)) for n in names)


# -- signal ----------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, -1])
def test_frame_and_overlap_add(axis):
    x = _r(40, 3, 20) if axis == -1 else _r(40, 20, 3)
    fr = _pair("frame", x, 6, 3, axis=axis, mod="signal", ctol=FTOL)
    _pair("overlap_add", fr.numpy(), 3, axis=axis, mod="signal", ctol=FTOL)


@pytest.mark.parametrize("kw", [
    dict(n_fft=16), dict(n_fft=16, hop_length=5, center=False),
    dict(n_fft=16, hop_length=4, pad_mode="constant"),
    dict(n_fft=16, hop_length=4, pad_mode="edge", normalized=True),
    dict(n_fft=16, hop_length=4, win_length=10, window="hann"),
    dict(n_fft=12, hop_length=3, onesided=False),
    dict(n_fft=16, hop_length=4, pad_mode="symmetric")])
def test_stft_matches_jax(kw):
    kw = dict(kw)
    if kw.get("window") == "hann":
        n = kw["win_length"]
        kw["window"] = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
                        ).astype(np.float32)
    _pair("stft", _r(41, 2, 64), mod="signal", ctol=FTOL, **kw)


def test_stft_complex_input():
    x = (_r(42, 48) + 1j * _r(43, 48)).astype(np.complex64)
    _pair("stft", x, 16, 4, onesided=False, mod="signal", ctol=FTOL)


@pytest.mark.parametrize("kw", [dict(), dict(length=60),
                                dict(length=70), dict(normalized=True),
                                dict(center=False)])
def test_istft_round_trip_and_jax(kw):
    x = _r(44, 2, 64)
    n_fft, hop = 16, 4
    w = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
         ).astype(np.float32) + 0.1
    spec = tpt.signal.stft(torch.as_tensor(x), n_fft, hop, window=w,
                           center=kw.get("center", True),
                           normalized=kw.get("normalized", False))
    got = _pair("istft", spec.numpy(), n_fft, hop, window=w, mod="signal",
                ctol=FTOL, **kw)
    n = got.shape[-1] if kw.get("center", True) is False else min(
        got.shape[-1], 64)
    if kw.get("center", True):
        np.testing.assert_allclose(got[..., :n].numpy(), x[..., :n],
                                   rtol=1e-5, atol=1e-5)


def test_stft_gradient_is_finite():
    x = torch.as_tensor(_r(45, 64)).requires_grad_(True)
    y = tpt.log1p(tpt.abs(tpt.signal.stft(x, 16, 4)) ** 2).sum()
    y.backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("call", [
    lambda m: m.signal.frame(m.to_tensor(np.zeros(8, np.float32)), 4, 0),
    lambda m: m.signal.frame(m.to_tensor(np.zeros(8, np.float32)), 9, 2),
    lambda m: m.signal.frame(m.to_tensor(np.zeros(8, np.float32)), 4, 2,
                             axis=1),
    lambda m: m.signal.stft(m.to_tensor(np.zeros(32, np.float32)), 16, 0),
    lambda m: m.signal.stft(m.to_tensor(np.zeros(32, np.float32)), 16,
                            win_length=20),
    lambda m: m.signal.stft(m.to_tensor(np.zeros(32, np.complex64)), 16),
    lambda m: m.signal.istft(m.to_tensor(np.zeros((9, 3), np.complex64)),
                             16, 4, return_complex=True),
    lambda m: m.signal.istft(m.to_tensor(np.zeros((9, 3), np.complex64)),
                             16, 16, window=np.zeros(16, np.float32)),
])
def test_signal_errors_match_jax(call):
    with pytest.raises(EnforceNotMet) as te:
        call(tpt)
    with pytest.raises(Exception) as je:
        call(jpt)
    assert str(te.value) == str(je.value)
