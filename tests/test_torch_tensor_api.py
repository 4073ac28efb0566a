"""The port's top-level paddle namespace (``paddle_tpu_torch/__init__.py``,
``tensor_ops.py``) against the JAX package's on the CPU: creation and the
default dtype, the device rule, the ops and options the registry does not
sweep, the random ops by their statistics, the in-place forms and the
top-level helpers, each by-design difference pinned.

Values: float32 1e-6 relative and absolute (the same arithmetic), integer
and boolean results exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework import dtype as fw_dtype
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.framework.errors import UnavailableError


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's current device is the CPU for these tests (restored, as
    is the default float dtype)."""
    dflt = fw_dtype._default_float
    with fw_dtype.device_scope("cpu"):
        yield
    fw_dtype._default_float = dflt


def _np(x):
    if isinstance(x, torch.Tensor):
        return fw_dtype.to_numpy(x)
    return np.asarray(x)


def _same(got, want, rtol=1e-6, atol=1e-6):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol, atol)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


X = _r(0, 3, 4)
I = np.array([[1, 0, 3], [2, 2, 1]], np.int64)
DUP = np.array([3.0, 1.0, 2.0, 3.0, 1.0, 3.0], np.float32)

# (id, call on a namespace, inputs): each call runs on both packages with
# its numpy inputs as the package's arrays
CASES = [
    ("sum_dtype_keepdim", lambda m, x: m.sum(x, axis=[0, 1], keepdim=True),
     [X]),
    ("sum_all_keepdim", lambda m, x: m.sum(x, keepdim=True), [X]),
    ("mean_axes", lambda m, x: m.mean(x, axis=(0, 1)), [X]),
    ("max_keepdim", lambda m, x: m.max(x, axis=1, keepdim=True), [X]),
    ("min_all", lambda m, x: m.min(x), [X]),
    ("prod_axes", lambda m, x: m.prod(x, axis=[0, 1]), [X]),
    ("std_biased", lambda m, x: m.std(x, axis=0, unbiased=False), [X]),
    ("var_all", lambda m, x: m.var(x), [X]),
    ("argmax_all_keepdim", lambda m, x: m.argmax(x, keepdim=True), [X]),
    ("argmin_axis", lambda m, x: m.argmin(x, axis=0), [X]),
    ("argsort_desc", lambda m, x: m.argsort(x, axis=0, descending=True),
     [DUP]),
    ("sort_desc", lambda m, x: m.sort(x, descending=True), [DUP]),
    ("topk_smallest", lambda m, x: m.topk(x, 2, axis=1, largest=False)[0],
     [X]),
    ("topk_axis0", lambda m, x: m.topk(x, 2, axis=0), [X]),
    ("cumsum_all", lambda m, x: m.cumsum(x), [X]),
    ("cumprod_all", lambda m, x: m.cumprod(x), [X]),
    ("clip_one_side", lambda m, x: m.clip(x, min=0.1), [X]),
    ("clip_none", lambda m, x: m.clip(x), [X]),
    ("all_axes", lambda m, x: m.all(x > -1, axis=[0, 1]), [X]),
    ("any_keepdim", lambda m, x: m.any(x > 1, axis=0, keepdim=True), [X]),
    ("matmul_transpose", lambda m, x: m.matmul(x, x, transpose_y=True), [X]),
    ("t_1d", lambda m, x: m.t(x[0]), [X]),
    ("einsum_trace", lambda m, x: m.einsum("ii->", x[:, :3]), [X]),
    ("diag_offset", lambda m, x: m.diag(x, offset=1), [X]),
    ("tril_k", lambda m, x: m.tril(x, -1), [X]),
    ("reshape_minus1", lambda m, x: m.reshape(x, [2, -1]), [X]),
    ("transpose_3d", lambda m, x: m.transpose(x.reshape(2, 3, 2),
                                              (2, 0, 1)), [X]),
    ("squeeze_all", lambda m, x: m.squeeze(x.reshape(1, 3, 1, 4)), [X]),
    ("unsqueeze_list", lambda m, x: m.unsqueeze(x, [0, -1]), [X]),
    ("split_sections", lambda m, x: m.split(x, [1, -1, 1], axis=1), [X]),
    ("split_even", lambda m, x: m.split(x, 2, axis=1), [X]),
    ("chunk", lambda m, x: m.chunk(x, 3), [X]),
    ("flip_list", lambda m, x: m.flip(x, [0, 1]), [X]),
    ("roll_flat", lambda m, x: m.roll(x, 5), [X]),
    ("flatten_range", lambda m, x: m.flatten(x.reshape(2, 3, 2), 1, 2), [X]),
    ("gather_2d_index", lambda m, x, i: m.gather(x, i, axis=1), [X, I]),
    ("gather_nd_full", lambda m, x, i: m.gather_nd(x, i[:, :2]), [X, I]),
    ("scatter_add_mode", lambda m, x: m.scatter(
        x, np.array([0, 2, 0]), np.ones((3, 4), np.float32),
        overwrite=False), [X]),
    ("masked_select", lambda m, x: m.masked_select(x, x > 0), [X]),
    ("where_one_arg", lambda m, x: m.where(x > 0), [X]),
    ("nonzero", lambda m, x: m.nonzero(x > 0.5), [X]),
    ("unique_all", lambda m, x: m.unique(x, return_index=True,
                                         return_inverse=True,
                                         return_counts=True), [DUP]),
    ("unique_2d_inverse", lambda m, x: m.unique(
        x.reshape(2, 3), return_inverse=True), [DUP]),
    ("cast", lambda m, x: m.cast(x, "int32"), [X]),
    ("assign", lambda m, x: m.assign(x), [X]),
    ("clone", lambda m, x: m.clone(x), [X]),
    ("allclose", lambda m, x: m.allclose(x, x + 1e-7), [X]),
    ("equal_all_shape", lambda m, x: m.equal_all(x, x[:2]), [X]),
    ("equal_all", lambda m, x: m.equal_all(x, x + 0), [X]),
    ("stop_gradient", lambda m, x: m.stop_gradient(x), [X]),
    ("add_scalar", lambda m, x: m.add(x, 2.0), [X]),
    ("pow_scalar", lambda m, x: m.pow(m.abs(x), 0.5), [X]),
    ("divide_int", lambda m, a: m.divide(a, a + 1), [I]),
    ("floor_divide_neg", lambda m, x: m.floor_divide(x, -0.7), [X]),
    ("mod_neg", lambda m, x: m.mod(x, -0.7), [X]),
    ("remainder", lambda m, x: m.remainder(x, 0.7), [X]),
    ("logical_not", lambda m, x: m.logical_not(x > 0), [X]),
    # tensor_ops beyond the registry's cases
    ("amax_axes_keepdim", lambda m, x: m.amax(x, axis=(0, 1),
                                              keepdim=True), [X]),
    ("logsumexp_all", lambda m, x: m.logsumexp(x), [X]),
    ("logsumexp_keepdim", lambda m, x: m.logsumexp(x, axis=0, keepdim=True),
     [X]),
    ("logcumsumexp_flat", lambda m, x: m.logcumsumexp(x), [X]),
    ("nanmedian_all", lambda m, x: m.nanmedian(x), [X]),
    ("median_even", lambda m, x: m.median(x, axis=1, keepdim=True), [X]),
    ("quantile_many", lambda m, x: m.quantile(x, [0.1, 0.9], axis=0), [X]),
    ("scale_before", lambda m, x: m.scale(x, 3.0, 1.0,
                                          bias_after_scale=False), [X]),
    ("scale_act", lambda m, x: m.scale(x, 2.0, act="relu"), [X]),
    ("trace_offset", lambda m, x: m.trace(x, offset=1), [X]),
    ("diff_prepend", lambda m, x: m.diff(x, n=2, axis=0,
                                         prepend=x[:1]), [X]),
    ("logit_eps", lambda m, x: m.logit(m.sigmoid(x), eps=0.3), [X]),
    ("lerp_tensor_weight", lambda m, x: m.lerp(x, x * 2, x), [X]),
    ("as_complex_real", lambda m, x: m.as_real(m.as_complex(
        x.reshape(6, 2))), [X]),
    ("as_real_of_real", lambda m, x: m.as_real(x), [X]),
    ("imag_of_real", lambda m, x: m.imag(x), [X]),
    ("cross_axis", lambda m, x: m.cross(x[:, :3], x[:, 1:], axis=1), [X]),
    ("dist_inf", lambda m, x: m.dist(x, x * 0.5, p=float("inf")), [X]),
    ("dist_zero", lambda m, x: m.dist(x, m.abs(x), p=0), [X]),
    ("histogram_auto", lambda m, x: m.histogram(x, bins=4), [X]),
    ("bincount_weights", lambda m, i: m.bincount(
        i.reshape(-1), weights=np.arange(6, dtype=np.float32),
        minlength=6), [I]),
    ("tensordot_pairs", lambda m, x: m.tensordot(x, x, axes=([0], [0])),
     [X]),
    ("matrix_transpose", lambda m, x: m.matrix_transpose(x), [X]),
    ("broadcast_tensors", lambda m, x: m.broadcast_tensors(
        [x, x[:1]]), [X]),
    ("diagflat_offset", lambda m, x: m.diagflat(x[0], offset=-1), [X]),
    ("expand_as", lambda m, x: m.expand_as(x[:1], x), [X]),
    ("meshgrid_list", lambda m, x: m.meshgrid([x[0], x[1, :2]]), [X]),
    ("put_along_axis_add", lambda m, x, i: m.put_along_axis(
        x, i[:, :2] % 4, 1.0, axis=1, reduce="add"), [X, I]),
    ("put_along_axis_mul", lambda m, x, i: m.put_along_axis(
        x, i[:, :1] % 4, 3.0, axis=1, reduce="mul"), [X, I]),
    ("repeat_interleave_flat", lambda m, x: m.repeat_interleave(x, 2), [X]),
    ("rot90_k", lambda m, x: m.rot90(x, k=-1, axes=[1, 0]), [X]),
    ("unique_consecutive", lambda m, x: m.unique_consecutive(
        x, return_inverse=True, return_counts=True),
     [np.array([1, 1, 2, 2, 2, 1, 3], np.int64)]),
    ("as_strided", lambda m, x: m.as_strided(x, [2, 3], [4, 1], 1), [X]),
    ("view_shape", lambda m, x: m.view(x, [4, 3]), [X]),
    ("kthvalue_keepdim", lambda m, x: m.kthvalue(x, 2, axis=0,
                                                 keepdim=True), [X]),
    ("mode_ties", lambda m, x: m.mode(x, axis=1),
     [np.array([[1, 2, 2, 1, 3], [4, 4, 1, 1, 1]], np.float32)]),
    ("searchsorted_right", lambda m, s, v: m.searchsorted(
        s, v, out_int32=True, right=True),
     [np.array([1.0, 2.0, 2.0, 3.0], np.float32),
      np.array([2.0, 0.5, 3.5], np.float32)]),
    ("isclose_nan", lambda m, x: m.isclose(x, x, equal_nan=True),
     [np.array([1.0, np.nan], np.float32)]),
    ("unstack", lambda m, x: m.unstack(x, axis=1), [X]),
    ("rank", lambda m, x: m.rank(x), [X]),
    ("is_empty", lambda m, x: m.is_empty(x[:0]), [X]),
    ("increment", lambda m, x: m.increment(x[:1, :1], 2.0), [X]),
    ("reverse_int", lambda m, x: m.reverse(x, 0), [X]),
    ("slice_clamped", lambda m, x: m.slice(x, [0, 1], [-2, 1], [99, -1]),
     [X]),
    ("strided_slice_negative", lambda m, x: m.strided_slice(
        x, [1], [-1], [-5], [-2]), [X]),
    ("strided_slice_neg_end", lambda m, x: m.strided_slice(
        x, [0, 1], [2, 3], [-9, 0], [-1, -2]), [X]),
    ("crop_default", lambda m, x: m.crop(x), [X]),
    ("shard_index", lambda m, i: m.shard_index(i, 4, 2, 1), [I]),
    ("scatter_nd", lambda m, x: m.scatter_nd(
        np.array([[0, 1], [2, 3], [0, 1]]), x[0, :3], [3, 4]), [X]),
    ("add_n_one", lambda m, x: m.add_n(x), [X]),
    ("empty_like_shape", lambda m, x: m.empty_like(x).shape, [X]),
    ("inverse", lambda m, x: m.inverse(x[:, :3] + 3 * np.eye(
        3, dtype=np.float32)), [X]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, call, inputs = case
    got = call(tpt, *[torch.as_tensor(a) for a in inputs])
    want = call(jpt, *[jnp.asarray(a) for a in inputs])
    if isinstance(want, tuple) and not hasattr(want, "shape") and all(
            isinstance(w, int) for w in want):
        assert tuple(got) == want
        return
    _same(got, want, rtol=1e-5, atol=1e-5)


def test_int64_results_where_jax_truncates_to_int32():
    # by design: the port returns the int64 paddle asks for; the JAX
    # package runs without x64 and gives int32 (values compared above)
    x = np.array([[3.0, 1.0], [0.0, 2.0]], np.float32)
    for name in ("argmax", "argsort", "nonzero"):
        got = getattr(tpt, name)(torch.as_tensor(x))
        want = getattr(jpt, name)(jnp.asarray(x))
        assert got.dtype == torch.int64 and want.dtype == jnp.int32, name
    assert tpt.arange(3).dtype == torch.int64
    assert jpt.arange(3).dtype == jnp.int32
    assert tpt.to_tensor(np.zeros(2)).dtype == torch.float64
    assert jpt.to_tensor(np.zeros(2)).dtype == jnp.float32


def test_repeated_indices_write_the_last_value_as_numpy():
    # a repeated index: the last write in C order wins (numpy's rule, and
    # the JAX package's on the CPU); the port keeps it on the card too
    idx = np.array([[1, 1, 2], [0, 0, 0], [4, 3, 4]])
    vals = np.arange(9, dtype=np.float32).reshape(3, 3)
    want = np.zeros((3, 5), np.float32)
    np.put_along_axis(want, idx, vals, 1)
    got = tpt.put_along_axis(torch.zeros(3, 5), torch.as_tensor(idx),
                             torch.as_tensor(vals), 1)
    _same(got, want)
    _same(got, jpt.put_along_axis(jnp.zeros((3, 5)), jnp.asarray(idx),
                                  jnp.asarray(vals), 1))
    rows = np.array([1, 3, 1])
    upd = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = np.zeros((4, 2), np.float32)
    want[rows] = upd
    _same(tpt.scatter(torch.zeros(4, 2), rows, torch.as_tensor(upd)), want)
    _same(tpt.scatter(torch.zeros(4, 2), rows, torch.as_tensor(upd)),
          jpt.scatter(jnp.zeros((4, 2)), rows, jnp.asarray(upd)))


# -- creation --------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("zeros", ([2, 3],)), ("ones", (4,)), ("full", ((2, 2), 7)),
    ("eye", (3, 4)), ("linspace", (0.0, 1.0, 5)), ("arange", (1, 7, 2)),
    ("arange", (0.0, 1.0, 0.25)), ("empty", ((3, 2),))])
def test_creation_matches_jax(name, args):
    got = getattr(tpt, name)(*args)
    want = getattr(jpt, name)(*args)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.device.type == "cpu"
    if name != "empty":
        _same(got, want)
    if name != "arange":
        assert got.dtype == torch.float32


@pytest.mark.parametrize("name", ["zeros_like", "ones_like", "full_like"])
def test_like_creation_keeps_dtype(name):
    i = torch.arange(4, dtype=torch.int32)
    args = (3,) if name == "full_like" else ()
    assert getattr(tpt, name)(i, *args).dtype == torch.int32
    assert getattr(tpt, name)(i, *args, dtype="float64").dtype \
        == torch.float64


def test_default_dtype():
    assert tpt.get_default_dtype() == jpt.get_default_dtype() == "float32"
    tpt.set_default_dtype("float64")
    assert tpt.get_default_dtype() == "float64"
    for t in (tpt.zeros([2]), tpt.rand([2]), tpt.to_tensor([1.5]),
              tpt.linspace(0, 1, 3)):
        assert t.dtype == torch.float64
    assert tpt.to_tensor([1, 2]).dtype == torch.int64
    with pytest.raises(TypeError):
        tpt.set_default_dtype("int32")


def test_to_tensor():
    x = tpt.to_tensor([[1.0, 2.0]], dtype="float16")
    assert x.dtype == torch.float16 and x.device.type == "cpu"
    assert not x.requires_grad
    y = tpt.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    assert y.requires_grad
    assert not tpt.to_tensor(np.ones(3, np.int32),
                             stop_gradient=False).requires_grad
    src = torch.ones(2)
    z = tpt.to_tensor(src, place=tpt.CPUPlace())
    z += 1
    assert float(src.sum()) == 2.0            # a copy, as paddle's
    p = tpt.to_tensor([1.0], place=tpt.CUDAPinnedPlace())
    assert p.device.type == "cpu"
    assert bool(tpt.is_tensor(p)) and not tpt.is_tensor(np.ones(1))


def test_creation_without_a_card_raises_until_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the rule for a machine without a card")
    fw_dtype._current = None                   # the default: the card
    for call in (lambda: tpt.zeros([2]), lambda: tpt.to_tensor([1.0]),
                 lambda: tpt.randn([2]), lambda: tpt.arange(3),
                 lambda: tpt.exp(np.ones(2)), lambda: tpt.fft.fftfreq(4),
                 lambda: tpt.nn.Linear(2, 2)):
        with pytest.raises(UnavailableError, match="set_device"):
            call()
    assert tpt.to_tensor([1.0], place=tpt.CPUPlace()).device.type == "cpu"
    # a tensor argument keeps its own device
    assert tpt.exp(torch.ones(2)).device.type == "cpu"
    tpt.set_device("cpu")
    assert tpt.zeros([2]).device.type == "cpu"
    assert tpt.nn.Linear(2, 2).weight.device.type == "cpu"


# -- random ops by their statistics -----------------------------------------------
def test_random_creation_statistics():
    fw_random.seed(7)
    u = tpt.uniform([200_000], min=-2.0, max=3.0)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    n = tpt.normal(1.0, 2.0, [200_000])
    assert abs(float(n.mean()) - 1.0) < 0.02 and abs(float(n.std()) - 2) < 0.02
    r = tpt.randn([100_000])
    assert abs(float(r.mean())) < 0.02 and abs(float(r.var()) - 1) < 0.02
    ri = tpt.randint(3, 9, [100_000])
    assert ri.dtype == torch.int64 and set(ri.unique().tolist()) == set(
        range(3, 9))
    p = tpt.randperm(50)
    assert sorted(p.tolist()) == list(range(50))
    b = tpt.bernoulli(torch.full((100_000,), 0.3))
    assert b.dtype == torch.float32 and abs(float(b.mean()) - 0.3) < 0.01
    s = tpt.standard_normal([50_000], dtype="float64")
    assert s.dtype == torch.float64 and abs(float(s.std()) - 1) < 0.02


def test_random_ops_statistics():
    fw_random.seed(8)
    probs = torch.tensor([0.1, 0.6, 0.3])
    draws = tpt.multinomial(probs, 60_000, replacement=True)
    freq = torch.bincount(draws, minlength=3).float() / 60_000
    assert float((freq - probs).abs().max()) < 0.01
    picks = tpt.multinomial(torch.ones(4, 10), 10)
    assert all(sorted(r) == list(range(10)) for r in picks.tolist())
    with pytest.raises(Exception, match="without replacement"):
        tpt.multinomial(torch.ones(3), 4)
    lam = torch.full((80_000,), 4.0)
    po = tpt.poisson(lam)
    assert abs(float(po.mean()) - 4) < 0.05 and abs(float(po.var()) - 4) < 0.1
    ex = tpt.exponential(torch.zeros(80_000), lam=2.0)
    assert float(ex.min()) >= 0 and abs(float(ex.mean()) - 0.5) < 0.01
    rl = tpt.randint_like(torch.zeros(50_000, dtype=torch.float32), 2, 5)
    assert rl.dtype == torch.float32 and set(rl.unique().tolist()) == {
        2.0, 3.0, 4.0}
    # one seed, one stream: the draws repeat
    fw_random.seed(9)
    a = tpt.rand([5])
    fw_random.seed(9)
    assert torch.equal(a, tpt.rand([5]))


# -- in-place forms ----------------------------------------------------------------
def test_in_place_forms_mutate_and_match_jax():
    # by design: the port mutates its tensor and returns it; the JAX
    # package's immutable arrays return a new array of the same values
    x = torch.as_tensor(X.copy())
    out = tpt.reshape_(x, [4, 3])
    assert out is x and tuple(x.shape) == (4, 3)
    _same(x, jpt.reshape_(jnp.asarray(X), [4, 3]))
    y = torch.as_tensor(X.copy()).reshape(3, 1, 4)
    assert tpt.squeeze_(y, 1) is y and tuple(y.shape) == (3, 4)
    assert tpt.unsqueeze_(y, [0, -1]) is y and tuple(y.shape) == (1, 3, 4, 1)
    z = torch.as_tensor(X.copy())
    _same(tpt.tanh_(z), np.tanh(X))
    _same(z, np.tanh(X))
    w = torch.as_tensor(np.abs(X) + 1)
    _same(tpt.rsqrt_(w), jpt.rsqrt_(jnp.asarray(np.abs(X) + 1)))
    s = torch.as_tensor(X.copy())
    idx, upd = np.array([0, 2]), np.ones((2, 4), np.float32)
    tpt.scatter_(s, idx, upd, overwrite=False)
    _same(s, jpt.scatter_(jnp.asarray(X), idx, upd, overwrite=False))
    t = torch.as_tensor(X.copy()).T
    tpt.reshape_(t, [12])
    _same(t, X.T.reshape(12))


# -- the top-level helpers ---------------------------------------------------------
def test_compiled_with_and_device_helpers():
    # by design: the port is a CUDA build; the JAX package a TPU one
    assert tpt.is_compiled_with_cuda() is True
    assert jpt.is_compiled_with_cuda() is False
    for name in ("rocm", "xpu", "npu", "mlu", "ipu"):
        assert getattr(tpt, f"is_compiled_with_{name}")() is False
    v = tpt.get_cudnn_version()
    assert v is None or isinstance(v, int)
    assert tpt.device_count() == torch.cuda.device_count()
    tpt.synchronize()
    assert len(tpt.get_cuda_rng_state()) == torch.cuda.device_count()
    tpt.set_cuda_rng_state(tpt.get_cuda_rng_state())
    tpt.disable_signal_handler()
    tpt.set_printoptions(precision=3, sci_mode=False)
    assert "0.333" in repr(torch.tensor([1 / 3]))
    tpt.set_printoptions(precision=4)
    assert tpt.Model is tpt.hapi.Model and tpt.Tensor is torch.Tensor
    assert tpt.dtype is torch.dtype and tpt.bool is torch.bool
    assert tpt.float32 is torch.float32 and tpt.complex64 is torch.complex64


@pytest.mark.parametrize("shape,ok", [(3, True), ([2, -1], True),
                                      ((2, 3), True), ([-1, -1], False),
                                      ([2.0], False), ("x", False)])
def test_check_shape_as_jax(shape, ok):
    if ok:
        assert tpt.check_shape(shape) == jpt.check_shape(shape)
        return
    with pytest.raises(Exception) as te:
        tpt.check_shape(shape)
    with pytest.raises(Exception) as je:
        jpt.check_shape(shape)
    assert str(te.value) == str(je.value)


def test_create_parameter():
    from paddle_tpu_torch.nn import initializer as I
    w = tpt.create_parameter([3, 4], "float32")
    assert isinstance(w, tpt.Parameter) and w.requires_grad
    bound = (6 / 7) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().sum()) > 0
    b = tpt.create_parameter([4], "float64", is_bias=True, name="b0")
    assert b.dtype == torch.float64 and float(b.abs().sum()) == 0
    assert b.name == "b0" and b.is_bias
    c = tpt.create_parameter([2, 2], "float32", attr=tpt.ParamAttr(
        initializer=I.Constant(0.5), trainable=False))
    assert not c.requires_grad and c.tolist() == [[0.5] * 2] * 2
    d = tpt.create_parameter([2], "float32",
                             default_initializer=I.Constant(2.0))
    assert d.tolist() == [2.0, 2.0]


def test_data_parallel_passes_through():
    net = tpt.nn.Linear(3, 2, device="cpu")
    dp = tpt.DataParallel(net)
    x = torch.randn(4, 3)
    assert torch.equal(dp(x), net(x))
    assert dp._layers is net
    assert list(dp.state_dict()) == list(net.state_dict())
    loss = dp(x).sum()
    assert dp.scale_loss(loss) is loss
    dp.apply_collective_grads()
    dp.set_state_dict(net.state_dict())
    assert isinstance(dp, tpt.nn.Layer)


def test_numpy_item_numel_shape():
    x = torch.as_tensor(X)
    np.testing.assert_array_equal(tpt.numpy(x), X)
    assert tpt.numel(x) == 12 == jpt.numel(jnp.asarray(X))
    assert tpt.shape(x) == (3, 4) == jpt.shape(jnp.asarray(X))
    assert tpt.item(x[0, 0]) == pytest.approx(float(X[0, 0]))
    assert tpt.tolist(x[0]) == pytest.approx(X[0].tolist())
    assert tpt.is_floating_point(x) and not tpt.is_integer(x)
    assert tpt.is_integer(torch.ones(1, dtype=torch.int8))
    assert not tpt.is_integer(torch.ones(1, dtype=torch.bool))
    assert tpt.is_complex(torch.ones(1, dtype=torch.complex64))
    out = torch.zeros(3, 4)
    assert tpt.assign(x, out) is out and torch.equal(out, x)
