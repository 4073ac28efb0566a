"""The extended tensor-op surface: the port of ``paddle_tpu/tensor_ops.py``
(reference python/paddle/tensor/{math,manipulation,search,random,logic}.py,
the long tail beyond the core set of the top-level namespace).

Every op is a thin, paddle-shaped adapter over a PyTorch op (on the card:
PyTorch's own kernels, cuBLAS, cuSOLVER and cuFFT, as XLA serves these ops
in the JAX package).  An argument that is not a tensor (numpy, Python
numbers and lists) is taken onto the device of the op's tensor arguments,
else onto the current device (``framework/dtype.py`` ``as_tensor``).

By-design differences from the JAX package, which runs without x64: an op
asked for int64 or float64 returns that dtype (``searchsorted``,
``multinomial``), and the random ops draw from the framework's
``torch.Generator`` streams (``framework/random.py``), so they match the
JAX package in distribution, not in values.  The in-place forms
(``reshape_``, ``squeeze_``, ``unsqueeze_``, ``tanh_``, ``scatter_``,
``rsqrt_``) mutate their tensor and return it; the JAX package, whose
arrays are immutable, returns a new array.
"""
from __future__ import annotations

import builtins
from typing import Optional

import torch

from .framework import random as fw_random
from .framework.dtype import as_tensor, convert_dtype, creation_device
from .framework.errors import enforce

__all__ = [
    # top-level gap fill (reference __init__ __all__ parity)
    "add_n", "lgamma", "asinh", "acosh", "atanh", "floor_mod",
    "bitwise_not", "rank", "empty_like", "is_empty", "unstack", "reverse",
    "increment", "slice", "strided_slice", "crop", "shard_index",
    "scatter_nd", "scatter_nd_add", "reshape_", "squeeze_", "unsqueeze_",
    "tanh_", "scatter_",
    # math
    "amax", "amin", "addmm", "angle", "conj", "real", "imag", "deg2rad",
    "rad2deg", "diff", "digamma", "erfinv", "expm1", "gcd", "lcm", "lerp",
    "logit", "logsumexp", "logcumsumexp", "nanmean", "nansum", "nanmedian",
    "stanh", "scale", "trace", "frac", "ldexp", "hypot", "copysign",
    "log1p", "rsqrt_",
    # complex
    "complex", "as_complex", "as_real", "is_complex", "is_floating_point",
    "is_integer",
    # linalg-adjacent (top-level in paddle)
    "cross", "dist", "histogram", "bincount", "inner", "kron", "mv",
    "tensordot", "matrix_transpose",
    # manipulation
    "broadcast_shape", "broadcast_tensors", "diagflat", "diagonal",
    "expand_as", "index_sample", "meshgrid", "moveaxis", "multiplex",
    "put_along_axis", "repeat_interleave", "renorm", "rot90", "unbind",
    "unique_consecutive", "as_strided", "view", "tolist",
    # search / sort
    "kthvalue", "median", "mode", "quantile", "searchsorted", "bucketize",
    "isclose", "index_sample",
    # random
    "multinomial", "poisson", "standard_normal", "randint_like",
    "exponential",
]


def _arr(x, like=None):
    return as_tensor(x, like=like)


def _pair(x, y):
    """Two operands as tensors on one device (the first tensor's)."""
    return _arr(x, like=(x, y)), _arr(y, like=(x, y))


def _dims(axis):
    """A paddle axis (None, int, list or tuple) as torch's ``dim``."""
    if axis is None or isinstance(axis, int):
        return axis
    return tuple(int(a) for a in axis)


def _wide(x):
    """A half-precision tensor as float32 (``torch.quantile`` takes float
    and double only); the result is rounded back by :func:`_narrow`."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _narrow(out, x):
    return out.to(x.dtype) if out.dtype != x.dtype else out


def _keep_all(out, x, keepdim):
    """A full reduction's result shaped as ``keepdims`` would leave it."""
    return out.reshape((1,) * x.dim()) if keepdim else out


def _reduce(fn, x, axis, keepdim, **kw):
    """``fn(x, dim=..., keepdim=...)`` over ``axis`` (all axes for None)."""
    x = _arr(x)
    if axis is None:
        return _keep_all(fn(x, **kw), x, keepdim)
    return fn(x, dim=_dims(axis), keepdim=keepdim, **kw)


# ---------------------------------------------------------------------------
# math (reference tensor/math.py)
# ---------------------------------------------------------------------------
def amax(x, axis=None, keepdim=False):
    return _reduce(torch.amax, x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return _reduce(torch.amin, x, axis, keepdim)


def addmm(input, x, y, beta: float = 1.0, alpha: float = 1.0):
    ts = (input, x, y)
    return (beta * _arr(input, ts)
            + alpha * (_arr(x, ts) @ _arr(y, ts).to(_arr(x, ts).dtype)))


def angle(x):
    return torch.angle(_arr(x))


def conj(x):
    return torch.conj_physical(_arr(x))


def real(x):
    return torch.real(_arr(x))


def imag(x):
    x = _arr(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def deg2rad(x):
    return torch.deg2rad(_arr(x))


def rad2deg(x):
    return torch.rad2deg(_arr(x))


def diff(x, n: int = 1, axis: int = -1, prepend=None, append=None):
    x = _arr(x)
    if prepend is not None:
        prepend = _arr(prepend, x)
    if append is not None:
        append = _arr(append, x)
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def digamma(x):
    return torch.digamma(_arr(x))


def erfinv(x):
    return torch.erfinv(_arr(x))


def expm1(x):
    return torch.expm1(_arr(x))


def log1p(x):
    return torch.log1p(_arr(x))


def gcd(x, y):
    return torch.gcd(*_pair(x, y))


def lcm(x, y):
    return torch.lcm(*_pair(x, y))


def lerp(x, y, weight):
    x, y = _pair(x, y)
    return x + _arr(weight, x) * (y - x)


def logit(x, eps: Optional[float] = None):
    x = _arr(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def logsumexp(x, axis=None, keepdim=False):
    x = _arr(x)
    dims = tuple(range(x.dim())) if axis is None else _dims(axis)
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


def logcumsumexp(x, axis=None):
    x = _arr(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=axis)


def nanmean(x, axis=None, keepdim=False):
    return _reduce(torch.nanmean, x, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False):
    return _reduce(torch.nansum, x, axis, keepdim,
                   dtype=convert_dtype(dtype))


def nanmedian(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count, as
    ``jnp.nanmedian`` (``torch.nanmedian`` takes the lower one)."""
    x = _arr(x)
    w = _wide(x)
    if axis is None:
        return _narrow(_keep_all(torch.nanquantile(w.reshape(-1), 0.5), x,
                                 keepdim), x)
    return _narrow(torch.nanquantile(w, 0.5, dim=axis, keepdim=keepdim), x)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * _arr(x))


def scale(x, scale=1.0, bias=0.0, bias_after_scale: bool = True,
          act=None):
    x = _arr(x)
    y = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from .nn import functional as F
        fn = getattr(F, act, None)
        enforce(fn is not None, f"scale: unknown activation {act!r}")
        y = fn(y)
    return y


def trace(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(_arr(x), offset=offset, dim1=axis1,
                          dim2=axis2).sum(-1)


def frac(x):
    x = _arr(x)
    return x - torch.trunc(x)


def ldexp(x, y):
    """x * 2**y, computed in x's float dtype (``torch.ldexp``'s gradient
    takes integer powers of 2 for an integer y, which vanish below 1)."""
    x, y = _pair(x, y)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.get_default_dtype())
    return x * torch.pow(2.0, y.to(x.real.dtype if x.is_complex()
                                   else x.dtype))


def hypot(x, y):
    return torch.hypot(*_pair(x, y))


def copysign(x, y):
    return torch.copysign(*_pair(x, y))


def rsqrt_(x):
    return _arr(x).rsqrt_()


# ---------------------------------------------------------------------------
# complex (reference tensor/creation.py complex; attribute.py real/imag)
# ---------------------------------------------------------------------------
def complex(real, imag):  # noqa: A001
    return torch.complex(*_pair(real, imag))


def as_complex(x):
    x = _arr(x)
    enforce(x.shape[-1] == 2, "as_complex expects trailing dim 2")
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    x = _arr(x)
    return torch.stack([real(x), imag(x)], dim=-1)


def is_complex(x) -> bool:
    return _arr(x).is_complex()


def is_floating_point(x) -> bool:
    return _arr(x).is_floating_point()


def is_integer(x) -> bool:
    dt = _arr(x).dtype
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


# ---------------------------------------------------------------------------
# linalg-adjacent top-level ops (reference tensor/linalg.py)
# ---------------------------------------------------------------------------
def cross(x, y, axis: int = 9):
    x, y = _pair(x, y)
    if axis == 9:  # paddle default: first axis of size 3
        axis = next((i for i, d in enumerate(x.shape) if d == 3), None)
        enforce(axis is not None,
                "cross: no dimension of size 3 found; pass axis explicitly")
    return torch.linalg.cross(x, y, dim=axis)


def dist(x, y, p: float = 2.0):
    x, y = _pair(x, y)
    d = (x - y).reshape(-1)
    if p == float("inf"):
        return torch.max(torch.abs(d))
    if p == 0:
        return torch.sum(d != 0).to(d.dtype)
    return torch.linalg.vector_norm(d, ord=p)


def histogram(x, bins: int = 100, min: float = 0.0, max: float = 0.0):
    """Counts in ``x``'s dtype (a half-precision ``x`` is binned in
    float32: CUDA's ``histc`` does not take it)."""
    x = _arr(x).reshape(-1)
    if min == 0.0 and max == 0.0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    return _narrow(torch.histc(_wide(x), bins=bins, min=lo, max=hi), x)


def bincount(x, weights=None, minlength: int = 0):
    x = _arr(x)
    if weights is not None:
        weights = _arr(weights, x)
    return torch.bincount(x, weights=weights, minlength=minlength)


def inner(x, y):
    return torch.inner(*_pair(x, y))


def kron(x, y):
    return torch.kron(*_pair(x, y))


def mv(x, vec):
    x, vec = _pair(x, vec)
    return x @ vec


def tensordot(x, y, axes=2):
    x, y = _pair(x, y)
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def matrix_transpose(x):
    return torch.swapaxes(_arr(x), -1, -2)


# ---------------------------------------------------------------------------
# manipulation (reference tensor/manipulation.py)
# ---------------------------------------------------------------------------
def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(int(s) for s in x_shape),
                                       tuple(int(s) for s in y_shape)))


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*[_arr(i, inputs) for i in inputs]))


def diagflat(x, offset: int = 0):
    return torch.diagflat(_arr(x), offset=offset)


def diagonal(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(_arr(x), offset=offset, dim1=axis1, dim2=axis2)


def expand_as(x, y):
    x, y = _pair(x, y)
    return torch.broadcast_to(x, y.shape)


def index_sample(x, index):
    """Per-row gather: out[i, j] = x[i, index[i, j]] (index_sample_op)."""
    x, index = _pair(x, index)
    return torch.take_along_dim(x, index.long(), dim=1)


def meshgrid(*args):
    xs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[_arr(x, xs) for x in xs], indexing="ij"))


def moveaxis(x, source, destination):
    return torch.movedim(_arr(x), source, destination)


def multiplex(inputs, index):
    """out[i] = inputs[index[i]][i] (multiplex_op semantics)."""
    stacked = torch.stack([_arr(i, inputs) for i in inputs], dim=0)
    idx = _arr(index, stacked).reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def scatter_last(arr, axis: int, indices, values):
    """``arr`` with ``values`` written at ``indices`` along ``axis``
    (``torch.scatter``'s layout); where indices repeat, the last write in
    C order wins, as numpy's does, on the card too (``torch.scatter``
    leaves the winner of a repeated index unspecified on CUDA)."""
    order = torch.arange(indices.numel(), device=arr.device).reshape(
        indices.shape)
    last = torch.full(arr.shape, -1, dtype=torch.long,
                      device=arr.device).scatter_reduce(
        axis, indices, order, "amax")
    keep = last.gather(axis, indices) == order
    placed = torch.zeros_like(arr).scatter_add(
        axis, indices, torch.where(keep, values, torch.zeros_like(values)))
    hit = torch.zeros(arr.shape, dtype=torch.bool,
                      device=arr.device).scatter(axis, indices, True)
    return torch.where(hit, placed, arr)


def put_along_axis(arr, indices, values, axis: int, reduce: str = "assign"):
    arr, indices = _pair(arr, indices)
    indices = indices.long()
    values = torch.broadcast_to(_arr(values, arr),
                                indices.shape).to(arr.dtype)
    if reduce == "assign":
        return scatter_last(arr, axis, indices, values)
    if reduce == "add":
        return torch.scatter_add(arr, axis, indices, values)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(arr, axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce {reduce!r}")


def repeat_interleave(x, repeats, axis: Optional[int] = None):
    x = _arr(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if not isinstance(repeats, int):
        repeats = _arr(repeats, x)
    return torch.repeat_interleave(x, repeats, dim=axis)


def renorm(x, p: float, axis: int, max_norm: float):
    """Clamp the p-norm of every slice along ``axis`` to max_norm."""
    x = _arr(x)
    axes = tuple(i for i in range(x.dim()) if i != axis)
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def rot90(x, k: int = 1, axes=(0, 1)):
    return torch.rot90(_arr(x), k=k, dims=list(axes))


def unbind(x, axis: int = 0):
    return list(torch.unbind(_arr(x), dim=axis))


def unique_consecutive(x, return_inverse: bool = False,
                       return_counts: bool = False, axis=None):
    """Deduplicate consecutive runs (a data-dependent shape, as the
    reference's op)."""
    out = torch.unique_consecutive(_arr(x), return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if return_inverse and axis is None:
        out = (out[0], out[1].reshape(-1)) + tuple(out[2:])
    return out


def as_strided(x, shape, stride, offset: int = 0):
    """A view with explicit strides over the flattened ``x``."""
    flat = _arr(x).reshape(-1)
    return torch.as_strided(flat, tuple(shape), tuple(stride),
                            flat.storage_offset() + offset)


def view(x, shape_or_dtype):
    x = _arr(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    return x.view(convert_dtype(shape_or_dtype))


def tolist(x):
    return _arr(x).tolist()


# ---------------------------------------------------------------------------
# search / sort (reference tensor/search.py, stat.py)
# ---------------------------------------------------------------------------
def kthvalue(x, k: int, axis: int = -1, keepdim: bool = False):
    """The k-th smallest and its index, from a stable sort (the first of
    equal values, as the JAX package takes it)."""
    vals, idxs = torch.sort(_arr(x), dim=axis, stable=True)
    val = vals.select(axis, k - 1)
    idx = idxs.select(axis, k - 1)
    if keepdim:
        val, idx = val.unsqueeze(axis), idx.unsqueeze(axis)
    return val, idx


def median(x, axis=None, keepdim: bool = False):
    """The mean of the two middle values for an even count, as
    ``jnp.median`` (``torch.median`` takes the lower one)."""
    x = _arr(x)
    w = _wide(x)
    if axis is None:
        return _narrow(_keep_all(torch.quantile(w.reshape(-1), 0.5), x,
                                 keepdim), x)
    return _narrow(torch.quantile(w, 0.5, dim=axis, keepdim=keepdim), x)


def mode(x, axis: int = -1, keepdim: bool = False):
    """Most frequent value along axis; ties resolve to the largest value
    (mode_op semantics); its index is the first position holding it."""
    x = _arr(x)
    xm = torch.movedim(x, axis, -1)
    sx, _ = torch.sort(xm, dim=-1)
    n = sx.shape[-1]
    pos = torch.arange(n, device=x.device).expand_as(sx)
    starts = torch.ones_like(sx, dtype=torch.bool)
    starts[..., 1:] = sx[..., 1:] != sx[..., :-1]
    run_start = torch.cummax(torch.where(starts, pos, torch.zeros_like(pos)),
                             dim=-1).values
    runs = pos - run_start + 1
    best = torch.argmax(runs * n + pos, dim=-1, keepdim=True)
    val = torch.take_along_dim(sx, best, dim=-1)
    idx = torch.argmax((xm == val).to(torch.int8), dim=-1, keepdim=True)
    val, idx = val.squeeze(-1), idx.squeeze(-1)
    if keepdim:
        val, idx = val.unsqueeze(axis), idx.unsqueeze(axis)
    return val, idx


def quantile(x, q, axis=None, keepdim: bool = False):
    x = _arr(x)
    w = _wide(x)
    q = torch.as_tensor(q, dtype=w.dtype, device=x.device)
    if axis is None:
        return _narrow(_keep_all(torch.quantile(w.reshape(-1), q), x,
                                 keepdim), x)
    return _narrow(torch.quantile(w, q, dim=axis, keepdim=keepdim), x)


def searchsorted(sorted_sequence, values, out_int32: bool = False,
                 right: bool = False):
    seq, values = _pair(sorted_sequence, values)
    return torch.searchsorted(seq, values.to(seq.dtype), right=right,
                              out_int32=out_int32)


def bucketize(x, sorted_sequence, out_int32: bool = False,
              right: bool = False):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def isclose(x, y, rtol: float = 1e-5, atol: float = 1e-8,
            equal_nan: bool = False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


# ---------------------------------------------------------------------------
# random (reference tensor/random.py): the framework's generator streams
# ---------------------------------------------------------------------------
def multinomial(x, num_samples: int = 1, replacement: bool = False):
    x = _arr(x)
    enforce(replacement or num_samples <= x.shape[-1],
            "cannot draw more samples than categories without replacement")
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=fw_random.generator(x.device))


def poisson(x):
    x = _arr(x)
    return torch.poisson(x, generator=fw_random.generator(x.device))


def standard_normal(shape, dtype="float32"):
    dev = creation_device()
    return torch.randn(tuple(shape), dtype=convert_dtype(dtype), device=dev,
                       generator=fw_random.generator(dev))


def randint_like(x, low, high=None, dtype=None):
    x = _arr(x)
    if high is None:
        low, high = 0, low
    out_dtype = convert_dtype(dtype) if dtype else x.dtype  # paddle: match x
    draw = out_dtype if is_integer(torch.empty(0, dtype=out_dtype)) \
        else torch.int64
    out = torch.randint(low, high, tuple(x.shape), dtype=draw,
                        device=x.device,
                        generator=fw_random.generator(x.device))
    return out.to(out_dtype)


def exponential(x, lam: float = 1.0):
    """Exponential-distribution samples shaped like x (exponential_ op)."""
    x = _arr(x)
    return torch.empty_like(x).exponential_(
        lam, generator=fw_random.generator(x.device))


# ---------------------------------------------------------------------------
# top-level gap fill (reference python/paddle/__init__.py __all__ parity):
# manipulation / search ops and the in-place forms
# ---------------------------------------------------------------------------
def add_n(inputs):
    """Elementwise sum of a tensor list (reference tensor/math.py add_n)."""
    if not isinstance(inputs, (list, tuple)):
        return _arr(inputs)
    out = _arr(inputs[0], inputs)
    for x in inputs[1:]:
        out = out + _arr(x, inputs)
    return out


def lgamma(x):
    return torch.lgamma(_arr(x))


def asinh(x):
    return torch.asinh(_arr(x))


def acosh(x):
    return torch.acosh(_arr(x))


def atanh(x):
    return torch.atanh(_arr(x))


def floor_mod(x, y):
    return torch.remainder(*_pair(x, y))


def bitwise_not(x):
    return torch.bitwise_not(_arr(x))


def rank(x):
    """Number of dimensions as a 0-d int32 tensor (reference rank op)."""
    x = _arr(x)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def empty_like(x, dtype=None):
    x = _arr(x)
    return torch.empty_like(x, dtype=convert_dtype(dtype) if dtype
                            else x.dtype)


def is_empty(x):
    """Whether the tensor holds zero elements (0-d bool; logic.py:229)."""
    x = _arr(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def unstack(x, axis=0, num=None):
    """Split along ``axis`` into that dim's many tensors, squeezing it."""
    x = _arr(x)
    enforce(num is None or num == x.shape[axis],
            f"unstack: num={num} does not match dim {axis} of size "
            f"{x.shape[axis]}")
    return list(torch.unbind(x, dim=axis))


def reverse(x, axis):
    """Flip along the given axes (reference fluid reverse op)."""
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(_arr(x), dims=list(axis))


def increment(x, value=1.0):
    """x + value for a single-element tensor (reference
    tensor/math.py:3324); a new tensor, as in the JAX package."""
    x = _arr(x)
    enforce(x.numel() == 1, "increment requires a single-element tensor")
    return x + torch.tensor(value, dtype=x.dtype, device=x.device)


def _clamp_range(st, en, d):
    """The reference slice op's bounds: negative indices wrap once, both
    ends clamp to [0, d]."""
    st, en = int(st), int(en)
    if st < 0:
        st += d
    if en < 0:
        en += d
    return (builtins.max(builtins.min(st, d), 0),
            builtins.max(builtins.min(en, d), 0))


def slice(input, axes, starts, ends):  # noqa: A001
    """Static slice over the given axes (reference slice op semantics:
    negative indices wrap, ends clamp to the dim size)."""
    x = _arr(input)
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        st, en = _clamp_range(st, en, x.shape[ax])
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """slice() with per-axis strides (reference strided_slice op); a
    negative stride walks down, past index 0 when the end is still
    negative after one wrap."""
    x = _arr(x)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        ax = ax % x.dim()
        d = x.shape[ax]
        sd = int(sd)
        if sd > 0:
            st, en = _clamp_range(st, en, d)
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = builtins.slice(st, en, sd)
            x = x[tuple(idx)]
            continue
        st, en = int(st), int(en)
        if st < 0:
            st += d
        if en < 0:
            en += d
        st = builtins.min(st, d - 1)
        picks = list(range(d))[builtins.slice(st, None if en < 0 else en,
                                              sd)]
        x = x.index_select(ax, torch.tensor(picks, dtype=torch.long,
                                            device=x.device))
    return x


def crop(x, shape=None, offsets=None):
    """Crop to ``shape`` starting at ``offsets`` (reference crop op;
    -1 in shape keeps the rest of that dim)."""
    x = _arr(x)
    if shape is None:
        shape = x.shape
    if offsets is None:
        offsets = [0] * x.dim()
    idx = []
    for d, off, s in zip(x.shape, offsets, shape):
        off = int(off)
        end = d if int(s) == -1 else off + int(s)
        idx.append(builtins.slice(off, end))
    return x[tuple(idx)]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Re-base class indices onto one shard of [0, index_num)
    (reference fluid/layers/nn.py:15231; the vocab-parallel label
    transform).  Values outside this shard's range become
    ``ignore_value``."""
    enforce(0 <= shard_id < nshards,
            f"shard_id {shard_id} out of range [0, {nshards})")
    x = _arr(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    inside = (x >= lo) & (x < hi)
    return torch.where(inside, x - lo,
                       torch.full_like(x, ignore_value))


def _nd_index(index):
    return tuple(torch.movedim(index.long(), -1, 0))


def scatter_nd_add(x, index, updates):
    """x with ``updates`` scatter-added at ``index`` (reference
    scatter_nd_add op; duplicate indices accumulate)."""
    ts = (x, index, updates)
    x, index, updates = (_arr(x, ts), _arr(index, ts), _arr(updates, ts))
    return torch.index_put(x, _nd_index(index), updates.to(x.dtype),
                           accumulate=True)


def scatter_nd(index, updates, shape):
    """Zeros of ``shape`` with updates scatter-added (reference
    scatter_nd: scatter_nd_add onto a zero tensor)."""
    updates = _arr(updates, index)
    return scatter_nd_add(torch.zeros(tuple(shape), dtype=updates.dtype,
                                      device=updates.device), index, updates)


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= builtins.max(int(s), 1)
    return tuple(reversed(strides))


def reshape_(x, shape):
    """Reshape ``x`` in place (its storage is kept when it is contiguous,
    else replaced by a contiguous copy) and return it."""
    x = _arr(x)
    new = tuple(x.reshape(tuple(shape)).shape)
    if not x.is_contiguous():
        with torch.no_grad():
            x.set_(x.contiguous())
    return x.as_strided_(new, _contiguous_strides(new), x.storage_offset())


def squeeze_(x, axis=None):
    x = _arr(x)
    if axis is None:
        return x.squeeze_()
    return x.squeeze_(_dims(axis))


def unsqueeze_(x, axis):
    x = _arr(x)
    for a in sorted(_unsqueeze_axes(x.dim(), axis)):
        x.unsqueeze_(a)
    return x


def _unsqueeze_axes(ndim, axis):
    """``expand_dims`` axes normalized against the output's rank."""
    axes = [axis] if isinstance(axis, int) else list(axis)
    out = ndim + len(axes)
    return [a + out if a < 0 else a for a in axes]


def tanh_(x):
    return _arr(x).tanh_()


def scatter_(x, index, updates, overwrite=True):
    """:func:`paddle_tpu_torch.scatter` written into ``x``."""
    from . import scatter
    x = _arr(x, (x, index, updates))
    return x.copy_(scatter(x, index, updates, overwrite))

