"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's layout and names (``models/gpt.py``,
``inference/engine.py``, ``ops/fused_block.py``, ...) so each module's
counterpart is found by path.  It imports ``torch``, numpy and the standard
library only.  Its kernels are CUDA C++ for Hopper (``csrc/*.cu``), built
with ``nvcc`` at first use and bound through ``ctypes`` (``_kernels.py``).

``import paddle_tpu_torch as paddle`` gives the paddle-shaped tensor API
(reference python/paddle/__init__.py): the dtype names, creation, math,
reductions, linalg, manipulation and search ops (with the long tail of
``tensor_ops.py``), ``linalg`` / ``fft`` / ``signal``, ``autograd``,
``no_grad`` / ``grad``, the places and ``set_device``, ``to_tensor``,
``create_parameter``, ``DataParallel`` and ``Model``, and the paddle
methods ``torch.Tensor`` lacks (``framework/tensor_methods.py``).  The
tensor type is ``torch.Tensor``.

Entry points run on ``cuda`` unless the caller asks for the CPU: with
``device="cpu"``, with ``set_device("cpu")``, or with a CPU place.
Without a card and without that, they raise ``UnavailableError``.  On a
CPU tensor every kernel wrapper takes its plain PyTorch version, which is
also the numerics oracle the kernels are held against.

Ported: serving (``inference.ServingEngine`` over the paged KV cache, its
lifecycle, the fleet and the ``Config`` / ``create_predictor`` facade);
training (``training.train_step``, the fused-block step, activation
recompute, every optimizer and lr schedule, AMP, checkpoints in the JAX
package's format) with GPT, BERT, the MoE GPT and the encoder-decoder
Transformer; ``generate``; supervised training through ``hapi.Model`` over
``io.DataLoader`` with ``metric`` and the callbacks under
``supervisor.RunSupervisor``; ``nn`` (every layer and functional, RNNs,
CTC, ``Layer`` / ``Parameter``), ``vision`` (the model zoo, transforms,
datasets, detection ops), ``text``'s translation datasets,
``observability``; the tensor API above with the op registry
(``ops/spec.py``); and the long tail: ``distribution``, ``sparse``,
``reader`` / ``dataset`` / ``batch``, the text datasets and the WordPiece
tokenizer, the native shared-memory loader transport, ``incubate``'s
optimizers and ASP sparsity, ``profiler``, ``hub``, ``utils``,
``version``, ``sysconfig`` and ``callbacks``.  The eight CUDA kernels serve attention, the fused
blocks and decode; the tensor API runs on PyTorch's own kernels, cuBLAS,
cuSOLVER and cuFFT.  ``ROADMAP.md`` lists what is still to port.
"""
from __future__ import annotations

import builtins as _builtins

import torch

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401,E402
from .framework.errors import (  # noqa: F401,E402
    EnforceNotMet, InvalidArgumentError, UnavailableError, UnimplementedError,
    enforce)

from . import amp  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import framework  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import device  # noqa: F401,E402
from . import fft  # noqa: F401,E402
from . import signal  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import observability  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import text  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import quantization  # noqa: F401,E402
from . import onnx  # noqa: F401,E402
from . import cost_model  # noqa: F401,E402
from . import distribution  # noqa: F401,E402
from . import sparse  # noqa: F401,E402
from . import reader  # noqa: F401,E402
from . import dataset  # noqa: F401,E402
from . import sysconfig  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import hub  # noqa: F401,E402
from . import profiler  # noqa: F401,E402
from . import version  # noqa: F401,E402
from .reader import batch  # noqa: F401,E402
from .hapi import flops, summary  # noqa: F401,E402

from .framework import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401,E402
                        NPUPlace, TPUPlace, get_device, load, save, seed,
                        set_device)
from .framework import dtype as _fw_dtype  # noqa: E402
from .framework import random as _fw_random  # noqa: E402
from .framework.dtype import convert_dtype  # noqa: E402
from .framework.flags import get_flags, set_flags  # noqa: F401,E402
from .nn.initializer import ParamAttr  # noqa: F401,E402
from .nn.layer import Parameter  # noqa: F401,E402

# dtype names (paddle.float32 etc.)
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
bool = torch.bool  # noqa: A001
complex64 = torch.complex64
complex128 = torch.complex128
dtype = torch.dtype          # paddle.dtype: the dtype *type*

Tensor = torch.Tensor


from .tensor_ops import _arr, _dims, _keep_all, _pair  # noqa: E402


# ---------------------------------------------------------------------------
# creation (reference python/paddle/tensor/creation.py)
# ---------------------------------------------------------------------------
def _float_dtype(dtype):
    """Resolve a creation-API dtype: None -> the global default float
    (paddle.set_default_dtype)."""
    return _fw_dtype.default_float() if dtype is None else convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    return tuple(int(s) for s in shape)


def _dev():
    return _fw_dtype.creation_device()


def _gen(device):
    return _fw_random.generator(device)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor of ``data`` on ``place`` (the current device by
    default; a ``CUDAPinnedPlace`` gives pinned host memory).
    ``stop_gradient=False`` makes a floating tensor require grad."""
    dev = _fw_dtype.creation_device(place)
    if isinstance(data, torch.Tensor):
        x = data.detach().to(device=dev, dtype=convert_dtype(dtype),
                             copy=True)
    else:
        x = _fw_dtype.as_tensor(data, like=torch.empty(0, device=dev),
                                dtype=dtype)
    if isinstance(place, _fw_dtype.Place) and place.pinned \
            and torch.cuda.is_available():
        x = x.pin_memory()
    if not stop_gradient and (x.is_floating_point() or x.is_complex()):
        x.requires_grad_(True)
    return x


def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_float_dtype(dtype), device=_dev())


def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_float_dtype(dtype), device=_dev())


def full(shape, fill_value, dtype=None):
    return torch.full(_shape(shape), fill_value, dtype=_float_dtype(dtype),
                      device=_dev())


def zeros_like(x, dtype=None):
    return torch.zeros_like(_arr(x), dtype=convert_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(_arr(x), dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(_arr(x), fill_value, dtype=convert_dtype(dtype))


def arange(start, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=_dev())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, num, dtype=_float_dtype(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_float_dtype(dtype),
                     device=_dev())


def empty(shape, dtype=None):
    return torch.empty(_shape(shape), dtype=_float_dtype(dtype), device=_dev())


def rand(shape, dtype=None):
    dev = _dev()
    return torch.rand(_shape(shape), dtype=_float_dtype(dtype), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None):
    dev = _dev()
    return torch.randn(_shape(shape), dtype=_float_dtype(dtype), device=dev,
                       generator=_gen(dev))


def randint(low, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return torch.randint(low, high, _shape(shape), dtype=convert_dtype(dtype),
                         device=dev, generator=_gen(dev))


def randperm(n, dtype="int64"):
    dev = _dev()
    return torch.randperm(n, dtype=convert_dtype(dtype), device=dev,
                          generator=_gen(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0):
    u = rand(shape, dtype)
    return min + (max - min) * u


def normal(mean=0.0, std=1.0, shape=(1,)):
    return mean + std * randn(shape)


def bernoulli(x):
    x = _arr(x)
    return torch.bernoulli(x, generator=_gen(x.device)).to(torch.float32)


# ---------------------------------------------------------------------------
# math / reduction / comparison (reference python/paddle/tensor/math.py)
# ---------------------------------------------------------------------------
def _wrap1(fn, name):
    def op(x, *a, **k):
        return fn(_arr(x), *a, **k)
    op.__name__ = op.__qualname__ = name
    return op


def _wrap2(fn, name):
    def op(x, y, *a, **k):
        return fn(*_pair(x, y), *a, **k)
    op.__name__ = op.__qualname__ = name
    return op


abs = _wrap1(torch.abs, "abs")  # noqa: A001
exp = _wrap1(torch.exp, "exp")
log = _wrap1(torch.log, "log")
log2 = _wrap1(torch.log2, "log2")
log10 = _wrap1(torch.log10, "log10")
sqrt = _wrap1(torch.sqrt, "sqrt")
rsqrt = _wrap1(torch.rsqrt, "rsqrt")
square = _wrap1(torch.square, "square")
sin = _wrap1(torch.sin, "sin")
cos = _wrap1(torch.cos, "cos")
tan = _wrap1(torch.tan, "tan")
asin = _wrap1(torch.asin, "asin")
acos = _wrap1(torch.acos, "acos")
atan = _wrap1(torch.atan, "atan")
sinh = _wrap1(torch.sinh, "sinh")
cosh = _wrap1(torch.cosh, "cosh")
tanh = _wrap1(torch.tanh, "tanh")
floor = _wrap1(torch.floor, "floor")
ceil = _wrap1(torch.ceil, "ceil")
round = _wrap1(torch.round, "round")  # noqa: A001
trunc = _wrap1(torch.trunc, "trunc")
sign = _wrap1(torch.sign, "sign")
reciprocal = _wrap1(torch.reciprocal, "reciprocal")
neg = _wrap1(torch.neg, "neg")
erf = _wrap1(torch.erf, "erf")
sigmoid = _wrap1(torch.sigmoid, "sigmoid")
isnan = _wrap1(torch.isnan, "isnan")
isinf = _wrap1(torch.isinf, "isinf")
isfinite = _wrap1(torch.isfinite, "isfinite")

add = _wrap2(torch.add, "add")
subtract = _wrap2(torch.subtract, "subtract")
multiply = _wrap2(torch.multiply, "multiply")
divide = _wrap2(torch.true_divide, "divide")
floor_divide = _wrap2(torch.floor_divide, "floor_divide")
mod = _wrap2(torch.remainder, "mod")
remainder = _wrap2(torch.remainder, "remainder")
pow = _wrap2(torch.pow, "pow")  # noqa: A001
maximum = _wrap2(torch.maximum, "maximum")
minimum = _wrap2(torch.minimum, "minimum")
fmax = _wrap2(torch.fmax, "fmax")
fmin = _wrap2(torch.fmin, "fmin")
atan2 = _wrap2(torch.atan2, "atan2")
equal = _wrap2(torch.eq, "equal")
not_equal = _wrap2(torch.ne, "not_equal")
greater_than = _wrap2(torch.gt, "greater_than")
greater_equal = _wrap2(torch.ge, "greater_equal")
less_than = _wrap2(torch.lt, "less_than")
less_equal = _wrap2(torch.le, "less_equal")
logical_and = _wrap2(torch.logical_and, "logical_and")
logical_or = _wrap2(torch.logical_or, "logical_or")
logical_xor = _wrap2(torch.logical_xor, "logical_xor")
logical_not = _wrap1(torch.logical_not, "logical_not")
bitwise_and = _wrap2(torch.bitwise_and, "bitwise_and")
bitwise_or = _wrap2(torch.bitwise_or, "bitwise_or")
bitwise_xor = _wrap2(torch.bitwise_xor, "bitwise_xor")


def _each_dim(fn, x, axis, keepdim):
    """``fn(x, dim, keepdim=)`` of a one-dim torch reduction over every
    axis in ``axis`` (all axes for None)."""
    x = _arr(x)
    if axis is None:
        return _keep_all(fn(x.reshape(-1), 0), x, keepdim)
    dims = [axis] if isinstance(axis, int) else list(axis)
    out = x
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        out = fn(out, d, keepdim=keepdim)
    return out


def mean(x, axis=None, keepdim=False):
    x = _arr(x)
    if axis is None:
        return _keep_all(torch.mean(x), x, keepdim)
    return torch.mean(x, dim=_dims(axis), keepdim=keepdim)


def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    x = _arr(x)
    dt = convert_dtype(dtype)
    if axis is None:
        return _keep_all(torch.sum(x, dtype=dt), x, keepdim)
    return torch.sum(x, dim=_dims(axis), keepdim=keepdim, dtype=dt)


def max(x, axis=None, keepdim=False):  # noqa: A001
    x = _arr(x)
    if axis is None:
        return _keep_all(torch.amax(x), x, keepdim)
    return torch.amax(x, dim=_dims(axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    x = _arr(x)
    if axis is None:
        return _keep_all(torch.amin(x), x, keepdim)
    return torch.amin(x, dim=_dims(axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False):
    return _each_dim(torch.prod, x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    x = _arr(x)
    c = 1 if unbiased else 0
    if axis is None:
        return _keep_all(torch.std(x, correction=c), x, keepdim)
    return torch.std(x, dim=_dims(axis), correction=c, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    x = _arr(x)
    c = 1 if unbiased else 0
    if axis is None:
        return _keep_all(torch.var(x, correction=c), x, keepdim)
    return torch.var(x, dim=_dims(axis), correction=c, keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    x = _arr(x)
    if axis is None:
        out = _keep_all(fn(x.reshape(-1)), x, keepdim)
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False):
    """A stable ascending sort's indices, reversed for ``descending`` (the
    JAX package's order: equal values come out last-first)."""
    idx = torch.argsort(_arr(x), dim=axis, stable=True)
    return torch.flip(idx, dims=[axis]) if descending else idx


def sort(x, axis=-1, descending=False):
    y = torch.sort(_arr(x), dim=axis, stable=True).values
    return torch.flip(y, dims=[axis]) if descending else y


def topk(x, k, axis=-1, largest=True):
    out = torch.topk(_arr(x), k, dim=axis, largest=largest, sorted=True)
    return out.values, out.indices


def cumsum(x, axis=None, dtype=None):
    x = _arr(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    x = _arr(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=convert_dtype(dtype))


def clip(x, min=None, max=None):
    x = _arr(x)
    if min is None and max is None:
        return x
    return torch.clamp(x, min=min, max=max)


def _bool_reduce(fn, x, axis, keepdim):
    x = _arr(x)
    if axis is None:
        return _keep_all(fn(x), x, keepdim)
    return _each_dim(fn, x.to(torch.bool), axis, keepdim)


def all(x, axis=None, keepdim=False):  # noqa: A001
    return _bool_reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return _bool_reduce(torch.any, x, axis, keepdim)


# linalg-ish
def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    x, y = _pair(x, y)
    return nn.functional.matmul(x, y, transpose_x, transpose_y)


def mm(x, y):
    return torch.matmul(*_pair(x, y))


def bmm(x, y):
    return torch.matmul(*_pair(x, y))


def dot(x, y):
    x, y = _pair(x, y)
    return torch.sum(x * y, dim=-1)


def t(x):
    """Reference paddle.t: identity for 0/1-D, transpose for 2-D; higher
    ranks are an error (use transpose)."""
    x = _arr(x)
    if x.dim() < 2:
        return x
    if x.dim() == 2:
        return x.transpose(0, 1)
    raise ValueError(
        f"paddle.t expects a tensor of rank <= 2, got rank {x.dim()}; "
        "use transpose for higher-rank permutations")


def einsum(eq, *xs):
    return torch.einsum(eq, *[_arr(x, xs) for x in xs])


def norm(x, p="fro", axis=None, keepdim=False):
    """paddle.norm: with axis=None the input is flattened and the vector
    p-norm is taken ('fro' is the 2-norm of the flattened tensor); matrix
    norms only for a 2-tuple axis."""
    x = _arr(x)
    if axis is None:
        out = torch.linalg.vector_norm(x.reshape(-1),
                                       ord=2 if p == "fro" else p)
        return _keep_all(out, x, keepdim)
    if isinstance(axis, (tuple, list)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                        keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=2 if p == "fro" else p,
                                    dim=_dims(axis), keepdim=keepdim)


def outer(x, y):
    return torch.outer(*_pair(x, y))


def diag(x, offset=0):
    return torch.diag(_arr(x), diagonal=offset)


def tril(x, diagonal=0):
    return torch.tril(_arr(x), diagonal=diagonal)


def triu(x, diagonal=0):
    return torch.triu(_arr(x), diagonal=diagonal)


# ---------------------------------------------------------------------------
# manipulation (reference python/paddle/tensor/manipulation.py)
# ---------------------------------------------------------------------------
def reshape(x, shape):
    return torch.reshape(_arr(x), _shape(shape))


def transpose(x, perm):
    return _arr(x).permute(*perm)


def squeeze(x, axis=None):
    x = _arr(x)
    return torch.squeeze(x) if axis is None else torch.squeeze(x, _dims(axis))


def unsqueeze(x, axis):
    x = _arr(x)
    axes = [axis] if isinstance(axis, int) else list(axis)
    out_rank = x.dim() + len(axes)
    for a in sorted(a + out_rank if a < 0 else a for a in axes):
        x = x.unsqueeze(a)
    return x


def concat(xs, axis=0):
    return torch.cat([_arr(x, xs) for x in xs], dim=axis)


def stack(xs, axis=0):
    return torch.stack([_arr(x, xs) for x in xs], dim=axis)


def split(x, num_or_sections, axis=0):
    x = _arr(x)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        enforce(total % num_or_sections == 0,
                f"split: dim {axis} of size {total} does not divide into "
                f"{num_or_sections} equal sections")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sizes = [int(s) for s in num_or_sections]
    if -1 in sizes:
        known = _builtins.sum(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = total - known
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def tile(x, repeat_times):
    return torch.tile(_arr(x), tuple(repeat_times))


def expand(x, shape):
    return torch.broadcast_to(_arr(x), _shape(shape))


def broadcast_to(x, shape):
    return torch.broadcast_to(_arr(x), _shape(shape))


def flip(x, axis):
    return torch.flip(_arr(x), dims=[axis] if isinstance(axis, int)
                      else list(axis))


def roll(x, shifts, axis=None):
    return torch.roll(_arr(x), shifts, dims=axis)


def flatten(x, start_axis=0, stop_axis=-1):
    return nn.functional.flatten(_arr(x), start_axis, stop_axis)


def _take(x, index, axis):
    """``jnp.take``: rows of ``x`` along ``axis`` at an index of any
    shape."""
    x, index = _pair(x, index)
    axis = axis % x.dim()
    idx = index.long()
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def gather(x, index, axis=0):
    return _take(x, index, axis)


def gather_nd(x, index):
    x, index = _pair(x, index)
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def take_along_axis(x, indices, axis):
    x, indices = _pair(x, indices)
    return torch.take_along_dim(x, indices.long(), dim=axis)


def scatter(x, index, updates, overwrite=True):
    """Reference phi scatter kernel: with overwrite=False the destination rows
    are zeroed first (ScatterAssignAdd, paddle/phi/kernels/funcs/scatter.h),
    so result rows are the sum of updates only, not dest + updates."""
    ts = (x, index, updates)
    x, index, updates = (_arr(x, ts), _arr(index, ts).long(),
                         _arr(updates, ts))
    updates = updates.to(x.dtype)
    if overwrite:     # a repeated row: the last update wins
        rows = index.reshape((-1,) + (1,) * (updates.dim() - 1))
        return _scatter_last(x, 0, rows.expand_as(updates), updates)
    return torch.index_put(x.index_fill(0, index, 0), (index,), updates,
                           accumulate=True)


def index_select(x, index, axis=0):
    return _take(x, index, axis)


def masked_select(x, mask):
    x, mask = _pair(x, mask)
    return x[mask.to(torch.bool)]


def where(condition, x=None, y=None):
    c = _arr(condition, (condition, x, y))
    if x is None and y is None:
        return torch.where(c)
    ts = (condition, x, y)
    return torch.where(c.to(torch.bool), _arr(x, ts), _arr(y, ts))


def nonzero(x):
    return torch.nonzero(_arr(x))


def unique(x, return_index=False, return_inverse=False, return_counts=False):
    """Sorted unique values of the flattened ``x``; ``return_index`` gives
    each value's first position, as ``jnp.unique``."""
    x = _arr(x)
    u, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                  return_counts=True)
    out = [u]
    if return_index:
        flat = inv.reshape(-1)
        n = flat.numel()
        first = torch.full((u.numel(),), n, dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, flat, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def cast(x, dtype):
    return _arr(x).to(convert_dtype(dtype))


def numel(x):
    return _arr(x).numel()


def shape(x):
    return tuple(_arr(x).shape)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def assign(x, output=None):
    """A copy of ``x``; written into ``output`` when one is given."""
    x = _arr(x, output)
    if output is None:
        return x.clone()
    with torch.no_grad():
        output.copy_(x)
    return output


def clone(x):
    return _arr(x).clone()


def numpy(x):
    return _fw_dtype.to_numpy(_arr(x))


def item(x):
    return _arr(x).item()


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    """A 0-d bool tensor (the JAX package's 0-d bool array)."""
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def equal_all(x, y):
    x, y = _pair(x, y)
    return torch.tensor(torch.equal(x, y), device=x.device)


# grad / no-grad
no_grad = autograd.no_grad
grad = autograd.grad

# execution-mode toggles (framework/mode.py; grad mode is torch's own)
from .framework.mode import (  # noqa: E402
    enable_static, disable_static, in_dynamic_mode, set_grad_enabled,
    is_grad_enabled)

# Keras-style Model at the top level (reference paddle.Model = hapi.Model)
Model = hapi.Model


def is_compiled_with_cuda() -> bool:
    """True: the port is built for an NVIDIA card (the JAX package, a TPU
    build, answers False)."""
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int (None when PyTorch has no cuDNN)."""
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


def stop_gradient(x):
    return _arr(x).detach()


# device helpers
def device_count():
    return torch.cuda.device_count()


def synchronize():
    """Block until all enqueued work on the card is done."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# top-level parity fill (reference python/paddle/__init__.py __all__)
# ---------------------------------------------------------------------------
def set_default_dtype(d):
    """Global default float dtype for creation APIs called with dtype=None
    (reference paddle.set_default_dtype)."""
    _fw_dtype.set_default_float(d)


def get_default_dtype():
    return _fw_dtype.dtype_name(_fw_dtype.default_float())


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """torch's print options, which govern tensor reprs."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth),
                            ("sci_mode", sci_mode)) if v is not None}
    torch.set_printoptions(**kw)


def get_cuda_rng_state():
    """The framework stream of every card (``framework/random.py``), one
    state each; empty without a card."""
    return [_fw_random.generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(states):
    for i, state in enumerate(states):
        _fw_random.generator(torch.device("cuda", i)).set_state(state)


def disable_signal_handler():
    """No-op: the reference unhooks its C++ signal handlers; this runtime
    installs none."""


def check_shape(shape):
    """Validate a creation-API shape (reference fluid data_feeder
    check_shape): ints, or a list/tuple of ints with at most one -1."""
    if isinstance(shape, int):
        shape = (shape,)
    enforce(isinstance(shape, (list, tuple)),
            f"shape must be int or list/tuple of int, got {type(shape)}")
    negs = 0
    for s in shape:
        enforce(isinstance(s, int), f"shape entries must be int, got {s!r}")
        negs += s < 0
    enforce(negs <= 1, f"at most one -1 allowed in shape, got {shape}")
    return tuple(shape)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Standalone Parameter (reference paddle.create_parameter), on the
    current device: the initializer is ``default_initializer``, else the
    ``ParamAttr``'s, else the global one, else ``Constant(0)`` for a bias
    and ``XavierUniform`` for a weight; the ``ParamAttr``'s ``trainable``
    is honoured."""
    from .nn import initializer as I
    shape = check_shape(shape)
    d = convert_dtype(dtype)
    trainable = True
    init = default_initializer
    if attr is not None:
        if getattr(attr, "initializer", None) is not None and init is None:
            init = attr.initializer
        trainable = getattr(attr, "trainable", True)
    if init is None:
        init = I._global_initializer["bias" if is_bias else "weight"]
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    val = init(shape, dtype=d, device=_dev())
    return Parameter(val, trainable=trainable, name=name or "",
                     is_bias=is_bias)


# paddle.DataParallel: the dp group's gradient all-reduce (a pass-through
# without a process group)
from .distributed.parallel import DataParallel  # noqa: E402


# the extended op corpus (reference tensor/{math,manipulation,search,
# random}.py long tail): see tensor_ops.py
from .tensor_ops import *  # noqa: F401,F403,E402
from .tensor_ops import scatter_last as _scatter_last  # noqa: E402


def inverse(x):
    """Matrix inverse (reference paddle.inverse == linalg.inv)."""
    return linalg.inv(x)


# the paddle methods torch.Tensor lacks, now that every functional op is
# importable
from .framework.tensor_methods import install_tensor_methods  # noqa: E402

install_tensor_methods()
