"""The paddle Tensor methods on ``torch.Tensor``: the port of
``paddle_tpu/framework/tensor_methods.py`` (reference
python/paddle/tensor/__init__.py, the ``monkey_patch_*`` of its Tensor).

The JAX package installs 191 paddle methods on its arrays, each a delegate
of a package-level op.  Its rule carries over: an attribute the tensor type
already has is never overridden.  ``torch.Tensor`` already has 149 of the
191 names, and they keep torch's meaning (``x.max(1)`` returns values and
indices, ``x.split(n)`` splits into pieces of size n, ``x.transpose`` swaps
two dims, ``x.flip`` takes a list of dims); the port installs the 42 it
lacks, each bound to the port's op with the tensor as the first argument.
An in-place name (``scale_``, ``put_along_axis_``, ``flatten_``,
``reshape_``) writes into the tensor and returns it.

``INSTALLED_METHODS`` lists the installed names.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["install_tensor_methods", "METHOD_NAMES", "INSTALLED_METHODS"]

# the JAX package's method table: its base methods and the reference
# ``tensor_method_func`` contract, in its order
_BASE_METHODS = [
    "numpy", "detach", "cpu", "cuda", "cast", "unsqueeze", "norm", "numel",
    "dim", "ndimension", "t", "expand", "tile", "gather", "allclose",
    "add", "subtract", "multiply", "divide", "matmul", "mm", "mod", "pow",
    "maximum", "minimum", "equal", "not_equal", "greater_than",
    "greater_equal", "less_than", "less_equal", "logical_and",
    "logical_or", "abs", "exp", "log", "sqrt", "rsqrt", "square", "tanh",
    "sigmoid", "floor", "ceil", "sign", "erf", "isnan", "isinf", "isfinite"
]

_REF_TENSOR_METHODS = [
    "matmul", "dot", "cov", "norm", "cond", "transpose", "lstsq", "dist",
    "t", "cross", "cholesky", "bmm", "histogram", "bincount", "mv",
    "matrix_power", "qr", "eigvals", "eigvalsh", "abs", "acos", "all",
    "any", "asin", "atan", "ceil", "ceil_", "cos", "cosh", "cumsum",
    "cumprod", "logit", "exp", "exp_", "floor", "floor_", "increment",
    "log", "log2", "log10", "logsumexp", "multiplex", "pow", "prod",
    "reciprocal", "reciprocal_", "round", "round_", "rsqrt", "rsqrt_",
    "scale", "scale_", "sign", "sin", "sinh", "sqrt", "sqrt_", "square",
    "stanh", "sum", "nansum", "nanmean", "tanh", "tanh_", "add_n", "max",
    "amax", "maximum", "min", "amin", "minimum", "fmax", "fmin", "mm",
    "inner", "outer", "divide", "floor_divide", "remainder", "mod",
    "floor_mod", "multiply", "add", "add_", "subtract", "subtract_",
    "atan", "logsumexp", "inverse", "log1p", "erf", "addmm", "clip",
    "clip_", "trace", "kron", "kthvalue", "isfinite", "isinf", "isnan",
    "broadcast_shape", "conj", "neg", "lgamma", "equal", "equal_all",
    "greater_equal", "greater_than", "is_empty", "less_equal", "less_than",
    "logical_and", "logical_not", "logical_or", "logical_xor", "not_equal",
    "allclose", "isclose", "is_tensor", "cast", "concat", "expand",
    "broadcast_to", "expand_as", "flatten", "flatten_", "gather",
    "gather_nd", "reshape", "reshape_", "reverse", "scatter", "scatter_",
    "scatter_nd_add", "scatter_nd", "shard_index", "slice", "split",
    "chunk", "tensordot", "squeeze", "squeeze_", "stack", "strided_slice",
    "transpose", "unique", "unique_consecutive", "unsqueeze", "unsqueeze_",
    "unstack", "flip", "rot90", "unbind", "roll", "tile", "argmax",
    "argmin", "argsort", "masked_select", "topk", "where", "index_select",
    "nonzero", "sort", "index_sample", "mean", "std", "var", "numel",
    "median", "quantile", "is_complex", "is_integer", "rank", "shape",
    "real", "imag", "is_floating_point", "digamma", "diagonal", "trunc",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "broadcast_tensors", "eig", "uniform_", "multi_dot", "solve",
    "cholesky_solve", "triangular_solve", "asinh", "atanh", "acosh", "lu",
    "lu_unpack", "as_complex", "as_real", "rad2deg", "deg2rad", "gcd",
    "lcm", "diff", "mode", "lerp", "lerp_", "erfinv", "erfinv_", "angle",
    "moveaxis", "repeat_interleave", "take_along_axis", "put_along_axis",
    "put_along_axis_", "exponential_"
]

METHOD_NAMES = list(dict.fromkeys(_BASE_METHODS + _REF_TENSOR_METHODS))

INSTALLED_METHODS: list = []


def _resolve(name):
    """The port's op a method name delegates to, as the JAX package
    resolves it: the top-level op, else the ``linalg`` one, else (for
    ``name_``) the base op's; ``(function, in_place)``."""
    import paddle_tpu_torch as pt
    for mod in (pt, pt.linalg):
        fn = getattr(mod, name, None)
        if callable(fn) and not isinstance(fn, type):
            return fn, False
    if name.endswith("_"):
        fn, _ = _resolve(name[:-1])
        return fn, fn is not None
    return None, False


def _delegate(fn, name):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = method.__qualname__ = name
    return method


def _in_place(fn, name):
    """``name_``: the base op's result written into the tensor."""
    def method(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        if tuple(out.shape) != tuple(self.shape):
            from ..tensor_ops import reshape_
            reshape_(self, tuple(out.shape))
        with contextlib.nullcontext() if self.requires_grad \
                else torch.no_grad():
            self.copy_(out)
        return self
    method.__name__ = method.__qualname__ = name
    return method


def install_tensor_methods() -> None:
    """Install every method of the table that ``torch.Tensor`` lacks;
    existing attributes are never touched.  Runs once, at the end of the
    package's ``__init__``, when every op is importable."""
    for name in METHOD_NAMES:
        if hasattr(torch.Tensor, name):
            continue
        fn, in_place = _resolve(name)
        if fn is None:
            continue
        setattr(torch.Tensor, name,
                _in_place(fn, name) if in_place else _delegate(fn, name))
        INSTALLED_METHODS.append(name)
