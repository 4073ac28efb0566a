"""``paddle.sparse``: the port of ``paddle_tpu/sparse/__init__.py``
(reference python/paddle/sparse and the phi sparse kernels: dense <-> COO
<-> CSR conversions, value-wise unaries, matmul / masked matmul, softmax).

:class:`SparseTensor` holds a torch sparse tensor in the layout it was
made in: ``torch.sparse_coo`` (indices in the order given, duplicates
allowed, as the JAX BCOO) or ``torch.sparse_csr``.  On the card the
products run on cuSPARSE: sparse @ dense (``matmul`` / ``mv`` /
``addmm``), the CSR mask's SDDMM (``masked_matmul``); a COO mask's SDDMM
gathers its rows and columns.  The row ``softmax`` runs over the stored
entries only (implicit zeros are no part of the distribution), by
segment max and sum, the JAX formula.

Differences by design: indices are int64 (torch's sparse index type;
the JAX BCOO's are int32), and ``coalesce`` / ``add`` / ``subtract``
return exactly the distinct entries, sorted row-major as the JAX
``_sorted`` order, where the JAX ops keep the input's static entry count
and pad it with out-of-range entries.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import torch

from ..framework.dtype import as_tensor, convert_dtype
from ..framework.errors import enforce

__all__ = [
    "SparseTensor", "sparse_coo_tensor", "sparse_csr_tensor", "is_sparse",
    "to_dense", "to_sparse_coo", "to_sparse_csr", "coalesce",
    "add", "subtract", "multiply", "divide", "matmul", "masked_matmul",
    "mv", "addmm", "transpose", "softmax",
    "relu", "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
    "sqrt", "square", "log1p", "abs", "expm1", "neg", "pow", "cast",
    "nn",
]


def _csr(crows, cols, values, shape) -> torch.Tensor:
    with warnings.catch_warnings():   # torch's "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crows, cols, values, size=shape,
                                       check_invariants=False)


def _coo(indices, values, shape) -> torch.Tensor:
    return torch.sparse_coo_tensor(indices, values, size=shape,
                                   check_invariants=False)


def _sorted_order(indices: torch.Tensor, shape) -> torch.Tensor:
    """The stable row-major order of COO ``indices`` (ndim, nnz)."""
    key = (indices[0] * shape[1] + indices[1] if len(shape) == 2
           else indices[0])
    return torch.argsort(key, stable=True)


class SparseTensor:
    """A torch COO or CSR tensor with the paddle surface (``indices`` /
    ``values`` / ``crows`` / ``cols`` / ``to_dense`` / ``nnz``; ``layout``
    is ``"coo"`` or ``"csr"``)."""

    def __init__(self, tensor: torch.Tensor, layout: str = "coo"):
        enforce(layout in ("coo", "csr"), f"unknown layout {layout!r}")
        want = torch.sparse_coo if layout == "coo" else torch.sparse_csr
        enforce(tensor.layout == want,
                f"a {layout} SparseTensor needs a {want} tensor")
        self._t = tensor
        self.layout = layout

    # -- paddle surface ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def device(self):
        return self._t.device

    def tensor(self) -> torch.Tensor:
        """The torch sparse tensor."""
        return self._t

    def indices(self) -> torch.Tensor:
        """(ndim, nnz) int64, in stored order."""
        if self.layout == "coo":
            return self._t._indices()
        crows = self._t.crow_indices()
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=crows.device),
            torch.diff(crows))
        return torch.stack([rows, self._t.col_indices()])

    def values(self) -> torch.Tensor:
        return self._t._values() if self.layout == "coo" else self._t.values()

    def _row_major(self):
        """(indices, values) sorted row-major (stable)."""
        idx, vals = self.indices(), self.values()
        if self.layout == "csr":
            return idx, vals
        order = _sorted_order(idx, self.shape)
        return idx[:, order], vals[order]

    def crows(self) -> torch.Tensor:
        """The CSR row pointers, consistent with :meth:`cols` /
        :meth:`csr_values` whatever the stored order."""
        enforce(self.ndim == 2, "crows() needs a 2-d sparse tensor")
        if self.layout == "csr":
            return self._t.crow_indices()
        rows = self._row_major()[0][0]
        counts = torch.bincount(rows, minlength=self.shape[0])
        return torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=rows.device),
                          torch.cumsum(counts, 0)])

    def cols(self) -> torch.Tensor:
        enforce(self.ndim == 2, "cols() needs a 2-d sparse tensor")
        return self._row_major()[0][1]

    def csr_values(self) -> torch.Tensor:
        """The values in the order of :meth:`crows` / :meth:`cols`."""
        enforce(self.ndim == 2, "csr_values() needs a 2-d sparse tensor")
        return self._row_major()[1]

    def nnz(self) -> int:
        return int(self.values().shape[0])

    def to_dense(self) -> torch.Tensor:
        """The dense tensor; duplicate COO entries sum."""
        return self._t.to_dense()

    def to_sparse_csr(self) -> "SparseTensor":
        if self.layout == "csr":
            return self
        idx, vals = self._row_major()
        return SparseTensor(_csr(self.crows(), idx[1], vals, self.shape),
                            layout="csr")

    def to_sparse_coo(self, sparse_dim: Optional[int] = None
                      ) -> "SparseTensor":
        if self.layout == "coo":
            return self
        return SparseTensor(_coo(self.indices(), self.values(), self.shape),
                            layout="coo")

    def astype(self, dtype):
        return cast(self, dtype)

    def __repr__(self):
        return (f"SparseTensor(layout={self.layout}, shape={self.shape}, "
                f"nnz={self.nnz()})")


def _with_values(x: SparseTensor, vals: torch.Tensor) -> SparseTensor:
    """``x``'s pattern and layout with new values."""
    if x.layout == "csr":
        t = x.tensor()
        return SparseTensor(_csr(t.crow_indices(), t.col_indices(), vals,
                                 x.shape), layout="csr")
    return SparseTensor(_coo(x.indices(), vals, x.shape), layout="coo")


def _in_layout(idx, vals, shape, layout) -> SparseTensor:
    """Row-major sorted (indices, values) as a tensor of ``layout``."""
    t = SparseTensor(_coo(idx, vals, shape), layout="coo")
    return t.to_sparse_csr() if layout == "csr" else t


def sparse_coo_tensor(indices, values, shape: Sequence[int],
                      dtype=None) -> SparseTensor:
    """paddle.sparse.sparse_coo_tensor(indices (ndim, nnz), values)."""
    vals = as_tensor(values, like=[indices], dtype=convert_dtype(dtype))
    idx = as_tensor(indices, like=vals, dtype=torch.int64)
    return SparseTensor(_coo(idx, vals, tuple(shape)), layout="coo")


def sparse_csr_tensor(crows, cols, values, shape: Sequence[int],
                      dtype=None) -> SparseTensor:
    """paddle.sparse.sparse_csr_tensor."""
    vals = as_tensor(values, like=[crows, cols], dtype=convert_dtype(dtype))
    return SparseTensor(_csr(as_tensor(crows, like=vals, dtype=torch.int64),
                             as_tensor(cols, like=vals, dtype=torch.int64),
                             vals, tuple(shape)), layout="csr")


def is_sparse(x) -> bool:
    return isinstance(x, SparseTensor)


def to_dense(x):
    return x.to_dense() if is_sparse(x) else as_tensor(x)


def to_sparse_coo(x, sparse_dim: Optional[int] = None) -> SparseTensor:
    """Dense -> COO over the nonzeros, row-major."""
    return SparseTensor(as_tensor(x).to_sparse().coalesce(), layout="coo")


def to_sparse_csr(x) -> SparseTensor:
    """Dense -> CSR over the nonzeros."""
    return to_sparse_coo(x).to_sparse_csr()


def coalesce(x: SparseTensor) -> SparseTensor:
    """Sum duplicate entries; the distinct entries come out row-major."""
    t = x.to_sparse_coo().tensor().coalesce()
    return _in_layout(t.indices(), t.values(), x.shape, x.layout)


# ---------------------------------------------------------------------------
# Elementwise sparse (x) sparse: the union pattern for + and -, the first
# operand's pattern for * and /
# ---------------------------------------------------------------------------
def add(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    t = (a.to_sparse_coo().tensor() + b.to_sparse_coo().tensor()).coalesce()
    return _in_layout(t.indices(), t.values(), a.shape, a.layout)


def subtract(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    t = (a.to_sparse_coo().tensor() - b.to_sparse_coo().tensor()).coalesce()
    return _in_layout(t.indices(), t.values(), a.shape, a.layout)


def _at_pattern(a: SparseTensor, b):
    ca = coalesce(a)
    idx = ca.indices()
    return ca, to_dense(b)[tuple(idx)]


def multiply(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Elementwise product, zero wherever ``a`` is: ``b`` read densely at
    ``a``'s coalesced pattern."""
    ca, bv = _at_pattern(a, b)
    return _with_values(ca, ca.values() * bv)


def divide(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    ca, bv = _at_pattern(a, b)
    return _with_values(ca, ca.values() / bv)


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------
def matmul(a, b):
    """sparse @ dense or dense @ sparse -> dense (cuSPARSE on the card)."""
    if is_sparse(a):
        return a.tensor() @ to_dense(b)
    if is_sparse(b):
        # dense @ sparse = (sparse^T @ dense^T)^T
        return (transpose(b).tensor() @ as_tensor(a).transpose(0, 1)
                ).transpose(0, 1)
    return as_tensor(a) @ as_tensor(b)


def mv(a: SparseTensor, x) -> torch.Tensor:
    """sparse matrix x dense vector."""
    return (a.tensor() @ as_tensor(x)[:, None])[:, 0]


def addmm(input, x: SparseTensor, y, beta: float = 1.0,
          alpha: float = 1.0) -> torch.Tensor:
    """beta * input + alpha * (x @ y)."""
    return beta * as_tensor(input) + alpha * matmul(x, y)


def masked_matmul(a, b, mask: SparseTensor) -> SparseTensor:
    """(a @ b) sampled at ``mask``'s pattern (SDDMM), in ``mask``'s
    layout and entry order: cuSPARSE's SDDMM for a CSR mask
    (``torch.sparse.sampled_addmm``), row and column gathers for a COO
    one."""
    a, b = as_tensor(a), as_tensor(b)
    if mask.layout == "csr":
        t = mask.tensor()
        zero = _csr(t.crow_indices(), t.col_indices(),
                    torch.zeros_like(t.values(), dtype=a.dtype), mask.shape)
        return SparseTensor(torch.sparse.sampled_addmm(zero, a, b, beta=0.0),
                            layout="csr")
    rows, cols = mask.indices()
    vals = torch.einsum("nk,nk->n", a[rows, :], b[:, cols].transpose(0, 1))
    return _with_values(mask, vals)


def transpose(x: SparseTensor, perm: Optional[Sequence[int]] = None
              ) -> SparseTensor:
    """The 2-d transpose, its entries sorted row-major."""
    enforce(x.ndim == 2, "sparse transpose supports 2-d tensors")
    if perm is not None:
        perm = list(perm)
        enforce(sorted(perm) == [0, 1], f"invalid perm {perm} for 2-d")
        if perm == [0, 1]:   # the identity
            return x
    idx = x.indices().flip(0)
    shape = (x.shape[1], x.shape[0])
    order = _sorted_order(idx, shape)
    return _in_layout(idx[:, order], x.values()[order], shape, x.layout)


def softmax(x: SparseTensor, axis: int = -1) -> SparseTensor:
    """Row softmax over the stored values only, of the coalesced tensor:
    the JAX segment max / sum formula."""
    enforce(x.ndim == 2 and axis in (-1, 1),
            "sparse softmax: 2-d, last axis")
    c = coalesce(x)
    rows = c.indices()[0]
    vals = c.values()
    n = x.shape[0]
    m = torch.full((n,), -torch.inf, dtype=vals.dtype, device=vals.device)
    m = m.scatter_reduce(0, rows, vals, reduce="amax", include_self=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(vals - m[rows])
    z = torch.zeros((n,), dtype=vals.dtype,
                    device=vals.device).index_add_(0, rows, e)
    return _with_values(c, e / torch.clamp(z[rows], min=1e-30))


# ---------------------------------------------------------------------------
# Value-wise unaries (the phi sparse activation family): the stored values
# change, the pattern stays (f(0) = 0 functions, as the reference's set)
# ---------------------------------------------------------------------------
def _valuewise(name: str, fn: Callable) -> Callable:
    def op(x: SparseTensor, *args) -> SparseTensor:
        return _with_values(x, fn(x.values(), *args))
    op.__name__ = name
    op.__doc__ = f"sparse.{name}: value-wise (pattern preserved)."
    return op


relu = _valuewise("relu", torch.relu)
sin = _valuewise("sin", torch.sin)
tan = _valuewise("tan", torch.tan)
asin = _valuewise("asin", torch.asin)
atan = _valuewise("atan", torch.atan)
sinh = _valuewise("sinh", torch.sinh)
tanh = _valuewise("tanh", torch.tanh)
asinh = _valuewise("asinh", torch.asinh)
atanh = _valuewise("atanh", torch.atanh)
sqrt = _valuewise("sqrt", torch.sqrt)
square = _valuewise("square", torch.square)
log1p = _valuewise("log1p", torch.log1p)
abs = _valuewise("abs", torch.abs)
expm1 = _valuewise("expm1", torch.expm1)
neg = _valuewise("neg", torch.neg)
pow = _valuewise("pow", lambda v, p: torch.pow(v, p))
cast = _valuewise("cast", lambda v, dt: v.to(convert_dtype(dt)))


# ---------------------------------------------------------------------------
# sparse.nn: ReLU and the attention built from the ops above (SDDMM ->
# sparse softmax -> SpMM)
# ---------------------------------------------------------------------------
class _SparseNNFunctional:
    @staticmethod
    def relu(x: SparseTensor) -> SparseTensor:
        return relu(x)

    @staticmethod
    def attention(query, key, value, sparse_mask: SparseTensor,
                  scale: Optional[float] = None) -> torch.Tensor:
        """Single-head attention at ``sparse_mask``'s pattern: scores by
        :func:`masked_matmul` of q and k^T, the row :func:`softmax` over
        the stored entries, then sparse @ v."""
        q = as_tensor(query)
        k = as_tensor(key, like=q)
        if scale is None:
            scale = q.shape[-1] ** -0.5
        s = masked_matmul(q * scale, k.transpose(0, 1), sparse_mask)
        return matmul(softmax(s), as_tensor(value, like=q))


class _ReLULayer:
    """paddle.sparse.ReLU."""

    def __call__(self, x: SparseTensor) -> SparseTensor:
        return relu(x)

    def forward(self, x: SparseTensor) -> SparseTensor:
        return relu(x)


class _SparseNN:
    ReLU = _ReLULayer
    functional = _SparseNNFunctional


nn = _SparseNN
ReLU = _ReLULayer
