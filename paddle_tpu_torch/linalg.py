"""paddle.linalg of the port: ``paddle_tpu/linalg.py`` on ``torch.linalg``
(reference python/paddle/tensor/linalg.py).  On the card the
factorizations run in cuSOLVER and the products in cuBLAS, as XLA's
custom calls serve them in the JAX package; every function takes batched
inputs.

The JAX package's conventions are kept: ``lu`` returns 1-based pivots
(``torch.linalg.lu_factor``'s are already 1-based) and ``lu_unpack`` takes
them back; ``norm`` with ``axis=None`` is the 2-norm of the flattened
tensor for any rank; ``slogdet`` returns one stacked ``[sign, logabs]``
tensor; ``lstsq`` returns ``(solution, residuals, rank, singular_values)``
computed through the SVD as ``jnp.linalg.lstsq`` does;
``matrix_rank(hermitian=True)`` counts eigenvalues above the tolerance from
``eigvalsh``.  On the card every SVD (``svd``, ``lstsq``, ``pinv``,
``cond``, ``matrix_rank``) runs cuSOLVER's ``gesvd``: PyTorch's default
CUDA driver there, ``gesvdj``, leaves a residual ||A - U S Vh|| of 6e-4 of
||A|| on a 2048 x 2048 float32 Gaussian matrix, 2.5 x n x float32 eps,
where ``gesvd`` leaves 9e-6.  cuSOLVER and LAPACK factor float32 and float64 only: a
bfloat16 or float16 input is factored in float32 and its floating results
are rounded back to the input's dtype (``matrix_rank``, whose answer a
rounding of its input changes, raises there as the JAX package does).
"""
from __future__ import annotations

import functools

import torch

from .framework.dtype import as_tensor

__all__ = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det", "eig",
    "eigh", "eigvals", "eigvalsh", "inv", "lstsq", "lu", "matrix_power",
    "matrix_rank", "multi_dot", "norm", "pinv", "qr", "slogdet", "solve",
    "svd", "triangular_solve",
]


def _arr(x, like=None):
    return as_tensor(x, like=like)


def _svd(x, full_matrices: bool = False):
    """``torch.linalg.svd``, on the card through cuSOLVER's ``gesvd``
    (which takes m >= n: a wide matrix is factored as its adjoint)."""
    if not x.is_cuda:
        return torch.linalg.svd(x, full_matrices=full_matrices)
    if x.shape[-2] < x.shape[-1]:
        u, s, vh = torch.linalg.svd(x.mH, full_matrices=full_matrices,
                                    driver="gesvd")
        return vh.mH, s, u.mH
    return torch.linalg.svd(x, full_matrices=full_matrices, driver="gesvd")


def _svdvals(x):
    if not x.is_cuda:
        return torch.linalg.svdvals(x)
    return torch.linalg.svdvals(x.mH if x.shape[-2] < x.shape[-1] else x,
                                driver="gesvd")


def cholesky(x, upper: bool = False):
    return torch.linalg.cholesky(_arr(x), upper=upper)


def cholesky_solve(x, y, upper: bool = False):
    """Solve A @ out = x given y = the Cholesky factor of A."""
    return torch.cholesky_solve(_arr(x, (x, y)), _arr(y, (x, y)),
                                upper=upper)


def det(x):
    return torch.linalg.det(_arr(x))


def slogdet(x):
    sign, logabs = torch.linalg.slogdet(_arr(x))
    return torch.stack([sign, logabs])     # paddle returns one tensor


def eig(x):
    return tuple(torch.linalg.eig(_arr(x)))


def eigh(x, UPLO: str = "L"):
    return tuple(torch.linalg.eigh(_arr(x), UPLO=UPLO))


def eigvals(x):
    return torch.linalg.eigvals(_arr(x))


def eigvalsh(x, UPLO: str = "L"):
    return torch.linalg.eigvalsh(_arr(x), UPLO=UPLO)


def inv(x):
    return torch.linalg.inv(_arr(x))


def lstsq(x, y, rcond=None, driver=None):
    """Least squares through the SVD (``jnp.linalg.lstsq``): singular
    values at or below ``rcond`` x the largest are dropped (``rcond``
    defaults to eps x max(m, n)); the residuals are the squared norms of
    ``y - x @ solution``, by column, for any shape.  ``driver`` is
    accepted for the Paddle signature and ignored, as in the JAX package."""
    a, b = _arr(x, (x, y)), _arr(y, (x, y))
    vector = b.dim() == a.dim() - 1
    if vector:
        b = b.unsqueeze(-1)
    u, s, vh = _svd(a)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(a.shape[-2], a.shape[-1])
    keep = s > rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    uTb = u.mH @ b
    sol = vh.mH @ (s_inv.unsqueeze(-1).to(uTb.dtype) * uTb)
    rank = keep.sum(-1)
    resid = ((b - a @ sol).abs() ** 2).sum(-2)
    if vector:
        sol, resid = sol.squeeze(-1), resid.squeeze(-1)
    return sol, resid, rank, s


def lu(x, pivot: bool = True, get_infos: bool = False):
    """Packed LU and 1-based pivots (paddle.linalg.lu)."""
    lu_mat, piv, info = torch.linalg.lu_factor_ex(_arr(x), pivot=pivot)
    if get_infos:
        return lu_mat, piv, info
    return lu_mat, piv


def matrix_power(x, n: int):
    return torch.linalg.matrix_power(_arr(x), n)


def matrix_rank(x, tol=None, hermitian: bool = False):
    x = _arr(x)
    w = torch.abs(torch.linalg.eigvalsh(x)) if hermitian else _svdvals(x)
    if tol is None:
        tol = (w.amax(dim=-1, keepdim=True)
               * max(x.shape[-2], x.shape[-1])
               * torch.finfo(w.dtype).eps)
    else:
        tol = torch.as_tensor(tol, dtype=w.dtype, device=w.device)
        if tol.dim() > 0:
            tol = tol.unsqueeze(-1)
    return torch.sum(w > tol, dim=-1)


def multi_dot(xs):
    return torch.linalg.multi_dot([_arr(x, xs) for x in xs])


def norm(x, p=None, axis=None, keepdim: bool = False):
    x = _arr(x)
    if axis is None:
        # paddle: the 2-norm (Frobenius) of the flattened tensor, any rank
        out = torch.linalg.vector_norm(x.reshape(-1),
                                       ord=2 if p in (None, "fro") else p)
        return out.reshape((1,) * x.dim()) if keepdim else out
    if p is None:
        p = 2 if isinstance(axis, int) else "fro"
    if isinstance(axis, int):
        return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


def pinv(x, rcond=1e-15, hermitian: bool = False):
    """Singular values at or below ``rcond`` x the largest are dropped
    (``hermitian`` goes through ``eigh``)."""
    x = _arr(x)
    if hermitian:
        return torch.linalg.pinv(x, rtol=rcond, hermitian=True)
    u, s, vh = _svd(x)
    keep = s > rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.mH @ (s_inv.unsqueeze(-1).to(u.dtype) * u.mH)


def qr(x, mode: str = "reduced"):
    q, r = torch.linalg.qr(_arr(x), mode=mode)
    return r if mode == "r" else (q, r)


def solve(x, y):
    return torch.linalg.solve(_arr(x, (x, y)), _arr(y, (x, y)))


def svd(x, full_matrices: bool = False):
    return tuple(_svd(_arr(x), full_matrices=full_matrices))


def triangular_solve(x, y, upper: bool = True, transpose: bool = False,
                     unitriangular: bool = False):
    a, b = _arr(x, (x, y)), _arr(y, (x, y))
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def cond(x, p=None):
    """Condition number (paddle.linalg.cond)."""
    x = _arr(x)
    if p is None:
        p = 2
    if p in (2, -2):
        s = _svdvals(x)
        return (s[..., 0] / s[..., -1]) if p == 2 else (s[..., -1] / s[..., 0])
    return (torch.linalg.matrix_norm(x, ord=p)
            * torch.linalg.matrix_norm(torch.linalg.inv(x), ord=p))


def cov(x, rowvar: bool = True, ddof: bool = True, fweights=None,
        aweights=None):
    x = _arr(x)
    if not rowvar:
        x = x.mT
    if fweights is not None:
        fweights = _arr(fweights, x)
    if aweights is not None:
        aweights = _arr(aweights, x)
    return torch.cov(x, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


def corrcoef(x, rowvar: bool = True):
    x = _arr(x)
    return torch.corrcoef(x if rowvar else x.mT)


def lu_unpack(lu_data, lu_pivots, unpack_ludata: bool = True,
              unpack_pivots: bool = True):
    """``(P, L, U)`` of a :func:`lu` result, with ``P @ L @ U == A``
    (reference lu_unpack op); a part not asked for is None."""
    lu_data = _arr(lu_data)
    lu_pivots = _arr(lu_pivots, lu_data).to(torch.int32)
    P, L, U = torch.lu_unpack(lu_data, lu_pivots,
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None,
            U if unpack_ludata else None)


_HALF = (torch.bfloat16, torch.float16)


def _round_back(out, dtype):
    if isinstance(out, tuple):
        return tuple(_round_back(o, dtype) for o in out)
    if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
        return out.to(dtype)
    return out


def _float32_for_half(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        half = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                     and a.dtype in _HALF), None)
        if half is None:
            return fn(*args, **kwargs)
        args = [a.float() if isinstance(a, torch.Tensor) and a.dtype in _HALF
                else a for a in args]
        return _round_back(fn(*args, **kwargs), half)
    return wrapped


for _name in ("cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
              "eig", "eigh", "eigvals", "eigvalsh", "inv", "lstsq", "lu",
              "pinv", "qr", "slogdet", "solve", "svd",
              "triangular_solve", "lu_unpack"):
    globals()[_name] = _float32_for_half(globals()[_name])
del _name
