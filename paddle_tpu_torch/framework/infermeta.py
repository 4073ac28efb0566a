"""Declarative shape / dtype validation: the port of
``paddle_tpu/framework/infermeta.py`` (reference paddle/phi/infermeta/).

Every rule validates input metas before the op runs and raises
``InvalidArgumentError`` with the offending shapes in the message, instead
of a fault deep inside a kernel.  The ``@infer_meta`` decorator attaches a
rule to an op; rules are composed from the combinators below.  Metas are
read from torch tensors, numpy arrays and anything ``np.asarray`` takes.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .errors import InvalidArgumentError, enforce

__all__ = ["infer_meta", "Meta", "meta_of", "require_rank",
           "require_rank_in", "require_dim_match", "require_same_rank",
           "require_broadcastable", "require_floating", "require_integer"]


class Meta:
    """Shape / dtype view of one argument (the DenseTensorMeta analog)."""

    __slots__ = ("shape", "dtype", "name")

    def __init__(self, shape, dtype, name: str):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return f"{self.name}: {_dtype_str(self.dtype)}{list(self.shape)}"


def _dtype_str(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _kind(dtype) -> str:
    """numpy's kind letter of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_complex:
            return "c"
        if dtype.is_floating_point:
            return "f"
        if dtype == torch.bool:
            return "b"
        return "u" if dtype == torch.uint8 else "i"
    return np.dtype(dtype).kind


def meta_of(x, name: str = "x") -> Optional[Meta]:
    """Meta of any array-like (tensor, Parameter, numpy, list)."""
    if x is None:
        return None
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return Meta(x.shape, x.dtype, name)
    arr = np.asarray(x)
    return Meta(arr.shape, arr.dtype, name)


def require_rank(m: Meta, rank: int, op: str) -> None:
    enforce(m.ndim == rank,
            f"{op}: {m.name} must be {rank}-D, got {m}",
            exc=InvalidArgumentError)


def require_rank_in(m: Meta, ranks: Sequence[int], op: str) -> None:
    enforce(m.ndim in tuple(ranks),
            f"{op}: {m.name} must have rank in {list(ranks)}, got {m}",
            exc=InvalidArgumentError)


def require_dim_match(a: Meta, da: int, b: Meta, db: int, op: str) -> None:
    enforce(a.shape[da] == b.shape[db],
            f"{op}: dim {da} of {a} must match dim {db} of {b}",
            exc=InvalidArgumentError)


def require_same_rank(a: Meta, b: Meta, op: str) -> None:
    enforce(a.ndim == b.ndim,
            f"{op}: rank mismatch between {a} and {b}",
            exc=InvalidArgumentError)


def require_broadcastable(a: Meta, b: Meta, op: str) -> None:
    try:
        np.broadcast_shapes(a.shape, b.shape)
    except ValueError:
        raise InvalidArgumentError(
            f"{op}: shapes not broadcastable: {a} vs {b}")


def require_floating(m: Meta, op: str) -> None:
    enforce(_kind(m.dtype) == "f",
            f"{op}: {m.name} must be floating, got {m}",
            exc=InvalidArgumentError)


def require_integer(m: Meta, op: str) -> None:
    enforce(_kind(m.dtype) in ("i", "u"),
            f"{op}: {m.name} must be integer, got {m}",
            exc=InvalidArgumentError)


def infer_meta(rule: Callable) -> Callable:
    """Attach a validation rule to an op: ``rule`` receives the op's
    arguments and raises ``InvalidArgumentError`` on bad metas; the op
    body runs unchanged afterwards.  ``fn.__infermeta__`` exposes the
    rule."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rule(*args, **kwargs)
            return fn(*args, **kwargs)
        wrapped.__infermeta__ = rule
        return wrapped
    return deco
