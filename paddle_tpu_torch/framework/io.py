"""Checkpoint save / load of state dicts: the port of ``paddle_tpu/
framework/io.py`` (reference: python/paddle/framework/io.py -
paddle.save:568 / paddle.load:784), in the JAX package's pickle format,
so a ``.pdparams`` / ``.pdopt`` written by either package loads in the
other.

The pickle holds a tree (dicts, lists, tuples) whose leaves are numpy
arrays and Python values; a bfloat16 leaf, which numpy cannot hold, is a
``_BF16`` marker object wrapping its float32 widening.  The JAX package's
pickle names that class ``paddle_tpu.framework.io._BF16``; this module
writes the same name (without importing the JAX package: the pickler
emits the name itself) and reads it, and its own, through an
``Unpickler.find_class`` that maps both to the port's copy and refuses
every other class of the JAX package or of JAX.

The pickle is staged into ``path + ".tmp"`` (fsync'd) and ``os.replace``d
into place, so a crash mid-save never leaves a torn file at ``path``;
transient I/O errors are absorbed under :data:`IO_RETRY_POLICY`.
"""
from __future__ import annotations

import io as _io
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..utils import fsio
from ..utils.retry import RetryPolicy, retry_call
from ..utils.tree import tree_map

__all__ = ["save", "load", "IO_RETRY_POLICY"]

#: retry schedule of pickle checkpoint I/O (module level, so tests and the
#: fault harness can swap in a sleepless policy)
IO_RETRY_POLICY = RetryPolicy(max_attempts=4, base_delay=0.05)

#: the JAX package's name of the bfloat16 marker class
_JAX_BF16 = ("paddle_tpu.framework.io", "_BF16")


class _BF16:
    """A bfloat16 leaf, stored as its float32 widening (exact)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr


def _to_host(obj):
    def conv(x):
        if torch.is_tensor(x):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                return _BF16(x.float().cpu().numpy())
            return x.cpu().numpy()
        return x
    return tree_map(conv, obj)


def _from_host(obj):
    def conv(x):
        if isinstance(x, _BF16):
            return torch.from_numpy(np.asarray(x.arr, np.float32)).to(
                torch.bfloat16)
        if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
            return torch.from_numpy(np.ascontiguousarray(x))
        return x
    return tree_map(conv, obj)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler with one change: the port's ``_BF16`` is
    written under the JAX package's module name, so the JAX package's
    ``pickle.loads`` finds its own class."""

    def save_global(self, obj, name=None):
        if obj is _BF16:
            self.save(_JAX_BF16[0])
            self.save(_JAX_BF16[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)

    dispatch = dict(pickle._Pickler.dispatch)
    dispatch[type] = save_global


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in (_JAX_BF16, (__name__, "_BF16")):
            return _BF16
        root = module.split(".")[0]
        if root in ("jax", "jaxlib", "paddle_tpu"):
            raise pickle.UnpicklingError(
                f"{module}.{name}: a class of the JAX package or of JAX; "
                "the port reads numpy arrays, Python values and bfloat16 "
                "markers only")
        return super().find_class(module, name)


def _dumps(obj, protocol: int) -> bytes:
    buf = _io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """paddle.save analog: pickle a (nested) state dict of tensors,
    arrays and Python values to ``path``, atomically."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _dumps(_to_host(obj), protocol)
    retry_call(fsio.atomic_write_bytes, path, payload,
               policy=IO_RETRY_POLICY)


def load(path: str, return_numpy: bool = False) -> Any:
    """paddle.load analog: CPU tensors (bfloat16 leaves as
    ``torch.bfloat16``), or with ``return_numpy`` numpy arrays (bfloat16
    leaves as their float32 widening, as the JAX package returns them)."""
    obj = _Unpickler(_io.BytesIO(retry_call(
        fsio.read_bytes, path, policy=IO_RETRY_POLICY))).load()
    if return_numpy:
        return tree_map(lambda x: x.arr if isinstance(x, _BF16) else x,
                        obj)
    return _from_host(obj)
