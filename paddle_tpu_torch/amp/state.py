"""AMP policy state consulted by the functional ops: the port of
``paddle_tpu/amp/state.py``.

The port keeps the JAX package's own cast policy rather than
``torch.autocast``, so it casts exactly where the JAX package casts: under
O1, the white-list ops (``linear``, ``matmul``, ``attention``, ...) take
their floating inputs down to the low dtype, and the black-list ops
(``layer_norm``, ``softmax``, ``cross_entropy``, ...) take them up to
float32.  Ops call :func:`cast_for_op` on their inputs; outside
``auto_cast`` it returns them unchanged.  The state is thread-local.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["WHITE_OPS", "BLACK_OPS", "push", "pop", "cast_for_op"]

WHITE_OPS = {  # compute in low precision (tensor-core bound)
    "matmul", "linear", "conv2d", "einsum", "attention",
}
BLACK_OPS = {  # keep float32 (numerically sensitive)
    "softmax", "log_softmax", "layer_norm", "batch_norm", "cross_entropy",
    "mean", "sum", "exp", "log", "norm", "cumsum",
}

_tls = threading.local()


class _AmpState:
    __slots__ = ("enabled", "level", "dtype")

    def __init__(self, enabled=False, level="O1", dtype=torch.bfloat16):
        self.enabled = enabled
        self.level = level
        self.dtype = dtype


def _get() -> _AmpState:
    st = getattr(_tls, "amp", None)
    if st is None:
        st = _AmpState()
        _tls.amp = st
    return st


def push(enabled: bool, level: str, dtype: torch.dtype) -> _AmpState:
    prev = _get()
    _tls.amp = _AmpState(enabled, level, dtype)
    return prev


def pop(prev: _AmpState) -> None:
    _tls.amp = prev


def cast_for_op(op_name: str, *xs):
    """Cast floating tensors per the active policy; returns the inputs
    (possibly cast), one tensor for one input."""
    st = _get()
    if not st.enabled:
        return xs if len(xs) > 1 else xs[0]
    if op_name in BLACK_OPS:
        to = torch.float32
    elif op_name in WHITE_OPS or st.level == "O2":
        # O1: cast white-list ops down.  O2: everything not black-listed.
        to = st.dtype
    else:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(to) if torch.is_tensor(x) and x.is_floating_point()
                else x for x in xs)
    return out if len(out) > 1 else out[0]
