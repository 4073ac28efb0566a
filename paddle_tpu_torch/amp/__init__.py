"""Automatic mixed precision: the port of ``paddle_tpu/amp/__init__.py``
``auto_cast`` (the O1 / O2 cast policy of :mod:`.state`).  GradScaler and
``decorate`` (O2 master weights) are not ported yet: bf16 O1, the training
slice's policy, needs neither."""
from __future__ import annotations

import contextlib

import torch

from ..framework.errors import enforce
from . import state as _state
from .state import BLACK_OPS, WHITE_OPS  # noqa: F401

__all__ = ["auto_cast", "WHITE_OPS", "BLACK_OPS"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@contextlib.contextmanager
def auto_cast(enable: bool = True, level: str = "O1",
              dtype: str = "bfloat16"):
    """Context under which white-listed ops run in ``dtype`` and
    black-listed ops in float32 (the custom white / black lists of the JAX
    ``auto_cast`` are not ported)."""
    enforce(level in ("O1", "O2"), f"level must be O1 or O2, got {level!r}")
    enforce(dtype in _DTYPES, f"unsupported amp dtype {dtype!r}")
    prev = _state.push(enable, level, _DTYPES[dtype])
    try:
        yield
    finally:
        _state.pop(prev)
