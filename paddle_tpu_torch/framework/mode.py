"""Global execution-mode state: the port of ``paddle_tpu/framework/mode.py``
(reference paddle.enable_static / disable_static / in_dynamic_mode,
fluid/framework.py; set_grad_enabled / is_grad_enabled,
fluid/dygraph/base.py).

Static mode is recorded state, as in the JAX package: there is one eager
code path, and ``in_dynamic_mode()`` answers as the reference would.  Grad
mode is torch's own (``torch.is_grad_enabled`` /
``torch.set_grad_enabled``), so ``paddle.no_grad``, ``torch.no_grad`` and
these functions share one source of truth.
"""
from __future__ import annotations

import torch

__all__ = ["enable_static", "disable_static", "in_dynamic_mode",
           "set_grad_enabled", "is_grad_enabled"]

_static_mode = False


def enable_static() -> None:
    """Record static mode (reference paddle.enable_static)."""
    global _static_mode
    _static_mode = True


def disable_static() -> None:
    global _static_mode
    _static_mode = False


def in_dynamic_mode() -> bool:
    return not _static_mode


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


set_grad_enabled = torch.set_grad_enabled
