"""``paddle.onnx``, the port of ``paddle_tpu/onnx.py``: the same gate.

ONNX export needs the ``onnx`` package, which neither the build machine
nor the card's machine has, so ``export`` raises and names the port's
deployment path, ``paddle_tpu_torch.jit.save`` (a ``torch.export``
artifact that ``paddle_tpu_torch.inference`` runs).
"""
from __future__ import annotations

import importlib.util

__all__ = ["export", "onnx_available"]


def onnx_available() -> bool:
    return importlib.util.find_spec("onnx") is not None


def export(layer, path: str, input_spec=None, opset_version: int = 9,
           **configs):
    """Export ``layer`` to ONNX (reference onnx/export.py:21); needs the
    ``onnx`` package."""
    if not onnx_available():
        raise RuntimeError(
            "paddle_tpu_torch.onnx.export requires the 'onnx' package, "
            "which is not installed in this environment. Use "
            "paddle_tpu_torch.jit.save(layer, path, input_spec) to produce "
            "a torch.export serving artifact — the deployment format "
            "consumed by paddle_tpu_torch.inference.")
    raise NotImplementedError(
        "onnx graph building is not implemented; jit.save is the "
        "supported export path")
