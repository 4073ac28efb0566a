"""``ConvNormActivation``, the block every mobile and shuffle architecture
stamps out: the port of ``paddle_tpu/vision/models/utils.py``."""
from __future__ import annotations

from torch import nn as tnn

from ...framework.errors import enforce
from ...nn import functional as F
from ...nn.layers import BatchNorm2D, Conv2D

__all__ = ["ConvNormActivation"]

_ACTS = {"relu": F.relu, "relu6": F.relu6, "hardswish": F.hardswish,
         "swish": F.silu, "none": None}


class ConvNormActivation(tnn.Module):
    """Conv2D (same padding, no bias) + BatchNorm2D + the activation
    ``act`` (``"relu"``, ``"relu6"``, ``"hardswish"``, ``"swish"`` or
    ``"none"``).  Keys ``conv.weight``, ``bn.weight``, ``bn._mean``, ..."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: str = "relu",
                 device=None):
        super().__init__()
        enforce(act in _ACTS, f"unsupported activation {act!r}",
                exc=ValueError)
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=(kernel - 1) // 2, groups=groups,
                           bias_attr=False, device=device)
        self.bn = BatchNorm2D(out_ch, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        fn = _ACTS[self.act]
        return fn(x) if fn is not None else x
