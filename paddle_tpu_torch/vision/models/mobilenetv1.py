"""MobileNetV1: the port of ``paddle_tpu/vision/models/mobilenetv1.py``.

Depthwise-separable stack: a 3x3 depthwise conv (``groups`` = channels)
then a 1x1 pointwise one, each conv-BN-ReLU.
"""
from __future__ import annotations

from torch import nn as tnn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers import AdaptiveAvgPool2D, Linear
from .utils import ConvNormActivation

__all__ = ["MobileNetV1", "mobilenet_v1"]


class DepthwiseSeparable(tnn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.depthwise = ConvNormActivation(in_ch, in_ch, 3, stride,
                                            groups=in_ch, device=device)
        self.pointwise = ConvNormActivation(in_ch, out_ch, 1, device=device)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


# (out_channels, stride) per depthwise-separable block at scale=1.0
_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]


class MobileNetV1(tnn.Module):
    """Widths ``max(8, int(ch * scale))``; ``num_classes`` / ``with_pool``
    as the JAX class.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch: int) -> int:
            return max(8, int(ch * scale))

        layers = [ConvNormActivation(3, c(32), 3, stride=2, device=dev)]
        in_ch = c(32)
        for out, stride in _BLOCKS:
            layers.append(DepthwiseSeparable(in_ch, c(out), stride,
                                             device=dev))
            in_ch = c(out)
        self.features = tnn.Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(in_ch, num_classes, device=dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def mobilenet_v1(scale: float = 1.0, **kw) -> MobileNetV1:
    return MobileNetV1(scale=scale, **kw)
