"""MobileNetV2: the port of ``paddle_tpu/vision/models/mobilenetv2.py``.

Inverted residual: 1x1 expand, 3x3 depthwise (``groups`` = channels), 1x1
linear projection, with a residual add when the stride is 1 and the
channels match.  Keys as the JAX model's (``features.1.body.0.conv.
weight``, ``features.2.project_bn._mean``, ``fc.weight``, ...).
"""
from __future__ import annotations

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Linear)
from .utils import ConvNormActivation

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:  # never round down by more than 10%
        new_v += divisor
    return new_v


def _conv_bn_relu6(in_ch, out_ch, kernel=3, stride=1, groups=1, device=None):
    return ConvNormActivation(in_ch, out_ch, kernel, stride, groups,
                              act="relu6", device=device)


class InvertedResidual(Layer):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 device=None):
        super().__init__()
        hidden = int(round(in_ch * expand))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand != 1:
            layers.append(_conv_bn_relu6(in_ch, hidden, 1, device=device))
        layers.append(_conv_bn_relu6(hidden, hidden, 3, stride,
                                     groups=hidden, device=device))
        self.body = Sequential(*layers)
        self.project = Conv2D(hidden, out_ch, 1, bias_attr=False,
                              device=device)
        self.project_bn = BatchNorm2D(out_ch, device=device)

    def forward(self, x):
        out = self.project_bn(self.project(self.body(x)))
        return x + out if self.use_res else out


# (expand_ratio, out_channels, repeats, first_stride) at scale=1.0
_SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(Layer):
    """``scale`` multiplies every width (rounded by ``_make_divisible``;
    the last conv keeps at least 1280 channels); ``num_classes=0`` drops
    the classifier and ``with_pool=False`` the global pool, as the JAX
    class.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        layers = [_conv_bn_relu6(3, in_ch, 3, stride=2, device=dev)]
        for t, c, n, s in _SETTINGS:
            out_ch = _make_divisible(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(
                    in_ch, out_ch, s if i == 0 else 1, t, device=dev))
                in_ch = out_ch
        layers.append(_conv_bn_relu6(in_ch, last_ch, 1, device=dev))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = Linear(last_ch, num_classes, device=dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(F.flatten(x, 1)))
        return x


def mobilenet_v2(scale: float = 1.0, **kw) -> MobileNetV2:
    return MobileNetV2(scale=scale, **kw)
