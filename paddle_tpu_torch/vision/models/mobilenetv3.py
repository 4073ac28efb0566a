"""MobileNetV3 Large and Small: the port of
``paddle_tpu/vision/models/mobilenetv3.py``.

V2's inverted residual plus squeeze-excite (on the pooled 1x1 map) and
hardswish / hardsigmoid.
"""
from __future__ import annotations

from typing import List, Tuple

from torch import nn as tnn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers import AdaptiveAvgPool2D, Conv2D, Dropout, Linear
from .mobilenetv2 import _make_divisible
from .utils import ConvNormActivation as ConvBNAct

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


class SqueezeExcite(tnn.Module):
    def __init__(self, ch: int, reduction: int = 4, device=None):
        super().__init__()
        squeezed = _make_divisible(ch // reduction)
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.reduce = Conv2D(ch, squeezed, 1, device=device)
        self.expand = Conv2D(squeezed, ch, 1, device=device)

    def forward(self, x):
        s = F.relu(self.reduce(self.pool(x)))
        return x * F.hardsigmoid(self.expand(s))


class InvertedResidualV3(tnn.Module):
    def __init__(self, in_ch: int, hidden: int, out_ch: int, kernel: int,
                 stride: int, use_se: bool, act: str, device=None):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers: List[tnn.Module] = []
        if hidden != in_ch:
            layers.append(ConvBNAct(in_ch, hidden, 1, act=act,
                                    device=device))
        layers.append(ConvBNAct(hidden, hidden, kernel, stride,
                                groups=hidden, act=act, device=device))
        if use_se:
            layers.append(SqueezeExcite(hidden, device=device))
        layers.append(ConvBNAct(hidden, out_ch, 1, act="none",
                                device=device))
        self.body = tnn.Sequential(*layers)

    def forward(self, x):
        out = self.body(x)
        return x + out if self.use_res else out


# (kernel, expanded, out, use_se, act, stride)
_LARGE: List[Tuple] = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2), (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2), (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL: List[Tuple] = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2), (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2), (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1), (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1), (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1), (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(tnn.Module):
    def __init__(self, settings: List[Tuple], last_exp: int, last_ch: int,
                 scale: float, num_classes: int, with_pool: bool, device):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool

        in_ch = _make_divisible(16 * scale)
        layers = [ConvBNAct(3, in_ch, 3, stride=2, act="hardswish",
                            device=dev)]
        for k, exp, out, se, act, s in settings:
            layers.append(InvertedResidualV3(
                in_ch, _make_divisible(exp * scale),
                _make_divisible(out * scale), k, s, se, act, device=dev))
            in_ch = _make_divisible(out * scale)
        exp_ch = _make_divisible(last_exp * scale)
        layers.append(ConvBNAct(in_ch, exp_ch, 1, act="hardswish",
                                device=dev))
        self.features = tnn.Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.head_fc = Linear(exp_ch, last_ch, device=dev)
            self.dropout = Dropout(0.2)
            self.fc = Linear(last_ch, num_classes, device=dev)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = F.hardswish(self.head_fc(F.flatten(x, 1)))
            x = self.fc(self.dropout(x))
        return x


class MobileNetV3Large(_MobileNetV3):
    """Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool,
                         device)


class MobileNetV3Small(_MobileNetV3):
    """Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool,
                         device)


def mobilenet_v3_small(scale: float = 1.0, **kw) -> MobileNetV3Small:
    return MobileNetV3Small(scale=scale, **kw)


def mobilenet_v3_large(scale: float = 1.0, **kw) -> MobileNetV3Large:
    return MobileNetV3Large(scale=scale, **kw)
