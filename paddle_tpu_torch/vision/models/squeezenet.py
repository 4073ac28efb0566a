"""SqueezeNet 1.0 and 1.1: the port of
``paddle_tpu/vision/models/squeezenet.py``.

Fire module: a 1x1 squeeze, then parallel 1x1 and 3x3 expands
concatenated on channels; the classifier is a 1x1 conv and a global
average pool.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from ...framework.errors import enforce
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D,
                          ReLU)

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(Layer):
    def __init__(self, in_ch: int, squeeze: int, expand1x1: int,
                 expand3x3: int, device=None):
        super().__init__()
        self.squeeze = Conv2D(in_ch, squeeze, 1, device=device)
        self.expand1x1 = Conv2D(squeeze, expand1x1, 1, device=device)
        self.expand3x3 = Conv2D(squeeze, expand3x3, 3, padding=1,
                                device=device)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat(
            [F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], dim=1)


class SqueezeNet(Layer):
    """``version`` ``"1.0"`` or ``"1.1"``; ``num_classes`` / ``with_pool``
    as the JAX class.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        enforce(version in ("1.0", "1.1"),
                f"unsupported SqueezeNet version {version!r}", exc=ValueError)
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def fire(*chans):
            return Fire(*chans, device=dev)
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, device=dev), ReLU(),
                MaxPool2D(3, stride=2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128),
                MaxPool2D(3, stride=2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                MaxPool2D(3, stride=2),
                fire(512, 64, 256, 256),
            )
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, device=dev), ReLU(),
                MaxPool2D(3, stride=2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                MaxPool2D(3, stride=2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                MaxPool2D(3, stride=2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier_drop = Dropout(0.5)
            self.classifier_conv = Conv2D(512, num_classes, 1, device=dev)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = F.relu(self.classifier_conv(self.classifier_drop(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
        return x


def squeezenet1_0(**kw) -> SqueezeNet:
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw) -> SqueezeNet:
    return SqueezeNet("1.1", **kw)
