"""Inception-v3: the port of ``paddle_tpu/vision/models/inceptionv3.py``
(299 x 299 ImageNet input; 75 x 75 is the smallest it takes).

Factorised convolutions (n x 1 / 1 x n towers), grid-reduction blocks,
BatchNorm after every conv.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn as tnn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                          Dropout, Linear, MaxPool2D)

__all__ = ["InceptionV3", "inception_v3"]


class _Conv(Layer):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 device=None):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, bias_attr=False, device=device)
        self.bn = BatchNorm2D(out_ch, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(Layer):
    """35 x 35 block: 1x1 / 5x5 / double-3x3 / pool towers."""

    def __init__(self, in_ch: int, pool_ch: int, device=None):
        super().__init__()
        d = device
        self.b1 = _Conv(in_ch, 64, 1, device=d)
        self.b5_1 = _Conv(in_ch, 48, 1, device=d)
        self.b5_2 = _Conv(48, 64, 5, padding=2, device=d)
        self.b3_1 = _Conv(in_ch, 64, 1, device=d)
        self.b3_2 = _Conv(64, 96, 3, padding=1, device=d)
        self.b3_3 = _Conv(96, 96, 3, padding=1, device=d)
        self.pool = AvgPool2D(3, stride=1, padding=1)
        self.bp = _Conv(in_ch, pool_ch, 1, device=d)

    def forward(self, x):
        return torch.cat(
            [self.b1(x), self.b5_2(self.b5_1(x)),
             self.b3_3(self.b3_2(self.b3_1(x))), self.bp(self.pool(x))],
            dim=1)


class ReductionA(Layer):
    """35 -> 17 grid reduction."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        d = device
        self.b3 = _Conv(in_ch, 384, 3, stride=2, device=d)
        self.d3_1 = _Conv(in_ch, 64, 1, device=d)
        self.d3_2 = _Conv(64, 96, 3, padding=1, device=d)
        self.d3_3 = _Conv(96, 96, 3, stride=2, device=d)
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat(
            [self.b3(x), self.d3_3(self.d3_2(self.d3_1(x))), self.pool(x)],
            dim=1)


class InceptionB(Layer):
    """17 x 17 block with 1x7 / 7x1 factorised towers."""

    def __init__(self, in_ch: int, mid: int, device=None):
        super().__init__()
        d = device
        self.b1 = _Conv(in_ch, 192, 1, device=d)
        self.b7_1 = _Conv(in_ch, mid, 1, device=d)
        self.b7_2 = _Conv(mid, mid, (1, 7), padding=(0, 3), device=d)
        self.b7_3 = _Conv(mid, 192, (7, 1), padding=(3, 0), device=d)
        self.d7_1 = _Conv(in_ch, mid, 1, device=d)
        self.d7_2 = _Conv(mid, mid, (7, 1), padding=(3, 0), device=d)
        self.d7_3 = _Conv(mid, mid, (1, 7), padding=(0, 3), device=d)
        self.d7_4 = _Conv(mid, mid, (7, 1), padding=(3, 0), device=d)
        self.d7_5 = _Conv(mid, 192, (1, 7), padding=(0, 3), device=d)
        self.pool = AvgPool2D(3, stride=1, padding=1)
        self.bp = _Conv(in_ch, 192, 1, device=d)

    def forward(self, x):
        t7 = self.b7_3(self.b7_2(self.b7_1(x)))
        d7 = self.d7_5(self.d7_4(self.d7_3(self.d7_2(self.d7_1(x)))))
        return torch.cat([self.b1(x), t7, d7, self.bp(self.pool(x))], dim=1)


class ReductionB(Layer):
    """17 -> 8 grid reduction."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        d = device
        self.b3_1 = _Conv(in_ch, 192, 1, device=d)
        self.b3_2 = _Conv(192, 320, 3, stride=2, device=d)
        self.b7_1 = _Conv(in_ch, 192, 1, device=d)
        self.b7_2 = _Conv(192, 192, (1, 7), padding=(0, 3), device=d)
        self.b7_3 = _Conv(192, 192, (7, 1), padding=(3, 0), device=d)
        self.b7_4 = _Conv(192, 192, 3, stride=2, device=d)
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat(
            [self.b3_2(self.b3_1(x)),
             self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))), self.pool(x)],
            dim=1)


class InceptionC(Layer):
    """8 x 8 block with branched 1x3 / 3x1 towers."""

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        d = device
        self.b1 = _Conv(in_ch, 320, 1, device=d)
        self.b3_0 = _Conv(in_ch, 384, 1, device=d)
        self.b3_a = _Conv(384, 384, (1, 3), padding=(0, 1), device=d)
        self.b3_b = _Conv(384, 384, (3, 1), padding=(1, 0), device=d)
        self.d3_0 = _Conv(in_ch, 448, 1, device=d)
        self.d3_1 = _Conv(448, 384, 3, padding=1, device=d)
        self.d3_a = _Conv(384, 384, (1, 3), padding=(0, 1), device=d)
        self.d3_b = _Conv(384, 384, (3, 1), padding=(1, 0), device=d)
        self.pool = AvgPool2D(3, stride=1, padding=1)
        self.bp = _Conv(in_ch, 192, 1, device=d)

    def forward(self, x):
        b3 = self.b3_0(x)
        b3 = torch.cat([self.b3_a(b3), self.b3_b(b3)], dim=1)
        d3 = self.d3_1(self.d3_0(x))
        d3 = torch.cat([self.d3_a(d3), self.d3_b(d3)], dim=1)
        return torch.cat([self.b1(x), b3, d3, self.bp(self.pool(x))], dim=1)


class InceptionV3(Layer):
    """``num_classes`` / ``with_pool`` as the JAX class.  Runs on
    ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 device=None):
        super().__init__()
        d = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool

        stem: List[tnn.Module] = [
            _Conv(3, 32, 3, stride=2, device=d), _Conv(32, 32, 3, device=d),
            _Conv(32, 64, 3, padding=1, device=d), MaxPool2D(3, stride=2),
            _Conv(64, 80, 1, device=d), _Conv(80, 192, 3, device=d),
            MaxPool2D(3, stride=2),
        ]
        body: List[tnn.Module] = stem + [
            InceptionA(192, 32, device=d), InceptionA(256, 64, device=d),
            InceptionA(288, 64, device=d),
            ReductionA(288, device=d),
            InceptionB(768, 128, device=d), InceptionB(768, 160, device=d),
            InceptionB(768, 160, device=d), InceptionB(768, 192, device=d),
            ReductionB(768, device=d),
            InceptionC(1280, device=d), InceptionC(2048, device=d),
        ]
        self.features = Sequential(*body)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.drop = Dropout(0.2)
            self.fc = Linear(2048, num_classes, device=d)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(F.flatten(x, 1)))
        return x


def inception_v3(**kw) -> InceptionV3:
    return InceptionV3(**kw)
