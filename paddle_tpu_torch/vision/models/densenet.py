"""DenseNet: the port of ``paddle_tpu/vision/models/densenet.py``
(121 / 161 / 169 / 201 / 264).

Dense block: every layer concatenates its input with its output;
transition layers halve the channels and the spatial size.  BN-ReLU-conv
pre-activation order.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn as tnn

from ...device import resolve_device
from ...framework.errors import enforce
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                          Linear, MaxPool2D)

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CONFIGS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseLayer(Layer):
    """BN-ReLU-1x1 (bottleneck 4k), BN-ReLU-3x3 (k); the output is the
    input with the k new channels concatenated."""

    def __init__(self, in_ch: int, growth: int, bn_size: int = 4,
                 device=None):
        super().__init__()
        self.bn1 = BatchNorm2D(in_ch, device=device)
        self.conv1 = Conv2D(in_ch, bn_size * growth, 1, bias_attr=False,
                            device=device)
        self.bn2 = BatchNorm2D(bn_size * growth, device=device)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False, device=device)

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        return torch.cat([x, out], dim=1)


class Transition(Layer):
    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.bn = BatchNorm2D(in_ch, device=device)
        self.conv = Conv2D(in_ch, out_ch, 1, bias_attr=False, device=device)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(F.relu(self.bn(x))))


class DenseNet(Layer):
    """``layers`` one of 121, 161, 169, 201, 264; ``num_classes`` /
    ``with_pool`` as the JAX class.  Runs on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, layers: int = 121, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        enforce(layers in _CONFIGS, f"unsupported DenseNet depth {layers}",
                exc=ValueError)
        dev = resolve_device(device)
        init_ch, growth, block_repeats = _CONFIGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = Conv2D(3, init_ch, 7, stride=2, padding=3,
                            bias_attr=False, device=dev)
        self.bn1 = BatchNorm2D(init_ch, device=dev)
        self.maxpool = MaxPool2D(3, stride=2, padding=1)

        blocks: List[tnn.Module] = []
        ch = init_ch
        for i, repeats in enumerate(block_repeats):
            dense: List[tnn.Module] = []
            for _ in range(repeats):
                dense.append(DenseLayer(ch, growth, device=dev))
                ch += growth
            blocks.append(Sequential(*dense))
            if i != len(block_repeats) - 1:
                blocks.append(Transition(ch, ch // 2, device=dev))
                ch //= 2
        self.blocks = Sequential(*blocks)
        self.bn_final = BatchNorm2D(ch, device=dev)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(ch, num_classes, device=dev)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = F.relu(self.bn_final(self.blocks(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def densenet121(**kw) -> DenseNet:
    return DenseNet(121, **kw)


def densenet161(**kw) -> DenseNet:
    return DenseNet(161, **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(169, **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(201, **kw)


def densenet264(**kw) -> DenseNet:
    return DenseNet(264, **kw)
