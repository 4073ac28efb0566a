"""GoogLeNet (Inception-v1): the port of
``paddle_tpu/vision/models/googlenet.py``.  With a classifier,
``forward`` returns ``(main, aux1, aux2)`` as the JAX model does.

Inception module: four parallel towers (1x1 / 1x1 -> 3x3 / 1x1 -> 5x5 /
pool -> 1x1) concatenated on channels.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer
from ...nn.layers import (AdaptiveAvgPool2D, Conv2D, Dropout, Linear,
                          MaxPool2D)

__all__ = ["GoogLeNet", "googlenet"]


class _Conv(Layer):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, device=device)

    def forward(self, x):
        return F.relu(self.conv(x))


class Inception(Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj, device=None):
        super().__init__()
        self.t1 = _Conv(in_ch, c1, 1, device=device)
        self.t2a = _Conv(in_ch, c3r, 1, device=device)
        self.t2b = _Conv(c3r, c3, 3, padding=1, device=device)
        self.t3a = _Conv(in_ch, c5r, 1, device=device)
        self.t3b = _Conv(c5r, c5, 5, padding=2, device=device)
        self.pool = MaxPool2D(3, stride=1, padding=1)
        self.t4 = _Conv(in_ch, proj, 1, device=device)

    def forward(self, x):
        return torch.cat(
            [self.t1(x), self.t2b(self.t2a(x)), self.t3b(self.t3a(x)),
             self.t4(self.pool(x))], dim=1)


class _AuxHead(Layer):
    def __init__(self, in_ch: int, num_classes: int, device=None):
        super().__init__()
        self.pool = AdaptiveAvgPool2D((4, 4))
        self.conv = _Conv(in_ch, 128, 1, device=device)
        self.fc1 = Linear(128 * 4 * 4, 1024, device=device)
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes, device=device)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = F.relu(self.fc1(F.flatten(x, 1)))
        return self.fc2(self.drop(x))


class GoogLeNet(Layer):
    """``num_classes`` / ``with_pool`` as the JAX class; with a classifier
    the two auxiliary heads (after ince4a and ince4d) are built and
    returned beside the main logits.  Runs on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def inception(*chans):
            return Inception(*chans, device=dev)
        self.conv1 = _Conv(3, 64, 7, stride=2, padding=3, device=dev)
        self.pool1 = MaxPool2D(3, stride=2, padding=1)
        self.conv2 = _Conv(64, 64, 1, device=dev)
        self.conv3 = _Conv(64, 192, 3, padding=1, device=dev)
        self.pool2 = MaxPool2D(3, stride=2, padding=1)

        self.ince3a = inception(192, 64, 96, 128, 16, 32, 32)
        self.ince3b = inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.ince4a = inception(480, 192, 96, 208, 16, 48, 64)
        self.ince4b = inception(512, 160, 112, 224, 24, 64, 64)
        self.ince4c = inception(512, 128, 128, 256, 24, 64, 64)
        self.ince4d = inception(512, 112, 144, 288, 32, 64, 64)
        self.ince4e = inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.ince5a = inception(832, 256, 160, 320, 32, 128, 128)
        self.ince5b = inception(832, 384, 192, 384, 48, 128, 128)

        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.drop = Dropout(0.4)
            self.fc = Linear(1024, num_classes, device=dev)
            self.aux1 = _AuxHead(512, num_classes, device=dev)
            self.aux2 = _AuxHead(528, num_classes, device=dev)

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv3(self.conv2(x)))
        x = self.ince3b(self.ince3a(x))
        x = self.ince4a(self.pool3(x))
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.ince4d(self.ince4c(self.ince4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.ince4e(x))
        x = self.ince5b(self.ince5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(F.flatten(x, 1)))
            return x, aux1, aux2
        return x


def googlenet(**kw) -> GoogLeNet:
    return GoogLeNet(**kw)
