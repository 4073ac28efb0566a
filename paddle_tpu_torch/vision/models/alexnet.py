"""AlexNet: the port of ``paddle_tpu/vision/models/alexnet.py`` (the
single-tower formulation, its ``dropout`` argument)."""
from __future__ import annotations

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, Conv2D, Dropout, Linear,
                          MaxPool2D, ReLU)

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    """Five convs and a 6 x 6 adaptive pool, then the classifier with two
    Dropouts of p=``dropout``; ``num_classes=0`` keeps the pooled
    features.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, device=dev), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, device=dev), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, device=dev), ReLU(),
            Conv2D(384, 256, 3, padding=1, device=dev), ReLU(),
            Conv2D(256, 256, 3, padding=1, device=dev), ReLU(),
            MaxPool2D(3, stride=2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout), Linear(256 * 6 * 6, 4096, device=dev),
                ReLU(),
                Dropout(dropout), Linear(4096, 4096, device=dev), ReLU(),
                Linear(4096, num_classes, device=dev),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def alexnet(**kw) -> AlexNet:
    return AlexNet(**kw)
