"""The VGG family: the port of ``paddle_tpu/vision/models/vgg.py``
(``vgg11`` / ``13`` / ``16`` / ``19``, each with or without
``batch_norm``)."""
from __future__ import annotations

from typing import List

from torch import nn as tnn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Linear, MaxPool2D, ReLU)

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg: List, batch_norm: bool, device) -> tnn.Sequential:
    layers: List[tnn.Module] = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, stride=2))
        else:
            layers.append(Conv2D(in_ch, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=device))
            layers.append(ReLU())
            in_ch = v
    return tnn.Sequential(*layers)


class VGG(tnn.Module):
    """``features`` then a 7 x 7 adaptive pool and the 4096-wide
    classifier (two Dropouts of p=0.5); ``num_classes`` / ``with_pool``
    as the JAX class.  Runs on ``cuda`` unless ``device="cpu"`` (the
    classifier's device; ``features`` is built by the caller)."""

    def __init__(self, features: tnn.Module, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = tnn.Sequential(
                Linear(512 * 7 * 7, 4096, device=dev), ReLU(), Dropout(),
                Linear(4096, 4096, device=dev), ReLU(), Dropout(),
                Linear(4096, num_classes, device=dev),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def _vgg(cfg_key: str, batch_norm: bool, device=None, **kw) -> VGG:
    dev = resolve_device(device)
    return VGG(_make_features(_CFGS[cfg_key], batch_norm, dev), device=dev,
               **kw)


def vgg11(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("A", batch_norm, **kw)


def vgg13(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("B", batch_norm, **kw)


def vgg16(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("D", batch_norm, **kw)


def vgg19(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("E", batch_norm, **kw)
