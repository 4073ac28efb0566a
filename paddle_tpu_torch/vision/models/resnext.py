"""ResNeXt: the port of ``paddle_tpu/vision/models/resnext.py``, the
grouped-convolution bottleneck through the ResNet backbone's ``groups`` /
``width_per_group``."""
from __future__ import annotations

from .resnet import BottleneckBlock, ResNet

__all__ = ["ResNeXt", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class ResNeXt(ResNet):
    def __init__(self, depth: int = 50, cardinality: int = 32,
                 width: int = 4, **kw):
        super().__init__(BottleneckBlock, depth, groups=cardinality,
                         width_per_group=width, **kw)


def resnext50_32x4d(**kw) -> ResNeXt:
    return ResNeXt(50, 32, 4, **kw)


def resnext50_64x4d(**kw) -> ResNeXt:
    return ResNeXt(50, 64, 4, **kw)


def resnext101_32x4d(**kw) -> ResNeXt:
    return ResNeXt(101, 32, 4, **kw)


def resnext101_64x4d(**kw) -> ResNeXt:
    return ResNeXt(101, 64, 4, **kw)


def resnext152_32x4d(**kw) -> ResNeXt:
    return ResNeXt(152, 32, 4, **kw)


def resnext152_64x4d(**kw) -> ResNeXt:
    return ResNeXt(152, 64, 4, **kw)
