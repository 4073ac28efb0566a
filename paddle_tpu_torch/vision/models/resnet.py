"""The ResNet family, the model of the JAX package's ResNet-50 ImageNet
row: the port of ``paddle_tpu/vision/models/resnet.py``.

NCHW as the JAX package (a model and its input converted to
``torch.channels_last`` run the same ops in NHWC memory order).  The
``state_dict`` keys are the JAX ones: ``conv1.weight``, ``bn1._mean``,
``layer1.0.downsample.conv.weight``, ``fc.weight``, ...
"""
from __future__ import annotations

from typing import List, Optional, Type, Union

from torch import nn as tnn

from ...device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                          MaxPool2D)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2"]


def _conv_bn(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
             groups: int = 1, device=None):
    pad = (kernel - 1) // 2
    return (Conv2D(in_ch, out_ch, kernel, stride=stride, padding=pad,
                   groups=groups, bias_attr=False, device=device),
            BatchNorm2D(out_ch, device=device))


class BasicBlock(Layer):
    """3x3 + 3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[tnn.Module] = None, groups: int = 1,
                 base_width: int = 64, device=None):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 3, stride,
                                        device=device)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class BottleneckBlock(Layer):
    """1x1 -> 3x3 -> 1x1 bottleneck (resnet50/101/152)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[tnn.Module] = None, groups: int = 1,
                 base_width: int = 64, device=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1, self.bn1 = _conv_bn(inplanes, width, 1, device=device)
        self.conv2, self.bn2 = _conv_bn(width, width, 3, stride, groups,
                                        device=device)
        self.conv3, self.bn3 = _conv_bn(width, planes * self.expansion, 1,
                                        device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class _Downsample(Layer):
    def __init__(self, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.conv, self.bn = _conv_bn(in_ch, out_ch, 1, stride,
                                      device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class ResNet(Layer):
    """ResNet backbone and classifier head: ``depth_or_layers`` is 18, 34,
    50, 101, 152 or the four stage counts; ``with_pool`` / ``num_classes``
    as the JAX class.  Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, block: Type[Union[BasicBlock, BottleneckBlock]],
                 depth_or_layers, num_classes: int = 1000,
                 with_pool: bool = True, groups: int = 1,
                 width_per_group: int = 64, device=None):
        super().__init__()
        if isinstance(depth_or_layers, int):
            layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                      101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth_or_layers]
        else:
            layers = list(depth_or_layers)
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width_per_group
        self.inplanes = 64

        self.conv1, self.bn1 = _conv_bn(3, 64, 7, stride=2,
                                        device=self.device)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             device=self.device)

    def _make_layer(self, block, planes: int, count: int, stride: int = 1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = _Downsample(self.inplanes, planes * block.expansion,
                                     stride, device=self.device)
        blocks: List[tnn.Module] = [block(
            self.inplanes, planes, stride, downsample, self.groups,
            self.base_width, device=self.device)]
        self.inplanes = planes * block.expansion
        for _ in range(1, count):
            blocks.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                device=self.device))
        return Sequential(*blocks)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, 18, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, 34, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(BottleneckBlock, 50, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(BottleneckBlock, 101, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(BottleneckBlock, 152, **kw)


def wide_resnet50_2(**kw) -> ResNet:
    return ResNet(BottleneckBlock, 50, width_per_group=128, **kw)


def wide_resnet101_2(**kw) -> ResNet:
    return ResNet(BottleneckBlock, 101, width_per_group=128, **kw)
