"""ShuffleNetV2: the port of ``paddle_tpu/vision/models/shufflenetv2.py``
(x0.25 to x2.0, and ``swish``).

Channel split, (identity | depthwise-separable branch), concat, channel
shuffle: the shuffle is a reshape / transpose pair.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn as tnn

from ...device import resolve_device
from ...framework.errors import enforce
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import AdaptiveAvgPool2D, Linear, MaxPool2D
from .utils import ConvNormActivation

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def channel_shuffle(x, groups: int):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


def _act(x, act: str):
    return F.silu(x) if act == "swish" else F.relu(x)


def ConvBN(in_ch, out_ch, kernel, stride=1, groups=1, device=None):
    # bare conv + bn: shufflenet applies its activation selectively outside
    return ConvNormActivation(in_ch, out_ch, kernel, stride, groups,
                              act="none", device=device)


class ShuffleUnit(Layer):
    """stride=1 unit: split in half, transform one half, concat and
    shuffle."""

    def __init__(self, ch: int, act: str, device=None):
        super().__init__()
        branch = ch // 2
        self.pw1 = ConvBN(branch, branch, 1, device=device)
        self.dw = ConvBN(branch, branch, 3, groups=branch, device=device)
        self.pw2 = ConvBN(branch, branch, 1, device=device)
        self.act = act

    def forward(self, x):
        half = x.shape[1] // 2
        x1, x2 = x[:, :half], x[:, half:]
        x2 = _act(self.pw1(x2), self.act)
        x2 = self.dw(x2)
        x2 = _act(self.pw2(x2), self.act)
        return channel_shuffle(torch.cat([x1, x2], dim=1), 2)


class ShuffleDownUnit(Layer):
    """stride=2 unit: both branches transform and downsample."""

    def __init__(self, in_ch: int, out_ch: int, act: str, device=None):
        super().__init__()
        branch = out_ch // 2
        self.left_dw = ConvBN(in_ch, in_ch, 3, stride=2, groups=in_ch,
                              device=device)
        self.left_pw = ConvBN(in_ch, branch, 1, device=device)
        self.right_pw1 = ConvBN(in_ch, branch, 1, device=device)
        self.right_dw = ConvBN(branch, branch, 3, stride=2, groups=branch,
                               device=device)
        self.right_pw2 = ConvBN(branch, branch, 1, device=device)
        self.act = act

    def forward(self, x):
        left = _act(self.left_pw(self.left_dw(x)), self.act)
        right = _act(self.right_pw1(x), self.act)
        right = self.right_dw(right)
        right = _act(self.right_pw2(right), self.act)
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


_STAGE_REPEATS = [4, 8, 4]
_STAGE_CHANNELS = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(Layer):
    """``scale`` one of 0.25, 0.33, 0.5, 1.0, 1.5, 2.0; ``act`` ``"relu"``
    or ``"swish"``; ``num_classes`` / ``with_pool`` as the JAX class.
    Runs on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True,
                 device=None):
        super().__init__()
        enforce(scale in _STAGE_CHANNELS,
                f"unsupported ShuffleNetV2 scale {scale}", exc=ValueError)
        dev = resolve_device(device)
        chans = _STAGE_CHANNELS[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBN(3, chans[0], 3, stride=2, device=dev)
        self.act_name = act
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        stages: List[tnn.Module] = []
        in_ch = chans[0]
        for stage_i, repeats in enumerate(_STAGE_REPEATS):
            out_ch = chans[stage_i + 1]
            units: List[tnn.Module] = [ShuffleDownUnit(in_ch, out_ch, act,
                                                       device=dev)]
            units += [ShuffleUnit(out_ch, act, device=dev)
                      for _ in range(repeats - 1)]
            stages.append(Sequential(*units))
            in_ch = out_ch
        self.stages = Sequential(*stages)
        self.conv_last = ConvBN(in_ch, chans[4], 1, device=dev)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(chans[4], num_classes, device=dev)

    def forward(self, x):
        x = _act(self.conv1(x), self.act_name)
        x = self.stages(self.maxpool(x))
        x = _act(self.conv_last(x), self.act_name)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def shufflenet_v2_x0_25(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=1.0, act="swish", **kw)
