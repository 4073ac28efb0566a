"""The layers the serving, training and vision slices need: the port of the
matching parts of ``paddle_tpu/nn/layers.py``.  Parameter names and layouts
match the JAX package (``weight`` / ``bias``; Linear weights are (in,
out), Conv2D weights OIHW; BatchNorm's float32 buffers ``_mean`` and
``_variance``), so ``state_dict`` keys carry over unchanged.
``nn.Sequential`` / ``nn.ModuleList`` take the place of the JAX
``Sequential`` / ``LayerList``: their ``"0"``, ``"1"``, ... keys are the
JAX ones.

Parameters without an explicit rule are drawn as the JAX
``create_parameter`` draws them (:func:`initializer.create_parameter`),
from the device's stream of ``framework/random.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import functional as F
from . import initializer as I

__all__ = ["LayerNorm", "Dropout", "Linear", "Embedding", "Conv2D",
           "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "Flatten", "Identity", "ReLU", "ReLU6", "GELU", "SiLU",
           "Sigmoid", "Tanh", "LeakyReLU", "Hardswish", "Hardsigmoid",
           "Softmax", "LogSoftmax", "CrossEntropyLoss"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """``F.dropout`` (upscale in train, mask from the device's explicit
    generator) in training mode; the identity in eval."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` (in_features, out_features).

    By default W is ``XavierUniform`` and b ``Constant(0)``, as the JAX
    ``Linear``; ``weight_attr`` / ``bias_attr`` (``ParamAttr``) name other
    initializers, and ``bias_attr=False`` drops the bias.  ``std`` is the
    GPT / BERT rule instead: W from ``normal(0, std)`` and b zero."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None,
                 std: Optional[float] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        if std is not None:
            self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                                   device=device))
            nn.init.normal_(self.weight, 0.0, std)
            self.bias = nn.Parameter(torch.zeros(out_features,
                                                 device=device))
            return
        self.weight = I.create_parameter((in_features, out_features),
                                         attr=weight_attr, device=device)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (out_features,), is_bias=True, attr=bias_attr, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, device: Optional[torch.device] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device))
        nn.init.normal_(self.weight, 0.0, std)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


# ---------------------------------------------------------------------------
# Conv / pooling
# ---------------------------------------------------------------------------
class Conv2D(nn.Module):
    """NCHW (or NHWC) input, OIHW weight; weight and bias from
    ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``, ``bias_attr=False``
    for none."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device: Optional[torch.device] = None):
        super().__init__()
        k = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        fan_in = in_channels * k[0] * k[1] // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = I.create_parameter(
            (out_channels, in_channels // groups, k[0], k[1]),
            default_initializer=I.Uniform(-bound, bound), attr=weight_attr,
            device=device)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (out_channels,), default_initializer=I.Uniform(-bound, bound),
            is_bias=True, attr=bias_attr, device=device))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            data_format=self.data_format)


class AvgPool2D(MaxPool2D):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(AdaptiveAvgPool2D):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.data_format)


# ---------------------------------------------------------------------------
# Batch normalization
# ---------------------------------------------------------------------------
class _BatchNormBase(nn.Module):
    """``weight`` (ones) and ``bias`` (zeros) parameters, ``_mean`` (zeros)
    and ``_variance`` (ones) float32 buffers.  In training the batch
    statistics normalise and the buffers take the running update in place,
    outside autograd; in eval the buffers normalise."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device: Optional[torch.device] = None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.weight = (None if weight_attr is False else I.create_parameter(
            (num_features,), default_initializer=I.Constant(1.0),
            attr=weight_attr, device=device))
        self.bias = (None if bias_attr is False else I.create_parameter(
            (num_features,), is_bias=True, attr=bias_attr, device=device))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        y, mean, var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format)
        if self.training:
            with torch.no_grad():
                self._mean.copy_(mean)
                self._variance.copy_(var)
        return y


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


# ---------------------------------------------------------------------------
# Shaping, activations, losses
# ---------------------------------------------------------------------------
class Flatten(nn.Module):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    def forward(self, x):
        return x


def _act_layer(fn, name):
    class _Act(nn.Module):
        def __init__(self, *a, **k):
            super().__init__()
            self._a, self._k = a, k

        def forward(self, x):
            return fn(x, *self._a, **self._k)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer(F.relu, "ReLU")
ReLU6 = _act_layer(F.relu6, "ReLU6")
GELU = _act_layer(F.gelu, "GELU")
SiLU = _act_layer(F.silu, "SiLU")
Sigmoid = _act_layer(F.sigmoid, "Sigmoid")
Tanh = _act_layer(F.tanh, "Tanh")
LeakyReLU = _act_layer(F.leaky_relu, "LeakyReLU")
Hardswish = _act_layer(F.hardswish, "Hardswish")
Hardsigmoid = _act_layer(F.hardsigmoid, "Hardsigmoid")
Softmax = _act_layer(F.softmax, "Softmax")
LogSoftmax = _act_layer(F.log_softmax, "LogSoftmax")


class CrossEntropyLoss(nn.Module):
    def __init__(self, reduction: str = "mean", soft_label: bool = False,
                 ignore_index: int = -100, label_smoothing: float = 0.0):
        super().__init__()
        self.reduction, self.soft_label = reduction, soft_label
        self.ignore_index, self.label_smoothing = ignore_index, label_smoothing

    def forward(self, logits, label):
        return F.cross_entropy(logits, label, soft_label=self.soft_label,
                               reduction=self.reduction,
                               ignore_index=self.ignore_index,
                               label_smoothing=self.label_smoothing)
