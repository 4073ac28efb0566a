"""Parameter initializers: the port of ``paddle_tpu/nn/initializer.py``.

Each initializer is a callable ``init(shape, dtype=torch.float32,
device=None, generator=None) -> torch.Tensor``.  The draws come from an
explicit ``torch.Generator``: the one given, else the stream of ``device``
in ``framework/random.py`` (never torch's global generator).  The JAX
package's threefry bits are not reproduced; the distributions, the fans
(:func:`_fans`, OIHW conv kernels) and the gains are the JAX ones.

Layers take their defaults through :func:`create_parameter`, the port of
``Layer.create_parameter`` (``paddle_tpu/nn/layer.py:197-210``): a layer's
own default initializer first, then the ``ParamAttr``'s, then the global
one of :func:`set_global_initializer`, then ``XavierUniform`` for weights
and ``Constant(0)`` for biases.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..framework import random as fw_random
from ..framework.errors import enforce

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Dirac", "Orthogonal", "Bilinear",
           "constant", "uniform", "normal", "ParamAttr", "calculate_gain",
           "set_global_initializer", "create_parameter"]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels are OIHW: fan_in = in_ch * receptive field, fan_out =
    # out_ch * receptive field
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _gen(device, generator) -> torch.Generator:
    return generator if generator is not None else fw_random.generator(
        device if device is not None else "cpu")


def _uniform(shape, low, high, device, generator):
    """float32 uniform in [low, high), as ``jax.random.uniform``."""
    u = torch.rand(tuple(shape), generator=_gen(device, generator),
                   device=device, dtype=torch.float32)
    return low + (high - low) * u


def _normal(shape, device, generator):
    return torch.randn(tuple(shape), generator=_gen(device, generator),
                       device=device, dtype=torch.float32)


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return _uniform(shape, self.low, self.high, device,
                        generator).to(dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return (self.mean + self.std * _normal(shape, device, generator)
                ).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z a standard normal truncated to [-2, 2]."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        z = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                    generator=_gen(device, generator))
        return (self.mean + self.std * z).to(dtype)


class XavierUniform(Initializer):
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(shape, -limit, limit, device, generator).to(dtype)


class XavierNormal(Initializer):
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fan_in, fan_out = _fans(shape)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return (std * _normal(shape, device, generator)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, negative_slope=0.0):
        self.a = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fan_in, _ = _fans(shape)
        gain = math.sqrt(2.0 / (1 + self.a ** 2))
        limit = gain * math.sqrt(3.0 / fan_in)
        return _uniform(shape, -limit, limit, device, generator).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, negative_slope=0.0):
        self.a = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fan_in, _ = _fans(shape)
        gain = math.sqrt(2.0 / (1 + self.a ** 2))
        std = gain / math.sqrt(fan_in)
        return (std * _normal(shape, device, generator)).to(dtype)


# paddle-style aliases
constant = Constant
uniform = Uniform
normal = Normal


class Assign(Initializer):
    """Initialize from an explicit array."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        v = torch.as_tensor(np.asarray(self.value)).to(dtype=dtype,
                                                       device=device)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign value shape {tuple(v.shape)} != "
                             f"{tuple(shape)}")
        return v


class Dirac(Initializer):
    """Identity-preserving conv init: out[i, i % in, center...] = 1 within
    each of ``groups`` blocks."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        if len(shape) < 3:
            raise ValueError("Dirac needs a conv-shaped (O, I, *k) weight")
        out_ch, in_ch = shape[0], shape[1]
        if out_ch % self.groups:
            raise ValueError("out_channels must divide by groups")
        w = np.zeros(tuple(shape), np.float32)
        center = tuple(k // 2 for k in shape[2:])
        per_group = out_ch // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_ch)):
                w[(g * per_group + i, i) + center] = 1.0
        return torch.from_numpy(w).to(dtype=dtype, device=device)


class Orthogonal(Initializer):
    """(Semi-)orthogonal matrix init via QR; tensors are flattened to 2-D."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal needs >= 2 dims")
        rows = shape[0]
        cols = math.prod(shape[1:])
        n, m = max(rows, cols), min(rows, cols)
        a = _normal((n, m), device, generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))     # unique decomposition
        q = q.T if rows < cols else q
        return (self.gain * q.reshape(tuple(shape))).to(dtype)


class ParamAttr:
    """Parameter attribute bundle (name / initializer / trainable; the
    regularizer and learning rate are the optimizer's business)."""

    def __init__(self, name=None, initializer=None, trainable=True,
                 learning_rate=1.0, regularizer=None, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.need_clip = need_clip


def calculate_gain(nonlinearity: str, param=None) -> float:
    """Recommended init gain per nonlinearity."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0), "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        slope = 0.01 if param is None else float(param)
        return math.sqrt(2.0 / (1 + slope ** 2))
    if nonlinearity in gains:
        return gains[nonlinearity]
    raise ValueError(f"unknown nonlinearity {nonlinearity!r}")


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: every (C_in, C_out)
    pair of a 4-D weight gets the interpolation stencil."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        enforce(len(shape) == 4, "Bilinear init expects a 4-D conv weight")
        k = shape[-1]
        enforce(shape[-2] == k, "Bilinear init expects square kernels")
        f = (k + 1) // 2
        c = f - 1 if k % 2 == 1 else f - 0.5
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] - c) / f)
                * (1 - np.abs(og[1] - c) / f)).astype(np.float32)
        w = np.broadcast_to(filt, tuple(shape)).copy()
        return torch.from_numpy(w).to(dtype=dtype, device=device)


_global_initializer = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers of :func:`create_parameter` when neither the
    layer nor the ``ParamAttr`` names one.  ``(None, None)`` resets."""
    _global_initializer["weight"] = weight_init
    _global_initializer["bias"] = bias_init


def create_parameter(shape, default_initializer=None, is_bias: bool = False,
                     attr=None, device=None,
                     dtype=torch.float32) -> torch.nn.Parameter:
    """A parameter of ``shape`` on ``device``, drawn as the JAX
    ``Layer.create_parameter`` picks its initializer."""
    init = default_initializer
    if init is None and attr is not None and getattr(attr, "initializer",
                                                     None):
        init = attr.initializer
    if init is None:
        init = _global_initializer["bias" if is_bias else "weight"]
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    return torch.nn.Parameter(init(tuple(shape), dtype=dtype, device=device))
