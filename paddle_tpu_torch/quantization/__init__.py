"""Quantization: QAT (fake quant), PTQ (calibration) and int8 inference,
the port of ``paddle_tpu/quantization/__init__.py``.

- ``quant_dequant`` is symmetric fake quantization with a straight-through
  gradient, ``x + (qdq(x) - x).detach()``; the rounding is half-to-even
  (``torch.round``, as ``jnp.round``) and ``x / s * qmax`` keeps the JAX
  order, so the quantized values match bit for bit.
- The moving-average scales are buffers, updated in place (as BatchNorm's
  running statistics), so they ride ``Layer.apply``'s buffer path too.
- ``Int8Linear`` and ``Int8Conv2D`` accumulate int8 x int8 products in
  int32 exactly, then rescale.  On the card the product is
  ``torch._int_mm`` (cuBLASLt's int8 GEMM; the JAX package's is
  ``lax.dot_general`` outside Pallas), its operands zero-padded to the
  shapes it takes (more than 16 rows, inner and output sizes multiples of
  8), which changes no sum; on the CPU it is an int32 matrix product.
  PyTorch has no int8 convolution on the card, so ``Int8Conv2D`` is
  ``F.unfold`` of the quantized input (small integers, exact in float32)
  and the same int8 GEMM per group.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as TF

from ..framework.errors import enforce
from ..nn import functional as F
from ..nn.layer import Layer
from ..nn.layers import Conv2D, Linear

__all__ = [
    "quant_dequant", "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
    "FakeQuantChannelWiseAbsMax", "MovingAverageAbsMaxScale",
    "QuantizedLinear", "QuantizedConv2D", "ImperativeQuantAware",
    "PostTrainingQuantization", "quantize_weight_to_int", "Int8Linear",
    "Int8Conv2D",
]


# ---------------------------------------------------------------------------
# functional core
# ---------------------------------------------------------------------------
def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _quantize(x, scale, qmax: float) -> torch.Tensor:
    """``clip(round(x / max(scale, 1e-9) * qmax), -qmax, qmax)`` (float)."""
    s = torch.clamp(torch.as_tensor(scale, device=x.device), min=1e-9)
    return torch.clamp(torch.round(x / s * qmax), -qmax, qmax)


def _qdq(x, scale, qmax: float) -> torch.Tensor:
    s = torch.clamp(torch.as_tensor(scale, device=x.device), min=1e-9)
    return _quantize(x, scale, qmax) * s / qmax


def quant_dequant(x, scale, bits: int = 8):
    """Symmetric fake quantization with a straight-through gradient."""
    return x + (_qdq(x, scale, _qmax(bits)) - x).detach()


# ---------------------------------------------------------------------------
# fake-quant layers (QAT building blocks)
# ---------------------------------------------------------------------------
class FakeQuantAbsMax(Layer):
    """Per-tensor abs-max scale computed on the fly (weights)."""

    def __init__(self, bits: int = 8):
        super().__init__()
        self.bits = bits

    def forward(self, x):
        return quant_dequant(x, x.abs().max(), self.bits)


class FakeQuantChannelWiseAbsMax(Layer):
    """Per-output-channel abs-max scale (conv / linear weights)."""

    def __init__(self, bits: int = 8, channel_axis: int = 0):
        super().__init__()
        self.bits = bits
        self.channel_axis = channel_axis

    def forward(self, x):
        axes = tuple(i for i in range(x.dim()) if i != self.channel_axis)
        return quant_dequant(x, x.abs().amax(dim=axes, keepdim=True),
                             self.bits)


def _batch_absmax(x) -> torch.Tensor:
    return x.detach().abs().max().to(torch.float32)


class FakeQuantMovingAverageAbsMax(Layer):
    """Activation fake quant with an EMA abs-max scale buffer:
    ``scale <- r * scale + (1 - r) * absmax(x)`` while observing, frozen
    otherwise; ``mode="max"`` makes it a running max (the PTQ abs_max
    calibration).  ``observe`` None follows ``self.training``; True /
    False force collection on / off."""

    def __init__(self, bits: int = 8, moving_rate: float = 0.9,
                 mode: str = "ema"):
        super().__init__()
        self.bits = bits
        self.moving_rate = moving_rate
        self.mode = mode
        self.observe = None
        self.register_buffer("scale", torch.tensor(
            1.0 if mode == "ema" else 0.0, dtype=torch.float32,
            device=self._own_device()))

    def forward(self, x):
        if self.training if self.observe is None else self.observe:
            batch = _batch_absmax(x)
            if self.mode == "max":
                new = torch.maximum(self.scale, batch)
            else:
                new = (self.moving_rate * self.scale
                       + (1 - self.moving_rate) * batch)
            self.scale.copy_(new)
        return quant_dequant(x, self.scale, self.bits)


class MovingAverageAbsMaxScale(Layer):
    """Observer only: tracks the EMA abs-max scale without quantizing."""

    def __init__(self, moving_rate: float = 0.9):
        super().__init__()
        self.moving_rate = moving_rate
        self.register_buffer("scale", torch.tensor(
            1.0, dtype=torch.float32, device=self._own_device()))

    def forward(self, x):
        if self.training:
            self.scale.copy_(self.moving_rate * self.scale
                             + (1 - self.moving_rate) * _batch_absmax(x))
        return x


def _weight_quanter(kind: str, bits: int) -> Layer:
    if kind == "abs_max":
        return FakeQuantAbsMax(bits)
    if kind == "channel_wise_abs_max":
        return FakeQuantChannelWiseAbsMax(bits)
    raise ValueError(f"unsupported weight_quantize_type {kind!r}")


def _act_quanter(kind: str, bits: int, moving_rate: float,
                 device) -> Optional[Layer]:
    if kind == "moving_average_abs_max":
        return FakeQuantMovingAverageAbsMax(bits, moving_rate).to(device)
    if kind == "abs_max":
        return FakeQuantAbsMax(bits)
    if kind == "none":
        return None
    raise ValueError(f"unsupported activation_quantize_type {kind!r}")


# ---------------------------------------------------------------------------
# quantized layer wrappers
# ---------------------------------------------------------------------------
class QuantizedLinear(Layer):
    """Linear with fake-quantized weight and input; shares the Linear's
    parameters (so its ``state_dict`` keys and optimizer state hold)."""

    def __init__(self, layer: Linear, weight_quantize_type: str,
                 activation_quantize_type: str, weight_bits: int,
                 activation_bits: int, moving_rate: float):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self.weight_quanter = _weight_quanter(weight_quantize_type,
                                              weight_bits)
        if isinstance(self.weight_quanter, FakeQuantChannelWiseAbsMax):
            self.weight_quanter.channel_axis = 1     # (in, out) weights
        self.input_quanter = _act_quanter(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        if self.input_quanter is not None:
            x = self.input_quanter(x)
        return F.linear(x, self.weight_quanter(self.weight), self.bias)


class QuantizedConv2D(Layer):
    """Conv2D with fake-quantized weight (OIHW: channel axis 0) and input."""

    def __init__(self, layer: Conv2D, weight_quantize_type: str,
                 activation_quantize_type: str, weight_bits: int,
                 activation_bits: int, moving_rate: float):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._stride = layer.stride
        self._padding = layer.padding
        self._dilation = layer.dilation
        self._groups = layer.groups
        self._data_format = layer.data_format
        self.weight_quanter = _weight_quanter(weight_quantize_type,
                                              weight_bits)
        self.input_quanter = _act_quanter(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        if self.input_quanter is not None:
            x = self.input_quanter(x)
        return F.conv2d(x, self.weight_quanter(self.weight), self.bias,
                        self._stride, self._padding, self._dilation,
                        self._groups, self._data_format)


# ---------------------------------------------------------------------------
# QAT layer swap
# ---------------------------------------------------------------------------
_SWAP = {Linear: QuantizedLinear, Conv2D: QuantizedConv2D}


def _children(model):
    return model._modules


def _wrapper_for(sub):
    """The fake-quant wrapper of a Linear or Conv2D, subclasses included:
    the port's ``ColumnParallelLinear`` / ``RowParallelLinear`` (GPT's
    linears) are Linears on one card, where the JAX package's are layers
    of their own that its exact-type swap passes over."""
    for cls, wrapper in _SWAP.items():
        if isinstance(sub, cls):
            return wrapper
    return None


class ImperativeQuantAware:
    """QAT layer swap: ``quantize(model)`` replaces every Linear /
    Conv2D in place by its fake-quant wrapper, sharing the parameters."""

    def __init__(self, weight_quantize_type: str = "abs_max",
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9):
        enforce(1 < weight_bits <= 16, "weight_bits must be in (1, 16]")
        enforce(1 < activation_bits <= 16,
                "activation_bits must be in (1, 16]")
        self._kw = dict(weight_quantize_type=weight_quantize_type,
                        activation_quantize_type=activation_quantize_type,
                        weight_bits=weight_bits,
                        activation_bits=activation_bits,
                        moving_rate=moving_rate)

    def quantize(self, model: Layer) -> Layer:
        for name, sub in list(_children(model).items()):
            wrapper = _wrapper_for(sub)
            if wrapper is not None:
                setattr(model, name, wrapper(sub, **self._kw))
            elif sub is not None:
                self.quantize(sub)
        return model


# ---------------------------------------------------------------------------
# PTQ and int8 conversion
# ---------------------------------------------------------------------------
def _int_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else (torch.int16 if bits <= 16
                                         else torch.int32)


def quantize_weight_to_int(w, bits: int = 8,
                           channel_axis: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int weight, float scale): the storage dtype follows ``bits``, the
    scale is the abs-max over the other axes (kept) divided by qmax."""
    qmax = _qmax(bits)
    w = w.detach()
    if channel_axis is None:
        scale = w.abs().max()
    else:
        axes = tuple(i for i in range(w.dim()) if i != channel_axis)
        scale = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(scale, min=1e-9)
    q = torch.clamp(torch.round(w / scale * qmax), -qmax, qmax
                    ).to(_int_dtype(bits))
    return q, scale / qmax


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return TF.pad(t, pad)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 (M, K) and (K, N).  On the card,
    ``torch._int_mm`` with the operands zero-padded to M > 16 and K, N
    multiples of 8 (a zero row or column adds nothing to any sum); on the
    CPU an int32 matrix product.  While ``torch.export`` traces, the
    registered op ``ptpu::int8_matmul``, which picks the route when it
    runs (an artifact exported on the CPU takes the card's on the card)."""
    if torch.compiler.is_exporting():
        return int8_matmul(a, b)
    return _int_matmul(a, b)


@torch.library.custom_op("ptpu::int8_matmul", mutates_args=())
def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _int_matmul(a, b)


@int8_matmul.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch.mm(a.to(torch.int32), b.to(torch.int32))
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    ap = _pad_to(_pad_to(a, 0, max(m, 17)), 1, kp).contiguous()
    bp = _pad_to(_pad_to(b, 0, kp), 1, np_).contiguous()
    return torch._int_mm(ap, bp)[:m, :n].contiguous()


def _rescale(acc, wscale, in_scale, qmax: float, bias):
    y = acc.to(torch.float32) * wscale * (in_scale / qmax)
    return y if bias is None else y + bias


class Int8Linear(Layer):
    """Converted int8 inference Linear: int8 x int8 products accumulated
    exactly in int32 (:func:`int_matmul`), then a per-channel rescale.
    ``layer``: anything with a (in, out) ``weight`` and a ``bias``."""

    def __init__(self, layer, bits: int = 8):
        super().__init__()
        q, s = quantize_weight_to_int(layer.weight, bits, channel_axis=1)
        self.register_buffer("qweight", q)
        self.register_buffer("wscale", s)            # (1, out)
        self.bias = layer.bias
        self.bits = bits
        self.register_buffer("in_scale", torch.tensor(
            1.0, dtype=torch.float32, device=q.device))

    def quantize_input(self, x) -> torch.Tensor:
        """``xq``, the int8 input, as the JAX layer computes it."""
        qmax = _qmax(self.bits)
        return _quantize(x, self.in_scale, qmax).to(_int_dtype(self.bits))

    def accumulate(self, x) -> torch.Tensor:
        """The int32 accumulation ``xq @ qweight`` over the last dim."""
        xq = self.quantize_input(x)
        lead = xq.shape[:-1]
        acc = int_matmul(xq.reshape(-1, xq.shape[-1]), self.qweight)
        return acc.reshape(*lead, acc.shape[-1])

    def forward(self, x):
        in_scale = torch.clamp(self.in_scale, min=1e-9)
        return _rescale(self.accumulate(x), self.wscale, in_scale,
                        _qmax(self.bits), self.bias)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Int8Conv2D(Layer):
    """Converted int8 inference Conv2D (OIHW weights, NCHW or NHWC input):
    the quantized input unfolded, each group's int8 GEMM accumulated in
    int32 (:func:`int_matmul`), a per-output-channel rescale."""

    def __init__(self, layer: QuantizedConv2D, bits: int = 8):
        super().__init__()
        self._data_format = layer._data_format
        q, s = quantize_weight_to_int(layer.weight, bits, channel_axis=0)
        self.register_buffer("qweight", q)
        self.bias = layer.bias
        self.bits = bits
        self._stride = layer._stride
        self._padding = layer._padding
        self._dilation = layer._dilation
        self._groups = layer._groups
        self.register_buffer("wscale", s.reshape(1, -1, 1, 1)
                             if self._data_format == "NCHW"
                             else s.reshape(1, 1, 1, -1))
        self.register_buffer("in_scale", torch.tensor(
            1.0, dtype=torch.float32, device=q.device))

    def _pads(self, h: int, w: int):
        """(top, bottom, left, right) of the padding spec; ``"SAME"`` as
        XLA pads (the odd unit at the end)."""
        kh, kw = self.qweight.shape[2:]
        if not isinstance(self._padding, str):
            ph, pw = _pair(self._padding)
            return (ph, ph, pw, pw)
        if self._padding.upper() == "VALID":
            return (0, 0, 0, 0)
        stride, dil = _pair(self._stride), _pair(self._dilation)
        out = []
        for size, k, s, d in ((h, kh, stride[0], dil[0]),
                              (w, kw, stride[1], dil[1])):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            out += [total // 2, total - total // 2]
        return tuple(out)

    def accumulate(self, x) -> torch.Tensor:
        """The int32 convolution of the int8 input and ``qweight``, NCHW."""
        qmax = _qmax(self.bits)
        xq = _quantize(x, self.in_scale, qmax)       # small ints, exact
        if self._data_format != "NCHW":
            xq = xq.permute(0, 3, 1, 2)
        b, c, h, w = xq.shape
        top, bottom, left, right = self._pads(h, w)
        xq = TF.pad(xq, (left, right, top, bottom))
        o, cg, kh, kw = self.qweight.shape
        stride, dil = _pair(self._stride), _pair(self._dilation)
        oh = (xq.shape[2] - dil[0] * (kh - 1) - 1) // stride[0] + 1
        ow = (xq.shape[3] - dil[1] * (kw - 1) - 1) // stride[1] + 1
        g = self._groups
        og = o // g
        outs = []
        for i in range(g):
            cols = TF.unfold(xq[:, i * cg:(i + 1) * cg], (kh, kw),
                             dilation=dil, stride=stride)  # (B, cg k k, L)
            a = cols.transpose(1, 2).reshape(-1, cg * kh * kw).to(torch.int8)
            wq = self.qweight[i * og:(i + 1) * og].reshape(og, -1).t()
            outs.append(int_matmul(a, wq).reshape(b, oh * ow, og))
        acc = torch.cat(outs, dim=-1).transpose(1, 2)
        return acc.reshape(b, o, oh, ow)

    def forward(self, x):
        in_scale = torch.clamp(self.in_scale, min=1e-9)
        acc = self.accumulate(x)
        if self._data_format != "NCHW":
            acc = acc.permute(0, 2, 3, 1)
        bias = self.bias
        if bias is not None and self._data_format == "NCHW":
            bias = bias[None, :, None, None]
        return _rescale(acc, self.wscale, in_scale, _qmax(self.bits), bias)


class PostTrainingQuantization:
    """Calibration-based PTQ.

    1. ``quantize(model, calibration_data)``: running-max observers on
       every Linear / Conv2D input, the batches run with the model in
       eval (BN statistics and dropout frozen), scales frozen after.
    2. ``convert(model)``: every observed layer becomes an
       ``Int8Linear`` / ``Int8Conv2D`` carrying its calibrated scale.
    """

    def __init__(self, activation_bits: int = 8, weight_bits: int = 8,
                 moving_rate: float = 0.9):
        self.activation_bits = activation_bits
        self.weight_bits = weight_bits
        self.moving_rate = moving_rate

    def quantize(self, model: Layer, calibration_data: Iterable) -> Layer:
        ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max",
            activation_quantize_type="moving_average_abs_max",
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            moving_rate=self.moving_rate).quantize(model)
        observers = [m for m in model.modules()
                     if isinstance(m, FakeQuantMovingAverageAbsMax)]
        for obs in observers:        # abs_max calibration: running max
            obs.mode = "max"
            obs.observe = True
            obs.scale.zero_()
        model.eval()
        with torch.no_grad():
            for batch in calibration_data:
                model(batch)
        for obs in observers:
            obs.observe = False
        return model

    def convert(self, model: Layer) -> Layer:
        for name, sub in list(_children(model).items()):
            if isinstance(sub, QuantizedLinear):
                int8 = Int8Linear(sub, self.weight_bits)
            elif isinstance(sub, QuantizedConv2D):
                int8 = Int8Conv2D(sub, self.weight_bits)
            else:
                if sub is not None:
                    self.convert(sub)
                continue
            if not isinstance(sub.input_quanter,
                              FakeQuantMovingAverageAbsMax):
                raise ValueError(
                    "convert() needs a calibrated input observer on every "
                    "quantized layer; run PostTrainingQuantization."
                    "quantize(model, calibration_data) first (got "
                    f"{type(sub.input_quanter).__name__} on {name!r})")
            scale = sub.input_quanter.scale
            if float(scale) <= 0.0:
                raise ValueError(
                    f"input observer on {name!r} was never calibrated "
                    "(scale=0); pass at least one calibration batch to "
                    "quantize() before convert()")
            int8.in_scale.copy_(scale)
            setattr(model, name, int8)
        return model
