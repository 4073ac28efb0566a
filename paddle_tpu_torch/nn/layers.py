"""The layers: the port of ``paddle_tpu/nn/layers.py``.  Parameter
names and layouts match the JAX package (``weight`` / ``bias``; Linear
weights are (in, out), Conv2D weights OIHW; BatchNorm's float32 buffers
``_mean`` and ``_variance``), so ``state_dict`` keys carry over
unchanged.
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

from ..device import resolve_device
from ..framework import random as fw_random
from ..framework.errors import enforce
from . import functional as F
from . import initializer as I

__all__ = ["LayerNorm", "RMSNorm", "Dropout", "Linear", "Embedding",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "Conv2D",
           "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "Flatten", "Identity", "ReLU", "ReLU6", "GELU", "SiLU",
           "Sigmoid", "Tanh", "LeakyReLU", "Hardswish", "Hardsigmoid",
           "Softmax", "LogSoftmax", "CrossEntropyLoss", "GroupNorm", "Mish",
           "Softplus", "MSELoss", "L1Loss", "NLLLoss", "BCEWithLogitsLoss",
           "SmoothL1Loss", "Conv1D", "Conv3D", "Conv2DTranspose",
           "MaxPool1D", "AvgPool1D", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "SpectralNorm", "PReLU", "Unflatten",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
           "PixelShuffle", "PixelUnshuffle", "CosineSimilarity",
           "PairwiseDistance", "GLU", "KLDivLoss", "MarginRankingLoss",
           "HingeEmbeddingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
           "CTCLoss"]


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


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


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
    """Rows of ``weight`` (num_embeddings, embedding_dim) at the ids.

    By default the weight is ``Normal(0, 1)``, as the JAX ``Embedding``;
    ``weight_attr`` (``ParamAttr``) names another initializer, and the
    rows of ids equal to ``padding_idx`` come out zero (their weight row
    gets no gradient).  ``std`` is the GPT / BERT rule instead: torch's
    ``normal_(0, std)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, std: Optional[float] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        if std is not None:
            self.weight = nn.Parameter(torch.empty(
                num_embeddings, embedding_dim, device=device))
            nn.init.normal_(self.weight, 0.0, std)
            return
        self.weight = I.create_parameter(
            (num_embeddings, embedding_dim),
            default_initializer=(I.Normal(0.0, 1.0) if weight_attr is None
                                 else None),
            attr=weight_attr, device=device)

    def forward(self, ids):
        return F.embedding(ids, self.weight, self.padding_idx)


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


# ---------------------------------------------------------------------------
# The Transformer family (paddle_tpu/nn/layers.py:345-567): plain PyTorch
# and cuBLAS products, as XLA computes them in the JAX package (its
# MultiHeadAttention passes an additive mask or no causal flag, which the
# flash route never takes)
# ---------------------------------------------------------------------------
def _activation(name: str):
    enforce(name in ("relu", "gelu"), f"unknown activation {name!r}")
    return {"relu": F.relu, "gelu": F.gelu}[name]


class MultiHeadAttention(nn.Module):
    """Attention of ``query`` over ``key`` / ``value`` (both ``query`` when
    left out) through q / k / v / out projections; ``kdim`` / ``vdim`` are
    the key's and value's widths.  ``attn_mask`` is additive over the
    (batch, heads, q, k) scores.  With ``cache=(k, v)`` (batch, heads, t,
    head_dim) the new keys and values are appended to it, and the result
    is ``(out, (k, v))``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, device: Optional[torch.device] = None):
        super().__init__()
        enforce(num_heads > 0 and embed_dim % num_heads == 0,
                f"num_heads {num_heads} must divide embed_dim {embed_dim}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kdim, vdim = kdim or embed_dim, vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=device)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0].to(k.dtype), k], dim=2)
            v = torch.cat([cache[1].to(v.dtype), v], dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, h, s, d = out.shape
        out = self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))
        return out if cache is None else (out, (k, v))


class TransformerEncoderLayer(nn.Module):
    """Self-attention, then the FFN, each with dropout and a residual;
    LayerNorm after each (post-LN, the default) or before
    (``normalize_before``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = _activation(activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src,
                                                      attn_mask=src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` layers from ``encoder_layer_fn()`` (``layers.<i>``),
    then ``norm`` when given."""

    def __init__(self, encoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer_fn()
                                     for _ in range(num_layers)])
        self.norm = norm

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask=src_mask)
        return src if self.norm is None else self.norm(src)


class TransformerDecoderLayer(nn.Module):
    """Self-attention (``tgt_mask``; with ``cache`` the incremental form),
    cross-attention over ``memory`` (``memory_mask``) and the FFN, each
    with dropout and a residual, post-LN or pre-LN.  With ``cache`` the
    result is ``(out, new_cache)``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            device=device)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = _activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        else:
            tgt, new_cache = self.self_attn(tgt, attn_mask=tgt_mask,
                                            cache=cache)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, new_cache)


class TransformerDecoder(nn.Module):
    """``num_layers`` layers from ``decoder_layer_fn()``, then ``norm``
    when given; with ``cache`` (one ``(k, v)`` a layer) the result is
    ``(out, new_caches)``."""

    def __init__(self, decoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer_fn()
                                     for _ in range(num_layers)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                tgt = layer(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
            else:
                tgt, c = layer(tgt, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            tgt = self.norm(tgt)
        return tgt if cache is None else (tgt, new_caches)


class Transformer(nn.Module):
    """The encoder-decoder Transformer; the defaults are Transformer-base
    (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, post-LN).
    Pre-LN stacks end in a LayerNorm each (``encoder.norm``,
    ``decoder.norm``)."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before=normalize_before, device=device),
            num_encoder_layers,
            norm=(LayerNorm(d_model, device=device) if normalize_before
                  else None))
        self.decoder = TransformerDecoder(
            lambda: TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before=normalize_before, device=device),
            num_decoder_layers,
            norm=(LayerNorm(d_model, device=device) if normalize_before
                  else None))

    @staticmethod
    def generate_square_subsequent_mask(length: int, device=None):
        """The additive causal mask: float32 min above the diagonal, 0 on
        and below it."""
        return torch.triu(torch.full((length, length),
                                     torch.finfo(torch.float32).min,
                                     device=device), diagonal=1)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)


# ---------------------------------------------------------------------------
# The rest of paddle_tpu/nn/layers.py (:214-227, :273-338, :568-943).
# Constructors that make a parameter or buffer run on ``cuda`` unless
# ``device="cpu"`` is passed (``device.resolve_device``)
# ---------------------------------------------------------------------------
class GroupNorm(nn.Module):
    """``weight`` (ones) and ``bias`` (zeros) of ``num_channels``."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = (None if weight_attr is False else I.create_parameter(
            (num_channels,), default_initializer=I.Constant(1.0),
            device=dev))
        self.bias = (None if bias_attr is False else I.create_parameter(
            (num_channels,), is_bias=True, device=dev))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon)


Mish = _act_layer(F.mish, "Mish")
Softplus = _act_layer(F.softplus, "Softplus")


class _Loss(nn.Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction


class MSELoss(_Loss):
    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Loss):
    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(_Loss):
    def forward(self, log_probs, label):
        return F.nll_loss(log_probs, label, self.reduction)


class BCEWithLogitsLoss(_Loss):
    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label,
                                                  self.reduction)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction: str = "mean", delta: float = 1.0):
        super().__init__(reduction)
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


def _conv_params(module, shape, out_channels, fan_in, weight_attr,
                 bias_attr, dev):
    """``weight`` of ``shape`` and ``bias`` (``bias_attr=False``: none),
    both ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(fan_in)
    module.weight = I.create_parameter(
        shape, default_initializer=I.Uniform(-bound, bound),
        attr=weight_attr, device=dev)
    module.bias = (None if bias_attr is False else I.create_parameter(
        (out_channels,), default_initializer=I.Uniform(-bound, bound),
        is_bias=True, attr=bias_attr, device=dev))


class Conv1D(nn.Module):
    """(N, C, L) input, weight (O, I / groups, K)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, weight_attr=None,
                 bias_attr=None, device: Optional[torch.device] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        _conv_params(self, (out_channels, in_channels // groups,
                            kernel_size), out_channels,
                     in_channels * kernel_size // groups, weight_attr,
                     bias_attr, resolve_device(device))

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Conv3D(nn.Module):
    """NCDHW (or NDHWC) input, weight (O, I / groups, kD, kH, kW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device: Optional[torch.device] = None):
        super().__init__()
        k = F._ntuple(kernel_size, 3)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        _conv_params(self, (out_channels, in_channels // groups, *k),
                     out_channels, in_channels * math.prod(k) // groups,
                     weight_attr, bias_attr, resolve_device(device))

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv2DTranspose(nn.Module):
    """Weight (in, out / groups, kh, kw), the paddle IOHW layout; weight
    and bias ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))`` with fan_in
    = in x kh x kw / groups.  ``forward(x, output_size)`` picks the
    output padding that gives ``output_size`` exactly, which must lie in
    [base, base + stride) for base = (in - 1) s - 2 p + d (k - 1) + 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups: int = 1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device: Optional[torch.device] = None):
        super().__init__()
        k = F._ntuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.output_padding, self.dilation = output_padding, dilation
        self.groups, self.data_format = groups, data_format
        _conv_params(self, (in_channels, out_channels // groups, *k),
                     out_channels, in_channels * k[0] * k[1] // groups,
                     weight_attr, bias_attr, resolve_device(device))

    def forward(self, x, output_size=None):
        out_pad = self.output_padding
        if output_size is not None:
            s = F._ntuple(self.stride, 2)
            p = F._ntuple(self.padding, 2)
            d = F._ntuple(self.dilation, 2)
            hw = x.shape[2:4] if self.data_format == "NCHW" else x.shape[1:3]
            k = self.weight.shape[2:4]
            out_pad = []
            for i in range(2):
                base = (hw[i] - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + 1
                extra = int(output_size[i]) - base
                enforce(0 <= extra < max(s[i], 1),
                        f"output_size[{i}]={output_size[i]} unreachable "
                        f"(base {base}, stride {s[i]})")
                out_pad.append(extra)
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, out_pad, self.dilation,
                                  self.groups, self.data_format)


class MaxPool1D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1D(MaxPool1D):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding)


class _InstanceNormBase(nn.Module):
    """Each sample's channels normalised over their spatial dims;
    parameters ``scale`` (ones) and ``bias`` (zeros), the JAX names."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        self.epsilon = epsilon
        self.scale = (None if weight_attr is False else I.create_parameter(
            (num_features,), default_initializer=I.Constant(1.0),
            attr=weight_attr, device=dev))
        self.bias = (None if bias_attr is False else I.create_parameter(
            (num_features,), is_bias=True, attr=bias_attr, device=dev))

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class SpectralNorm(nn.Module):
    """``forward(weight)`` = weight / sigma, sigma the largest singular
    value of the weight seen as (shape[dim], rest) by ``power_iters``
    steps of power iteration from the ``weight_u`` (shape[dim],) and
    ``weight_v`` (rest,) buffers.  Those start as standard normal draws
    from ``generator`` (the device's stream when None; JAX's draws differ,
    so parity loads them from the JAX state) and take the iteration's
    result only in training.  As in the JAX layer, sigma = u W v with u
    and v the iterates of this call, so the gradient also flows through
    the iteration (``torch.nn.utils.spectral_norm`` detaches them)."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 epsilon: float = 1e-12,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = math.prod(s for i, s in enumerate(weight_shape) if i != dim)
        gen = generator if generator is not None else fw_random.generator(
            dev)
        self.register_buffer("weight_u", torch.randn(h, generator=gen,
                                                     device=dev))
        self.register_buffer("weight_v", torch.randn(w, generator=gen,
                                                     device=dev))

    def forward(self, weight):
        w = weight.movedim(self.dim, 0).reshape(weight.shape[self.dim], -1)
        u = self.weight_u.to(w.dtype, copy=True)
        v = self.weight_v.to(w.dtype, copy=True)
        for _ in range(self.power_iters):
            v = w.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self.epsilon)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + self.epsilon)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return weight / (u @ w @ v)


class PReLU(nn.Module):
    """``weight`` (num_parameters,) of ``init`` (0.25)."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 weight_attr=None, device: Optional[torch.device] = None):
        super().__init__()
        self.weight = I.create_parameter(
            (num_parameters,), default_initializer=I.Constant(init),
            attr=weight_attr, device=resolve_device(device))

    def forward(self, x):
        return F.prelu(x, self.weight)


class Unflatten(nn.Module):
    def __init__(self, axis: int, shape):
        super().__init__()
        self.axis, self.shape = axis, tuple(shape)

    def forward(self, x):
        ax = self.axis % x.dim()
        return x.reshape(tuple(x.shape[:ax]) + self.shape
                         + tuple(x.shape[ax + 1:]))


class Upsample(nn.Module):
    """``F.interpolate`` with fixed arguments."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners: bool = False, data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor: int, data_format="NCHW"):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor: int, data_format="NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(nn.Module):
    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class GLU(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class KLDivLoss(_Loss):
    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin: float = 0.0, reduction: str = "mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin: float = 1.0, reduction: str = "mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(MarginRankingLoss):
    def __init__(self, margin: float = 0.0, reduction: str = "mean"):
        super().__init__(margin, reduction)

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin: float = 1.0, p: float = 2.0,
                 epsilon: float = 1e-6, swap: bool = False,
                 reduction: str = "mean"):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, anchor, positive, negative):
        return F.triplet_margin_loss(anchor, positive, negative,
                                     self.margin, self.p, self.epsilon,
                                     self.swap, self.reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank: int = 0, reduction: str = "mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction)
