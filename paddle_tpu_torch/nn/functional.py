"""The functional ops: the port of ``paddle_tpu/nn/functional.py`` and,
re-exported from :mod:`._functional_ext`, of its long tail.  Plain
PyTorch; the JAX package computes these outside any Pallas kernel too,
except for the flash-attention route of :func:`scaled_dot_product_attention`.

Type promotion follows JAX: an op on a bfloat16 activation and a float32
parameter computes and returns float32 (``jnp.matmul`` promotes; torch's
``matmul`` refuses mixed dtypes, so :func:`linear` promotes first).  Under
``amp.auto_cast`` the ops consult ``amp.state.cast_for_op`` first, as the
JAX ops do: ``linear`` / ``matmul`` / ``attention`` down to the amp dtype,
``layer_norm`` up to float32.  Dropout masks come from the device's
explicit generator (``framework/random.py``).

The vision ops (:func:`conv2d`, the pools, :func:`batch_norm`) keep the
JAX semantics where torch's own differ: ``relu`` and the clipped
activations are ``maximum`` / ``minimum`` compositions, whose gradient at
a tie is 0.5 as ``jnp.maximum``'s (``torch.relu``'s is 0 at 0); ``"SAME"``
padding is ``lax``'s (asymmetric when the total is odd, any stride);
``avg_pool2d`` divides by the in-bounds count; ``batch_norm``'s momentum
keeps ``momentum`` of the old statistic (torch's convention is the
opposite) and its running variance takes the unbiased batch variance.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..amp.state import cast_for_op
from ..framework import random as fw_random
from ..framework.errors import enforce

__all__ = ["gelu", "tanh", "layer_norm", "linear", "matmul", "embedding",
           "dropout", "cross_entropy", "scaled_dot_product_attention",
           "relu", "relu6", "silu", "swish", "sigmoid", "leaky_relu",
           "hardswish", "hardsigmoid", "softmax", "log_softmax", "conv2d",
           "conv1d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d", "batch_norm", "group_norm", "flatten",
           "one_hot", "nll_loss", "mse_loss", "rms_norm", "gather_tree",
           "elu", "mish", "softplus", "l1_loss",
           "binary_cross_entropy_with_logits", "smooth_l1_loss",
           "square_error_cost", "label_smooth",
           "softmax_mask_fuse_upper_triangle", "pad", "clip", "normalize",
           "interpolate", "pixel_shuffle", "pixel_unshuffle", "prelu", "glu",
           "cosine_similarity", "pairwise_distance", "conv3d",
           "conv2d_transpose", "max_pool1d", "avg_pool1d", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss",
           "sparse_attention"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """Exact (erf) gelu, as ``jax.nn.gelu(approximate=False)``; with
    ``approximate`` the tanh form ``0.5 x (1 + tanh(sqrt(2 / pi) (x +
    0.044715 x^3)))``, as ``jax.nn.gelu(approximate=True)``."""
    if approximate:
        inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)
        return 0.5 * x * (1.0 + torch.tanh(inner))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims, computed in
    float32 under autocast and in ``x``'s dtype outside it (the JAX op does
    not upcast there); returned in ``x``'s dtype."""
    orig_dtype = x.dtype
    x = cast_for_op("layer_norm", x)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    naxes = len(normalized_shape) if normalized_shape else 1
    axes = tuple(range(x.dim() - naxes, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(orig_dtype)


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """``x / sqrt(mean(x^2) + epsilon) * weight`` over the last dim, in
    float32 under autocast (the ``layer_norm`` rule), returned in x's
    dtype."""
    orig_dtype = x.dtype
    xf = cast_for_op("layer_norm", x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.to(y.dtype)
    return y.to(orig_dtype)


def linear(x, weight, bias=None):
    """``y = x @ W + b`` with ``W`` shaped (in, out), the paddle layout."""
    x, weight = cast_for_op("linear", x, weight)
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    x, y = cast_for_op("matmul", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


def embedding(ids, weight, padding_idx: Optional[int] = None):
    """Rows of ``weight`` at ``ids``; the rows of ids equal to
    ``padding_idx`` are zeros, so no gradient reaches that weight row."""
    out = weight[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout with a mask drawn from ``generator`` (the
    device's stream of ``framework/random.py`` when None): keep where a
    uniform < 1 - p, as the JAX op's ``bernoulli(key, 1 - p)``."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    gen = generator if generator is not None else fw_random.generator(
        x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)


def cross_entropy(logits, label, soft_label: bool = False,
                  reduction: str = "mean", ignore_index: int = -100,
                  axis: int = -1, label_smoothing: float = 0.0):
    """Softmax cross-entropy (``softmax_with_cross_entropy``) over the last
    axis, cast to float32 under ``auto_cast`` as the JAX op is.  Hard
    labels are integers with one fewer dim than ``logits`` (or a trailing
    dim of 1); labels equal to ``ignore_index`` count zero, and ``"mean"``
    divides by the valid count (floor 1).  Soft labels are distributions
    over the last axis.  Another ``axis`` is refused: the JAX op's hard
    label gather assumes the last one."""
    enforce(reduction in ("mean", "sum", "none"),
            f"unknown reduction {reduction!r}")
    enforce(axis in (-1, logits.dim() - 1),
            f"cross_entropy: axis {axis} is not the last axis")
    logits = cast_for_op("cross_entropy", logits)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis)
    else:
        if label.dim() == logits.dim():
            label = label.squeeze(axis)
        valid = label != ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            smooth = logp.mean(dim=axis)
            picked = (1 - label_smoothing) * picked + label_smoothing * smooth
        loss = torch.where(valid, -picked,
                           torch.zeros((), dtype=picked.dtype,
                                       device=picked.device))
        if reduction == "mean":
            denom = valid.to(loss.dtype).sum().clamp_min(1.0)
            return loss.sum() / denom
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None):
    """q, k, v: (batch, heads, seq, head_dim); ``attn_mask`` is additive.
    ``is_causal`` aligns the triangle bottom-right (the query block is the
    suffix of the key sequence).  Scores and softmax run in float32
    (float64 for float64 inputs, which the JAX op would round to float32);
    the probabilities are cast to ``v``'s dtype for the value product.

    Causal attention with no mask and no dropout, both lengths multiples of
    128 and ``head_dim % 8 == 0`` goes to the flash kernels when the tensors
    lie on the card, as the JAX op routes it to the Pallas kernel on a TPU
    (``paddle_tpu/nn/functional.py:581-598``)."""
    q, k = cast_for_op("attention", q, k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (q.is_cuda and is_causal and attn_mask is None
            and (dropout_p == 0.0 or not training) and q.dim() == 4
            and q.shape[-2] % 128 == 0 and k.shape[-2] % 128 == 0
            and q.shape[-1] % 8 == 0):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v.to(q.dtype), causal=True, scale=scale,
                               dropout_p=0.0)
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)) * scale
    scores = scores.to(torch.promote_types(dt, torch.float32))
    if attn_mask is not None:
        scores = scores + attn_mask.to(scores.dtype)
    if is_causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((ql, kl), dtype=torch.bool,
                            device=scores.device).tril(kl - ql)
        scores = torch.where(causal, scores,
                             torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# ---------------------------------------------------------------------------
# Activations (paddle_tpu/nn/functional.py:34-100)
# ---------------------------------------------------------------------------
def _clip(x, lo: float, hi: float):
    """``jnp.clip`` as ``minimum(maximum(x, lo), hi)``: the gradient at
    either bound is 0.5, as JAX's."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def relu(x):
    """``jnp.maximum(x, 0)``: the gradient at exactly 0 is 0.5."""
    return torch.maximum(x, x.new_zeros(()))


def relu6(x):
    return _clip(x, 0.0, 6.0)


def silu(x):
    return TF.silu(x)


swish = silu


def sigmoid(x):
    return torch.sigmoid(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def hardswish(x):
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x):
    return _clip(x / 6.0 + 0.5, 0.0, 1.0)


def softmax(x, axis: int = -1):
    return torch.softmax(cast_for_op("softmax", x), dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(cast_for_op("log_softmax", x), dim=axis)


# ---------------------------------------------------------------------------
# Convolution and pooling (paddle_tpu/nn/functional.py:179-324, :793-821):
# OIHW weights for both data formats; NHWC inputs are viewed as NCHW
# ---------------------------------------------------------------------------
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, stride: int, dilation: int):
    """``lax``'s SAME padding of one axis: ``ceil(size / stride)`` outputs,
    the odd unit of the total at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _nchw(x, data_format: str):
    enforce(data_format in ("NCHW", "NHWC"),
            f"unknown data_format {data_format!r}")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(y, data_format: str):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCHW"):
    """``weight`` (out_ch, in_ch / groups, kh, kw) for either
    ``data_format``; ``padding`` an int, a pair or ``"SAME"`` / ``"VALID"``.
    x and W take the O1 white-list cast; the bias is added after the
    product, in its dtype."""
    x, weight = cast_for_op("conv2d", x, weight)
    dt = torch.promote_types(x.dtype, weight.dtype)
    x, weight = _nchw(x.to(dt), data_format), weight.to(dt)
    enforce(x.dim() == 4 and weight.dim() == 4
            and x.shape[1] == weight.shape[1] * groups,
            f"conv2d: input {tuple(x.shape)} ({data_format}) does not fit "
            f"weight {tuple(weight.shape)} with groups={groups}")
    stride, dilation = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        mode = padding.upper()
        enforce(mode in ("SAME", "VALID"), f"unknown padding {padding!r}")
        pads = [(0, 0), (0, 0)] if mode == "VALID" else [
            _same_pads(x.shape[2 + i], weight.shape[2 + i], stride[i],
                       dilation[i]) for i in range(2)]
        (top, bottom), (left, right) = pads
        if top != bottom or left != right:
            x = TF.pad(x, (left, right, top, bottom))
            pads = [(0, 0), (0, 0)]
        pad = (pads[0][0], pads[1][0])
    else:
        pad = _pair(padding)
    y = TF.conv2d(x, weight, None, stride, pad, dilation, groups)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return _from_nchw(y, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1):
    """x (N, C, L), weight (O, I, K): :func:`conv2d` over a unit height."""
    y = conv2d(x[..., None, :], weight[:, :, None, :], bias=bias,
               stride=(1, stride),
               padding=(0, padding if isinstance(padding, int)
                        else padding[0]),
               dilation=(1, dilation), groups=groups)
    return y[..., 0, :]


def _pool_pads(x, k, p, value):
    """Padding above half the kernel (which torch's pools refuse) applied
    to ``x`` itself; returns ``(x, pad)`` for the pool."""
    if p[0] <= k[0] // 2 and p[1] <= k[1] // 2:
        return x, p
    return TF.pad(x, (p[1], p[1], p[0], p[0]), value=value), (0, 0)


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask: bool = False, data_format: str = "NCHW"):
    """Max over windows, padding counting as -inf; ``return_mask`` also
    gives each maximum's flat index in its (unpadded) input plane, int32
    (NCHW only)."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    x = _nchw(x, data_format)
    padded, p = _pool_pads(x, k, _pair(padding), float("-inf"))
    if not return_mask:
        return _from_nchw(TF.max_pool2d(padded, k, s, p), data_format)
    enforce(data_format == "NCHW", "return_mask supports NCHW")
    enforce(padded is x, "return_mask takes padding of at most half the "
            "kernel")
    out, idx = TF.max_pool2d(x, k, s, p, return_indices=True)
    return out, idx.to(torch.int32)


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCHW"):
    """Mean over windows, divided by the in-bounds count (torch's
    ``count_include_pad=False``)."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    x = _nchw(x, data_format)
    padded, p = _pool_pads(x, k, _pair(padding), 0.0)
    if padded is x:
        y = TF.avg_pool2d(x, k, s, p, count_include_pad=False)
    else:
        ones = torch.ones_like(x[:1, :1])
        counted, _ = _pool_pads(ones, k, _pair(padding), 0.0)
        y = TF.avg_pool2d(padded, k, s) / TF.avg_pool2d(counted, k, s)
    return _from_nchw(y, data_format)


def adaptive_avg_pool2d(x, output_size, data_format: str = "NCHW"):
    """Bin o of an axis covers input rows [o * in // out, ceil((o + 1) *
    in / out)), the JAX bin edges (and torch's)."""
    y = TF.adaptive_avg_pool2d(_nchw(x, data_format), _pair(output_size))
    return _from_nchw(y, data_format)


def adaptive_max_pool2d(x, output_size, data_format: str = "NCHW"):
    y = TF.adaptive_max_pool2d(_nchw(x, data_format), _pair(output_size))
    return _from_nchw(y, data_format)


# ---------------------------------------------------------------------------
# Normalization (paddle_tpu/nn/functional.py:386-435)
# ---------------------------------------------------------------------------
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    """Returns ``(y, new_running_mean, new_running_var)``; the statistics
    are new tensors outside autograd.  ``"NC*"`` formats are channel
    first, the others channel last.

    The JAX op computes in float32 under amp (a black-list op) and returns
    x's dtype; the batch variance is ``E[x^2] - mean^2``, the running
    variance takes ``var * n / max(n - 1, 1)`` and keeps ``momentum`` of
    the old value.  Here ``torch.nn.functional.batch_norm`` computes it
    (cuDNN on the card): it takes a bfloat16 or float16 ``x`` beside the
    float32 statistics as they are and accumulates in float32, returning
    x's dtype, and its momentum is ``1 - momentum``.  The batch variance
    is torch's two-pass one, equal to JAX's up to float32 rounding
    (``tests/test_torch_vision_ops.py`` states and checks the bound).  A
    channel of one value (n = 1), which torch refuses, takes the JAX
    formula."""
    enforce(x.dim() in (2, 3, 4, 5),
            f"batch_norm: x must have 2-5 dims, got {tuple(x.shape)}")
    channel_first = data_format.startswith("NC")
    xc = x if channel_first else x.movedim(-1, 1)
    c = xc.shape[1]
    for name, t in (("running_mean", running_mean),
                    ("running_var", running_var), ("weight", weight),
                    ("bias", bias)):
        enforce(t is None or tuple(t.shape) == (c,),
                f"batch_norm: {name} must be ({c},) for {tuple(x.shape)}")
    n = x.numel() // c
    if training and n == 1:
        y, new_mean, new_var = _batch_norm_one(xc, running_mean,
                                               running_var, weight, bias,
                                               momentum, epsilon)
    else:
        new_mean, new_var = running_mean, running_var
        if training:
            new_mean = running_mean.detach().clone()
            new_var = running_var.detach().clone()
        y = TF.batch_norm(xc, new_mean, new_var, weight, bias, training,
                          1.0 - momentum, epsilon)
    return (y if channel_first else y.movedim(1, -1)), new_mean, new_var


def _batch_norm_one(xc, running_mean, running_var, weight, bias,
                    momentum, epsilon):
    """The JAX formula at one value a channel: the batch variance is 0."""
    shape = (1, -1) + (1,) * (xc.dim() - 2)
    mean = xc.float().reshape(1, -1)[0]
    new_mean = (momentum * running_mean + (1 - momentum) * mean).detach()
    new_var = (momentum * running_var).detach()
    y = (xc.float() - mean.reshape(shape)) * (epsilon ** -0.5)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(xc.dtype), new_mean, new_var


def group_norm(x, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5):
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


# ---------------------------------------------------------------------------
# Shaping and losses (paddle_tpu/nn/functional.py:456-535, :701-710)
# ---------------------------------------------------------------------------
def flatten(x, start_axis: int = 0, stop_axis: int = -1):
    nd = x.dim()
    if stop_axis < 0:
        stop_axis += nd
    return x.reshape(tuple(x.shape[:start_axis]) + (-1,)
                     + tuple(x.shape[stop_axis + 1:]))


def one_hot(x, num_classes: int, dtype=torch.float32):
    return TF.one_hot(x.long(), num_classes).to(dtype)


def _reduce(loss, reduction: str):
    enforce(reduction in ("mean", "sum", "none"),
            f"unknown reduction {reduction!r}")
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def nll_loss(log_probs, label, reduction: str = "mean"):
    picked = torch.gather(log_probs, -1, label.long()[..., None])[..., 0]
    return _reduce(-picked, reduction)


def mse_loss(input, label, reduction: str = "mean"):
    return _reduce((input - label).square(), reduction)


# ---------------------------------------------------------------------------
# The rest of the activations and simple losses (paddle_tpu/nn/
# functional.py:63-87, :528-554)
# ---------------------------------------------------------------------------
def elu(x, alpha: float = 1.0):
    """``jax.nn.elu``: ``x`` above 0, ``alpha (e^x - 1)`` at and below."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(
        torch.where(pos, torch.zeros_like(x), x)))


def mish(x):
    """``x tanh(softplus(x))`` with ``jax.nn.softplus``'s unthresholded
    ``log(1 + e^x)``."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)


def l1_loss(input, label, reduction: str = "mean"):
    return _reduce((input - label).abs(), reduction)


def binary_cross_entropy_with_logits(logit, label, reduction: str = "mean"):
    loss = (torch.maximum(logit, logit.new_zeros(())) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction: str = "mean",
                   delta: float = 1.0):
    d = (input - label).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def square_error_cost(input, label):
    """Elementwise ``(input - label)^2``."""
    d = input - label
    return d * d


def label_smooth(label, prior_dist=None, epsilon: float = 0.1):
    """``(1 - epsilon) label + epsilon prior`` (a uniform prior by default);
    integer one-hots become float32."""
    if not label.is_floating_point():
        label = label.float()
    k = label.shape[-1]
    prior = (torch.full((k,), 1.0 / k, dtype=label.dtype,
                        device=label.device) if prior_dist is None
             else prior_dist.reshape(-1).to(label.dtype))
    return (1.0 - epsilon) * label + epsilon * prior


def softmax_mask_fuse_upper_triangle(x):
    """Softmax in float32 (float64 stays) over the last axis with the keys
    above the (bottom-right aligned) diagonal masked to float32 min; x's
    dtype."""
    ql, kl = x.shape[-2], x.shape[-1]
    causal = torch.ones((ql, kl), dtype=torch.bool,
                        device=x.device).tril(kl - ql)
    xf = x if x.dtype == torch.float64 else x.float()
    xf = torch.where(causal, xf, torch.finfo(torch.float32).min)
    return torch.softmax(xf, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Tensor shaping, padding, resizing (paddle_tpu/nn/functional.py:627-698,
# :824-874)
# ---------------------------------------------------------------------------
def pad(x, paddings, mode: str = "constant", value: float = 0.0):
    """Paddle's flat pad list: (before, after) pairs for the trailing dims,
    last dim first ([l, r, t, b] on NCHW pads W by (l, r), H by (t, b)),
    or one pair a dim in order when the list covers every dim.  ``mode``
    is ``jnp.pad``'s: ``"constant"`` (``value``), ``"reflect"``,
    ``"symmetric"``, ``"edge"`` or ``"wrap"``; the others gather the
    source indices that ``numpy.pad`` gives a range."""
    paddings = [int(p) for p in paddings]
    enforce(len(paddings) % 2 == 0, "paddings must have an even length")
    npairs = len(paddings) // 2
    enforce(npairs <= x.dim(), "more padding pairs than tensor dims")
    if npairs == x.dim():
        cfg = [(paddings[2 * i], paddings[2 * i + 1]) for i in range(x.dim())]
    else:
        cfg = [(0, 0)] * x.dim()
        for i in range(npairs):
            cfg[x.dim() - 1 - i] = (paddings[2 * i], paddings[2 * i + 1])
    if mode == "constant":
        flat = [v for pair in reversed(cfg) for v in pair]
        return TF.pad(x, flat, value=value)
    enforce(mode in ("reflect", "symmetric", "edge", "wrap"),
            f"unknown pad mode {mode!r}")
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[dim]), (lo, hi), mode=mode)
            x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def clip(x, min=None, max=None):  # noqa: A002
    """``jnp.clip``: ``minimum(maximum(x, min), max)``."""
    if min is not None:
        x = torch.maximum(x, x.new_full((), min))
    if max is not None:
        x = torch.minimum(x, x.new_full((), max))
    return x


def normalize(x, p: float = 2.0, axis: int = 1, epsilon: float = 1e-12):
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


def _align_corners_matrix(in_size: int, out_size: int):
    """(out, in) linear interpolation matrix whose end points map to end
    points (``align_corners=True``)."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        pos = i * (in_size - 1) / (out_size - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        frac = pos - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, data_format: str = "NCHW"):
    """Resize the two spatial dims of a 4-D tensor as ``jax.image.resize``
    does: ``"nearest"`` is torch's ``"nearest-exact"`` (half-pixel
    centres), ``"bilinear"`` is torch's antialiased bilinear (a triangle
    filter widened by the scale when the image shrinks).  With
    ``align_corners`` (bilinear only) two interpolation matrices whose
    end points meet.  ``scale_factor`` gives ``int(side * scale)``."""
    enforce(mode in ("nearest", "bilinear"), f"unknown mode {mode!r}")
    enforce(not align_corners or mode == "bilinear",
            f"align_corners is only valid for interpolating modes "
            f"(bilinear), got mode={mode!r}")
    x = _nchw(x, data_format)
    h, w = x.shape[2], x.shape[3]
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    size = (int(size[0]), int(size[1]))
    if align_corners:
        mh = torch.from_numpy(_align_corners_matrix(h, size[0])).to(
            x.device, x.dtype)
        mw = torch.from_numpy(_align_corners_matrix(w, size[1])).to(
            x.device, x.dtype)
        y = torch.einsum("oh,nchw,pw->ncop", mh, x, mw)
    elif mode == "nearest":
        y = TF.interpolate(x, size=size, mode="nearest-exact")
    else:
        y = TF.interpolate(x, size=size, mode="bilinear",
                           align_corners=False, antialias=True)
    return _from_nchw(y, data_format)


def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW"):
    """(N, C r^2, H, W) -> (N, C, H r, W r), or its NHWC form."""
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def prelu(x, weight):
    """``x`` where non-negative, else ``weight x``; a weight of several
    values is per channel (axis 1)."""
    if weight.numel() > 1 and x.dim() > 1:
        weight = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, weight * x)


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


# ---------------------------------------------------------------------------
# Convolutions and pools of other ranks (paddle_tpu/nn/functional.py:
# 713-790; _functional_ext.py:166-218)
# ---------------------------------------------------------------------------
def _ntuple(v, n: int):
    if isinstance(v, (list, tuple)):
        enforce(len(v) == n, f"expected {n} values, got {v}")
        return tuple(int(i) for i in v)
    return (int(v),) * n


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCDHW"):
    """x (N, C, D, H, W) (or NDHWC), weight (O, I / groups, kD, kH, kW);
    ``padding`` an int, a triple or ``"SAME"`` / ``"VALID"`` (``lax``'s
    SAME, as :func:`conv2d`)."""
    x, weight = cast_for_op("conv2d", x, weight)
    dt = torch.promote_types(x.dtype, weight.dtype)
    cl = data_format == "NDHWC"
    enforce(data_format in ("NCDHW", "NDHWC"),
            f"unknown data_format {data_format!r}")
    x = (x.permute(0, 4, 1, 2, 3) if cl else x).to(dt)
    weight = weight.to(dt)
    stride, dilation = _ntuple(stride, 3), _ntuple(dilation, 3)
    if isinstance(padding, str):
        mode = padding.upper()
        enforce(mode in ("SAME", "VALID"), f"unknown padding {padding!r}")
        pads = [(0, 0)] * 3 if mode == "VALID" else [
            _same_pads(x.shape[2 + i], weight.shape[2 + i], stride[i],
                       dilation[i]) for i in range(3)]
        if any(lo != hi for lo, hi in pads):
            x = TF.pad(x, [v for pair in reversed(pads) for v in pair])
            pads = [(0, 0)] * 3
        pad = tuple(lo for lo, _ in pads)
    else:
        pad = _ntuple(padding, 3)
    y = TF.conv3d(x, weight, None, stride, pad, dilation, groups)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1) if cl else y


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd, channel_last):
    """The transposed convolution of ``nd`` spatial dims: weight (in,
    out / groups, *k), the layout torch's ``conv_transpose`` takes, and
    out = (in - 1) s - 2 p + d (k - 1) + 1 + output_padding.  Torch
    refuses an output padding of at least ``max(stride, dilation)``,
    which the JAX op pads as any other: then the full output (no
    padding) is computed and cropped, its rows past the end zero."""
    x, weight = cast_for_op("conv2d", x, weight)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if channel_last:
        x = x.movedim(-1, 1)
    x, weight = x.to(dt), weight.to(dt)
    s, d = _ntuple(stride, nd), _ntuple(dilation, nd)
    p, op = _ntuple(padding, nd), _ntuple(output_padding, nd)
    fn = (TF.conv_transpose1d, TF.conv_transpose2d,
          TF.conv_transpose3d)[nd - 1]
    if all(o < max(si, di) for o, si, di in zip(op, s, d)):
        y = fn(x, weight, None, s, p, op, groups, d)
    else:
        full = fn(x, weight, None, s, 0, 0, groups, d)
        for i in range(nd):
            size = full.shape[2 + i] - 2 * p[i] + op[i]
            extra = max(p[i] + size - full.shape[2 + i], 0)
            if extra:
                widths = [0] * (2 * nd)
                widths[2 * (nd - 1 - i) + 1] = extra
                full = TF.pad(full, widths)
            full = full.narrow(2 + i, p[i], size)
        y = full
    if bias is not None:
        y = y + bias.to(y.dtype).reshape((1, -1) + (1,) * nd)
    return y.movedim(1, -1) if channel_last else y


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups: int = 1,
                     data_format: str = "NCHW"):
    """weight (in, out / groups, kh, kw), paddle's IOHW transpose layout,
    for either ``data_format``; out = (in - 1) s - 2 p + d (k - 1) + 1 +
    output_padding."""
    enforce(data_format in ("NCHW", "NHWC"),
            f"unknown data_format {data_format!r}")
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format == "NHWC")


def max_pool1d(x, kernel_size, stride=None, padding=0):
    """x (N, C, L): :func:`max_pool2d` over a unit height."""
    return max_pool2d(x[..., None, :], (1, kernel_size),
                      (1, stride if stride is not None else kernel_size),
                      (0, padding))[..., 0, :]


def avg_pool1d(x, kernel_size, stride=None, padding=0):
    return avg_pool2d(x[..., None, :], (1, kernel_size),
                      (1, stride if stride is not None else kernel_size),
                      (0, padding))[..., 0, :]


# ---------------------------------------------------------------------------
# Metric losses and CTC (paddle_tpu/nn/functional.py:889-997)
# ---------------------------------------------------------------------------
def kl_div(input, label, reduction: str = "mean"):
    """``input`` log-probabilities, ``label`` probabilities; ``"mean"`` is
    over every element."""
    loss = torch.where(label > 0, label * (torch.log(
        torch.clamp(label, min=1e-30)) - input), input.new_zeros(()))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean"):
    d = -label * (input - other) + margin
    return _reduce(torch.maximum(d, d.new_zeros(())), reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean"):
    other = margin - input
    return _reduce(torch.where(label == 1.0, input, torch.maximum(
        other, other.new_zeros(()))), reduction)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean"):
    sim = cosine_similarity(input1, input2, axis=-1)
    other = sim - margin
    return _reduce(torch.where(label == 1, 1.0 - sim, torch.maximum(
        other, other.new_zeros(()))), reduction)


def triplet_margin_loss(anchor, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean"):
    dp = pairwise_distance(anchor, positive, p, epsilon)
    dn = pairwise_distance(anchor, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, pairwise_distance(positive, negative, p,
                                                 epsilon))
    d = dp - dn + margin
    return _reduce(torch.maximum(d, d.new_zeros(())), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, reduction: str = "mean"):
    """CTC by the alpha recursion in log space, the JAX op's: ``log_probs``
    (T, B, C) log-softmax outputs, ``labels`` (B, S) padded past
    ``label_lengths``.  The lattice is blank, l1, blank, ..., lS, blank
    (2S + 1 cells, -1e30 the empty value); one step a time step, each a
    few (B, 2S + 1) ops, the emissions of every step gathered before the
    loop.  A row ends at ``input_lengths - 1``; a zero-length label has
    one cell.  ``"mean"`` divides each row by its label length (at least
    1) before the mean.  The gradient is autograd's through the
    recursion, so with respect to ``log_probs`` it is the JAX op's (minus
    the posterior of each cell), not ``torch.nn.functional.ctc_loss``'s,
    which assumes log_probs come from a log-softmax."""
    enforce(reduction in ("mean", "sum", "none"),
            f"unknown reduction {reduction!r}")
    T, B, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.long)
    S = labels.shape[1]
    L = 2 * S + 1
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()
    input_lengths = torch.as_tensor(input_lengths, device=dev).long()
    neg = torch.full((), -1e30, dtype=log_probs.dtype, device=dev)
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    ext_len = 2 * label_lengths + 1
    can_skip = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if S > 1:
        can_skip[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < ext_len[:, None]
    emit = log_probs.gather(2, ext[None].expand(T, B, L))
    alpha = torch.where(valid & (pos <= 1), emit[0], neg)
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    alphas = [alpha]
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]],
                                                 dim=1), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        alpha = torch.where(valid, merged + emit[t], neg)
        alphas.append(alpha)
    final = torch.stack(alphas)[input_lengths - 1, torch.arange(B,
                                                                device=dev)]
    last = final.gather(1, (ext_len - 1)[:, None])[:, 0]
    second = final.gather(1, torch.clamp(ext_len - 2, min=0)[:, None])[:, 0]
    second = torch.where(ext_len >= 2, second, neg)
    loss = -torch.logaddexp(last, second)
    if reduction == "mean":
        return (loss / torch.clamp(label_lengths, min=1).to(
            loss.dtype)).mean()
    return _reduce(loss, reduction)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None):
    """Attention over a CSR pattern: q / k / v (B, H, S, D), offsets (B,
    H, S + 1), columns (B, H, nnz).  The nnz scores are gathers; each
    row's softmax is a segment softmax (``scatter_reduce`` amax for the
    shift, ``index_add_`` for the sums), and the output an ``index_add_``
    of the weighted value rows.  Entry j belongs to the row whose offsets
    bracket it (the last row for entries past the final offset), and a
    row with no entry comes out zero, as in the JAX op.  The masks are
    additive: ``key_padding_mask`` (B, S) by column, ``attn_mask`` (S, S)
    by (row, column)."""
    query, key = cast_for_op("attention", query, key)
    b, h, s, d = query.shape
    dev = query.device
    offset = sparse_csr_offset.to(dev).long().reshape(b * h, s + 1)
    cols = sparse_csr_columns.to(dev).long().reshape(b * h, -1)
    nnz = cols.shape[1]
    j = torch.arange(nnz, device=dev).expand(b * h, nnz).contiguous()
    row = torch.clamp(torch.searchsorted(offset, j, right=True) - 1, 0,
                      s - 1)
    base = (torch.arange(b * h, device=dev) * s)[:, None]
    grow, gcol = (row + base).reshape(-1), (cols + base).reshape(-1)
    q = query.reshape(b * h * s, d)
    k = key.reshape(b * h * s, d)
    v = value.reshape(b * h * s, -1)
    dt = torch.promote_types(q.dtype, k.dtype)
    score = (q[grow].to(dt) * k[gcol].to(dt)).sum(-1) * d ** -0.5
    if key_padding_mask is not None:
        kpm = key_padding_mask.to(dev, score.dtype)
        score = score + kpm[torch.arange(b, device=dev).repeat_interleave(
            h * nnz), cols.reshape(-1)]
    if attn_mask is not None:
        score = score + attn_mask.to(dev, score.dtype)[row.reshape(-1),
                                                       cols.reshape(-1)]
    n = b * h * s
    m = score.new_full((n,), float("-inf")).scatter_reduce(
        0, grow, score.detach(), "amax", include_self=False)
    m = torch.where(torch.isfinite(m), m, m.new_zeros(()))
    e = torch.exp(score - m[grow])
    z = score.new_zeros(n).index_add(0, grow, e)
    p = e / torch.clamp(z[grow], min=1e-30)
    out = v.new_zeros((n, v.shape[1]), dtype=torch.promote_types(
        p.dtype, v.dtype)).index_add(0, grow, p[:, None] * v[gcol])
    return out.reshape(b, h, s, -1)


# ---------------------------------------------------------------------------
# Decoding (paddle_tpu/nn/_functional_ext.py:823)
# ---------------------------------------------------------------------------
def gather_tree(ids, parents):
    """Backtrace beam-search parent pointers into whole sequences: ``ids``
    and ``parents`` are (T, B, beam); the result (T, B, beam) holds, for
    each final beam, the token it took at every step."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(ids[t].gather(1, beam))
        beam = parents[t].gather(1, beam).long()
    return torch.stack(toks[::-1])


# the rest of the functional surface (paddle_tpu/nn/_functional_ext.py);
# last, so that module finds every name above
from ._functional_ext import *  # noqa: F401,F403,E402
from ._functional_ext import __all__ as _ext_all  # noqa: E402

__all__ = __all__ + _ext_all
