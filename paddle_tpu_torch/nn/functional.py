"""The functional ops the serving, training and vision slices call: the
port of the matching parts of ``paddle_tpu/nn/functional.py``.  Plain
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
           "one_hot", "nll_loss", "mse_loss", "rms_norm", "gather_tree"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, as ``jax.nn.gelu(approximate=False)``."""
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
