"""The functional ops the serving and training slices call: the port of the
matching parts of ``paddle_tpu/nn/functional.py``.  Plain PyTorch; the JAX
package computes these outside any Pallas kernel too, except for the
flash-attention route of :func:`scaled_dot_product_attention`.

Type promotion follows JAX: an op on a bfloat16 activation and a float32
parameter computes and returns float32 (``jnp.matmul`` promotes; torch's
``matmul`` refuses mixed dtypes, so :func:`linear` promotes first).  Under
``amp.auto_cast`` the ops consult ``amp.state.cast_for_op`` first, as the
JAX ops do: ``linear`` / ``matmul`` / ``attention`` down to the amp dtype,
``layer_norm`` up to float32.  Dropout masks come from the device's
explicit generator (``framework/random.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp.state import cast_for_op
from ..framework import random as fw_random
from ..framework.errors import enforce

__all__ = ["gelu", "tanh", "layer_norm", "linear", "matmul", "embedding",
           "dropout", "cross_entropy", "scaled_dot_product_attention"]


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


def embedding(ids, weight):
    return weight[ids.long()]


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
    suffix of the key sequence).  Scores and softmax run in float32; the
    probabilities are cast to ``v``'s dtype for the value product.

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
    scores = scores.float()
    if attn_mask is not None:
        scores = scores + attn_mask.float()
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
