"""The functional ops the serving slice calls: the port of the matching parts
of ``paddle_tpu/nn/functional.py``.  Plain PyTorch; the JAX package computes
these outside any Pallas kernel too.

Type promotion follows JAX: an op on a bfloat16 activation and a float32
parameter computes and returns float32 (``jnp.matmul`` promotes; torch's
``matmul`` refuses mixed dtypes, so :func:`linear` promotes first).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.errors import UnimplementedError

__all__ = ["gelu", "layer_norm", "linear", "embedding",
           "scaled_dot_product_attention"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, as ``jax.nn.gelu(approximate=False)``."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims, computed in
    ``x``'s dtype (outside autocast the JAX op does not upcast)."""
    orig_dtype = x.dtype
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
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embedding(ids, weight):
    return weight[ids.long()]


def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None):
    """q, k, v: (batch, heads, seq, head_dim); ``attn_mask`` is additive.
    ``is_causal`` aligns the triangle bottom-right (the query block is the
    suffix of the key sequence).  Scores and softmax run in float32; the
    probabilities are cast to ``v``'s dtype for the value product."""
    if dropout_p > 0.0 and training:
        raise UnimplementedError(
            "attention-probability dropout comes with the training slice")
    if scale is None:
        scale = q.shape[-1] ** -0.5
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
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
