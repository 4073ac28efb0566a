"""The fused Transformer layers of ``incubate.nn``: the port of
``paddle_tpu/incubate/nn.py`` (reference ``incubate/nn/layer/
fused_transformer.py``).  They are built on the compositions of
``ops/fused.py`` and plain attention, as the JAX layers are one XLA region
each; no kernel of the port runs here.  Parameter names match the JAX
layers (``qkv_proj``, ``out_proj``, ``norm``, ``linear1``, ``linear2``),
so ``state_dict`` keys carry over."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..framework.errors import enforce
from ..nn import functional as F
from ..nn.layers import LayerNorm, Linear
from ..ops import fused as fused_ops

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


class FusedMultiHeadAttention(nn.Module):
    """[pre-LN] -> one (E, 3E) QKV product (columns q | k | v) ->
    attention -> out projection -> bias + dropout + residual -> [post-LN]
    (``fused_attention_op`` semantics)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 normalize_before: bool = False, epsilon: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        enforce(num_heads > 0 and embed_dim % num_heads == 0,
                f"num_heads must be positive and divide embed_dim "
                f"(got num_heads={num_heads}, embed_dim={embed_dim})")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, device=device)
        self.norm = LayerNorm(embed_dim, epsilon=epsilon, device=device)

    def forward(self, x, attn_mask=None):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training)
        out = out.transpose(1, 2).reshape(b, s, self.embed_dim)
        out = F.linear(out, self.out_proj.weight, None)
        out = fused_ops.fused_bias_dropout_residual(
            out, residual, self.out_proj.bias, self.dropout_rate,
            self.training)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedFeedForward(nn.Module):
    """[pre-LN] -> GEMM + act (+ dropout) -> GEMM -> bias + dropout +
    residual -> [post-LN], by ``ops.fused.fused_feedforward``."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, epsilon: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate
                                 if act_dropout_rate is not None
                                 else dropout_rate)
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm = LayerNorm(d_model, epsilon=epsilon, device=device)

    def forward(self, x):
        return fused_ops.fused_feedforward(
            x, self.linear1.weight, self.linear1.bias, self.linear2.weight,
            self.linear2.bias, self.norm.weight, self.norm.bias,
            activation=self.activation, dropout1=self.act_dropout_rate,
            dropout2=self.dropout_rate, epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Module):
    """:class:`FusedMultiHeadAttention` then :class:`FusedFeedForward`:
    one encoder block (``fused_attn``, ``ffn``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 attn_dropout_rate: Optional[float] = None,
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate
                               if attn_dropout_rate is not None
                               else dropout_rate),
            normalize_before=normalize_before, device=device)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation,
            act_dropout_rate=(act_dropout_rate
                              if act_dropout_rate is not None
                              else dropout_rate),
            normalize_before=normalize_before, device=device)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
