"""Megatron-style model-parallel layers as serial single-device layers: the
port of ``paddle_tpu/distributed/mp_layers.py`` for one card.

They keep the JAX package's class and parameter names so the model's
``state_dict`` keys match (``gpt.h.0.attn.qkv_proj.weight``); sharding over
several cards comes with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import functional as F
from ..nn.layers import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(Linear):
    """``Y = X @ W + b``, W (in, out); serial here."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, device: Optional[torch.device] = None):
        super().__init__(in_features, out_features, std=std, device=device)


class RowParallelLinear(Linear):
    """``Y = X @ W + b`` with the bias added after the (here trivial)
    cross-shard sum, as the JAX layer orders it."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, device: Optional[torch.device] = None):
        super().__init__(in_features, out_features, std=std, device=device)

    def forward(self, x):
        y = F.linear(x, self.weight, None)
        return y + self.bias.to(y.dtype)


class VocabParallelEmbedding(Embedding):
    """Embedding over the whole vocabulary; serial here."""
