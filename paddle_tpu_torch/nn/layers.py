"""The layers the serving and training slices need: the port of the
matching parts of ``paddle_tpu/nn/layers.py``.  Parameter names and layouts
match the JAX package (``weight`` / ``bias``; Linear weights are (in,
out)), so ``state_dict`` keys carry over unchanged."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["LayerNorm", "Dropout", "Linear", "Embedding"]


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
    """``y = x @ W + b`` with ``W`` (in_features, out_features)."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, device: Optional[torch.device] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device))
        nn.init.normal_(self.weight, 0.0, std)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

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
