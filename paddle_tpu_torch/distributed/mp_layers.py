"""Megatron-style model-parallel layers: the port of
``paddle_tpu/distributed/mp_layers.py`` (reference fleet/meta_parallel/
mp_layers.py: ``VocabParallelEmbedding``:30, ``ColumnParallelLinear``:97,
``RowParallelLinear``:170).

The JAX layers keep global-shaped parameters and let GSPMD split them by
their ``PartitionSpec``.  Here each rank holds its shard, read from the
hybrid group at construction (``topology.get_hybrid_communicate_group``;
one rank, the whole parameter, without a group), and the collectives are
written where GSPMD puts them:

- ``ColumnParallelLinear``: W (in, out / mp), b (out / mp).  The input
  enters through :class:`_CopyToMP` (identity forward, all-reduce of the
  gradient over mp); ``gather_output`` all-gathers the output columns
  (:class:`_GatherFromMP`, its gradient the rank's slice);
- ``RowParallelLinear``: W (in / mp, out), b (out) whole.  The input is the
  rank's slice (``input_is_parallel``) or is cut to it
  (:class:`_ScatterToMP`); the partial products are summed over mp
  (:class:`_ReduceFromMP`, identity backward) and the bias is added after
  the sum, as the JAX layer orders it;
- ``VocabParallelEmbedding``: W (vocab / mp, h), rows
  ``[r * vocab / mp, (r + 1) * vocab / mp)`` on mp rank r; ids outside
  them give zero rows, and the lookups are summed over mp (c_embedding).

Parameter names are the JAX layers' (``weight``, ``bias``), so a model's
``state_dict`` keys are unchanged; ``convert.shard_state`` cuts a whole
state into these shards and ``convert.gather_state`` puts it back.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..framework.errors import enforce
from ..nn import functional as F
from ..nn.layers import Embedding, Linear
from . import collective
from . import topology as topo

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mp_degree", "mp_rank",
           "copy_to_mp", "reduce_from_mp", "gather_from_mp", "scatter_to_mp"]


def mp_degree() -> int:
    return topo.axis_size("mp")


def mp_rank() -> int:
    return topo.axis_rank("mp")


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient summed over mp (the input feeds every
    rank's shard)."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g, group="mp")


class _ReduceFromMP(torch.autograd.Function):
    """The partial results summed over mp; identity backward."""

    @staticmethod
    def forward(ctx, x):
        return collective.all_reduce(x, group="mp")

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromMP(torch.autograd.Function):
    """The ranks' last-axis blocks concatenated; the gradient's own block
    back."""

    @staticmethod
    def forward(ctx, x):
        return collective.all_gather(x, group="mp", axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return collective.split(g, group="mp", axis=-1)


class _ScatterToMP(torch.autograd.Function):
    """This rank's last-axis block; the gradient gathered back."""

    @staticmethod
    def forward(ctx, x):
        return collective.split(x, group="mp", axis=-1)

    @staticmethod
    def backward(ctx, g):
        return collective.all_gather(g, group="mp", axis=g.dim() - 1)


def copy_to_mp(x):
    return _CopyToMP.apply(x) if mp_degree() > 1 else x


def reduce_from_mp(x):
    return _ReduceFromMP.apply(x) if mp_degree() > 1 else x


def gather_from_mp(x):
    return _GatherFromMP.apply(x) if mp_degree() > 1 else x


def scatter_to_mp(x):
    return _ScatterToMP.apply(x) if mp_degree() > 1 else x


def _mark_distributed(*params) -> None:
    """Tag the parameters each mp rank holds a different shard of (the
    reference's ``is_distributed``, a name torch tensors already use as a
    method): the global-norm clip counts them on
    every mp rank, and the mp broadcast leaves them alone."""
    for p in params:
        p.mp_sharded = mp_degree() > 1


def _split_size(total: int, what: str) -> int:
    n = mp_degree()
    enforce(total % n == 0, f"{what} {total} is not divisible by the "
            f"model-parallel degree {n}")
    return total // n


class ColumnParallelLinear(Linear):
    """``Y = X @ W[:, shard] + b[shard]`` (reference mp_layers.py:97): W
    (in, out / mp) on each rank.  ``gather_output`` returns the whole
    output (the columns all-gathered); otherwise the rank's columns, for
    a following :class:`RowParallelLinear`."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, gather_output: bool = True,
                 device: Optional[torch.device] = None):
        super().__init__(in_features, _split_size(out_features,
                                                  "out_features"),
                         std=std, device=device)
        self.gather_output = gather_output
        self.full_out_features = out_features
        _mark_distributed(self.weight, self.bias)

    def forward(self, x):
        y = F.linear(copy_to_mp(x), self.weight, self.bias)
        return gather_from_mp(y) if self.gather_output else y


class RowParallelLinear(Linear):
    """``Y = sum over mp of X[shard] @ W[shard, :] + b`` (reference
    mp_layers.py:170): W (in / mp, out) on each rank, b whole and added
    after the sum."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, input_is_parallel: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__(_split_size(in_features, "in_features"),
                         out_features, std=std, device=device)
        self.input_is_parallel = input_is_parallel
        self.full_in_features = in_features
        _mark_distributed(self.weight)

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_mp(x)
        y = reduce_from_mp(F.linear(x, self.weight, None))
        return y + self.bias.to(y.dtype)


class VocabParallelEmbedding(Embedding):
    """Embedding with the vocabulary split over mp (reference
    mp_layers.py:30, c_embedding_op.cc): rank r holds rows ``[r * n, (r +
    1) * n)``; other ids give zero rows and the lookups are summed."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, device: Optional[torch.device] = None):
        super().__init__(_split_size(num_embeddings, "num_embeddings"),
                         embedding_dim, std=std, device=device)
        self.full_num_embeddings = num_embeddings
        self.vocab_start = mp_rank() * self.num_embeddings
        _mark_distributed(self.weight)

    def forward(self, ids):
        if mp_degree() == 1:
            return super().forward(ids)
        from .mp_ops import vocab_parallel_embedding
        return vocab_parallel_embedding(ids, self.weight,
                                        vocab_start=self.vocab_start)

