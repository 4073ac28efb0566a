"""Model-parallel functional ops: the port of
``paddle_tpu/distributed/mp_ops.py`` (``parallel_cross_entropy``:36,
``parallel_log_softmax``:94, ``vocab_parallel_embedding``:105,
``masked_token_reduce``:80).

Over vocab-sharded logits (the last axis of each mp rank's block, vocab
``[vocab_start, vocab_start + n)``) the loss never gathers the logits:
the max, the sum of exponentials and the target's logit are each
all-reduced over mp, as the reference's c_softmax_with_cross_entropy
kernel does (.cu:123, :184, :165).  The gradient of each rank's block is
``softmax - onehot`` on its own columns.  Without a hybrid group (or at
mp = 1) these are the whole-vocabulary computations.
"""
from __future__ import annotations

import torch

from ..framework.errors import enforce
from . import collective
from . import topology as topo

__all__ = ["parallel_cross_entropy", "parallel_log_softmax",
           "vocab_parallel_embedding", "masked_token_reduce"]


def _mp() -> int:
    return topo.axis_size("mp")


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``lse - logit[label]`` (float32) of vocab-sharded float32
    logits; backward ``(softmax - onehot) * g`` on this rank's block."""

    @staticmethod
    def forward(ctx, lf, label, vocab_start: int):
        n = lf.shape[-1]
        gmax = collective.all_reduce(lf.amax(dim=-1),
                                     op=collective.ReduceOp.MAX, group="mp")
        shifted = lf - gmax[..., None]
        exp = torch.exp(shifted)
        sum_exp = collective.all_reduce(exp.sum(dim=-1), group="mp")
        local = label.long() - vocab_start
        hit = (local >= 0) & (local < n)
        picked = torch.gather(shifted, -1, local.clamp(0, n - 1)[..., None]
                              )[..., 0]
        picked = collective.all_reduce(
            torch.where(hit, picked, torch.zeros_like(picked)), group="mp")
        ctx.save_for_backward(exp, sum_exp, local, hit)
        return torch.log(sum_exp) - picked

    @staticmethod
    def backward(ctx, g):
        exp, sum_exp, local, hit = ctx.saved_tensors
        n = exp.shape[-1]
        grad = exp / sum_exp[..., None]
        onehot = torch.nn.functional.one_hot(local.clamp(0, n - 1), n).to(
            grad.dtype) * hit[..., None].to(grad.dtype)
        return (grad - onehot) * g[..., None], None, None


def _start(vocab_start, block: int) -> int:
    """Where this rank's vocabulary block starts: ``vocab_start``, or its mp
    coordinate times the block (the JAX ``axis_index * vocab_local``)."""
    return (topo.axis_rank("mp") * block if vocab_start is None
            else int(vocab_start))


def parallel_cross_entropy(logits, label, reduction: str = "none",
                           ignore_index: int = -100, vocab_start=None):
    """Softmax cross-entropy of ``logits`` (..., vocab) against integer
    ``label`` (...), computed in float32; ``ignore_index`` labels count
    zero (``reduction="mean"`` divides by the valid count).  Under mp the
    logits are this rank's block of the vocabulary (from ``vocab_start``,
    by default its mp coordinate times the block) and ``label`` holds
    global ids."""
    lf = logits.float()
    if _mp() > 1:
        loss = _VocabParallelCE.apply(lf, label,
                                      _start(vocab_start, lf.shape[-1]))
    else:
        gmax = lf.amax(dim=-1)
        shifted = lf - gmax[..., None]
        sum_exp = torch.exp(shifted).sum(dim=-1)
        safe = label.long().clamp(0, lf.shape[-1] - 1)
        picked = torch.gather(shifted, -1, safe[..., None])[..., 0]
        loss = torch.log(sum_exp) - picked
    return masked_token_reduce(loss, label != ignore_index, reduction)


def parallel_log_softmax(logits):
    """log_softmax over the (vocab-sharded under mp) last axis."""
    lf = logits.float()
    if _mp() == 1:
        return torch.log_softmax(lf, dim=-1)
    # the max is a constant shift: no gradient flows through it
    gmax = collective.all_reduce(lf.detach().amax(dim=-1),
                                 op=collective.ReduceOp.MAX, group="mp")
    shifted = lf - gmax[..., None]
    from .mp_layers import reduce_from_mp
    sum_exp = reduce_from_mp(torch.exp(shifted).sum(dim=-1))
    return shifted - torch.log(sum_exp)[..., None]


class _VocabParallelEmbed(torch.autograd.Function):
    """c_embedding: this rank's rows for the ids it holds, zeros for the
    rest, summed over mp; the table's gradient on its own rows."""

    @staticmethod
    def forward(ctx, ids, table, vocab_start: int):
        n = table.shape[0]
        local = ids.long() - vocab_start
        hit = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        ctx.save_for_backward(local, hit)
        ctx.table_shape = table.shape
        return collective.all_reduce(rows, group="mp")

    @staticmethod
    def backward(ctx, g):
        local, hit = ctx.saved_tensors
        n, h = ctx.table_shape
        dtable = torch.zeros((n, h), dtype=g.dtype, device=g.device)
        dtable.index_add_(0, local[hit], g[hit])
        return None, dtable, None


def vocab_parallel_embedding(ids, table, vocab_start=None):
    """The rows of the whole table at ``ids``; under mp ``table`` is this
    rank's block of rows (from ``vocab_start``, by default its mp
    coordinate times the block)."""
    if _mp() == 1:
        return table[ids.long()]
    return _VocabParallelEmbed.apply(ids, table,
                                     _start(vocab_start, table.shape[0]))


def masked_token_reduce(loss, valid, reduction: str):
    """Invalid tokens contribute 0; "mean" divides by the valid count
    (floor 1 for an all-ignored batch); "none" returns the masked losses."""
    enforce(reduction in ("mean", "sum", "none"),
            f"unknown reduction {reduction!r}")
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                 device=loss.device))
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
