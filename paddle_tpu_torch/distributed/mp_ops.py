"""Model-parallel functional ops, serial form: the port of
``paddle_tpu/distributed/mp_ops.py`` ``parallel_cross_entropy`` and
``masked_token_reduce`` for one card.  The vocab-parallel (shard_map) mode
comes with the multi-GPU slice; serially the loss is the numerically
stable softmax cross-entropy over the whole vocabulary."""
from __future__ import annotations

import torch

from ..framework.errors import enforce

__all__ = ["parallel_cross_entropy", "masked_token_reduce"]


def parallel_cross_entropy(logits, label, reduction: str = "none",
                           ignore_index: int = -100):
    """Softmax cross-entropy of ``logits`` (..., vocab) against integer
    ``label`` (...), computed in float32; ``ignore_index`` labels count
    zero (``reduction="mean"`` divides by the valid count)."""
    lf = logits.float()
    gmax = lf.amax(dim=-1)
    shifted = lf - gmax[..., None]
    sum_exp = torch.exp(shifted).sum(dim=-1)
    safe = label.long().clamp(0, lf.shape[-1] - 1)
    picked = torch.gather(shifted, -1, safe[..., None])[..., 0]
    loss = torch.log(sum_exp) - picked
    return masked_token_reduce(loss, label != ignore_index, reduction)


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
