"""``paddle.text`` of the port: the port of ``paddle_tpu/text/``: the
datasets (``datasets.py``), the WordPiece tokenizer with its native C core
(``tokenizer.py``) and the ``viterbi_decode`` op."""
from __future__ import annotations

from typing import Tuple

import torch

from ..framework.dtype import as_tensor
from . import datasets  # noqa: F401
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       MovieInfo, UCIHousing, UserInfo, WMT14, WMT16)
from .tokenizer import WordPieceTokenizer  # noqa: F401

__all__ = ["WordPieceTokenizer",
           "viterbi_decode", "ViterbiDecoder", "datasets", "Imdb",
           "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "MovieInfo", "UserInfo", "WMT14", "WMT16"]


def viterbi_decode(potentials, transition, lengths=None,
                   include_bos_eos_tag: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRF Viterbi decoding, the JAX package's dynamic program.

    potentials: (B, T, N) emission scores; transition: (N, N) with
    transition[i, j] the score of i -> j; lengths: (B,) valid lengths
    (defaults to T).  With ``include_bos_eos_tag`` the last two tags are
    BOS / EOS: BOS starts every path, EOS ends it.  Ties go to the lowest
    tag, as ``jnp.argmax``'s.

    Returns (scores (B,) float32, paths (B, T) int32; positions past a
    sequence's length hold 0).
    """
    potentials = as_tensor(potentials, dtype=torch.float32)
    transition = as_tensor(transition, like=potentials,
                           dtype=torch.float32)
    b, t_len, n = potentials.shape
    dev = potentials.device
    if lengths is None:
        lengths = torch.full((b,), t_len, dtype=torch.int32, device=dev)
    lengths = as_tensor(lengths, like=potentials, dtype=torch.int32)
    if include_bos_eos_tag:
        bos, eos = n - 2, n - 1
        alpha = potentials[:, 0] + transition[bos][None, :]
    else:
        alpha = potentials[:, 0]
    bps = []
    for t in range(1, t_len):
        # scores[b, i, j] = alpha[b, i] + transition[i, j]
        scores = alpha[:, :, None] + transition[None, :, :]
        best_score, best_prev = scores.max(dim=1)
        live = (t < lengths)[:, None]
        alpha = torch.where(live, best_score + potentials[:, t], alpha)
        bps.append(torch.where(live, best_prev.to(torch.int32),
                               torch.full_like(best_prev, -1,
                                               dtype=torch.int32)))
    if include_bos_eos_tag:
        alpha = alpha + transition[:, eos][None, :]
    scores, tag = alpha.max(dim=-1)
    tag = tag.to(torch.int32)
    path = [tag]
    for bp in reversed(bps):
        prev = torch.gather(bp, 1, tag[:, None].long())[:, 0]
        # -1 marks a frozen step past the end: keep the tag
        tag = torch.where(prev >= 0, prev, tag)
        path.append(tag)
    paths = torch.stack(path[::-1], dim=1)
    mask = torch.arange(t_len, device=dev)[None, :] < lengths[:, None]
    return scores, torch.where(mask, paths, torch.zeros_like(paths))


class ViterbiDecoder:
    """Layer-style wrapper (reference paddle.text.ViterbiDecoder)."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True):
        self.transitions = as_tensor(transitions, dtype=torch.float32)
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
