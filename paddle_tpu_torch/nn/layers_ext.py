"""Beam-search decoding: the port of ``BeamSearchDecoder`` and
``dynamic_decode`` of ``paddle_tpu/nn/layers_ext.py:492-582`` (reference
``nn/decode.py``).  The rest of that JAX module is not ported yet
(``ROADMAP.md`` Queue 1 item 12a).

The cell contract is paddle's: ``cell(inputs, states) -> (out,
new_states)``, with ``states`` a tree (dicts, lists, tuples) of tensors
whose first dim is batch * beam; ``output_fn`` maps the cell's output to
vocabulary logits.  Ties between equal totals are broken as ``torch.topk``
breaks them."""
from __future__ import annotations

from typing import Optional

import torch

from ..framework.errors import enforce
from ..utils.tree import tree_map
from . import functional as F

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


class BeamSearchDecoder:
    """Beam search over a cell: each step extends every live beam by every
    token, keeps the ``beam_size`` best totals of each batch row, and
    reorders the cell's states by the parent beams.  A finished beam
    extends only by ``end_token``, at no cost."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token, self.end_token = start_token, end_token
        self.beam_size = beam_size
        self.embedding_fn, self.output_fn = embedding_fn, output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size: int):
        """(B, ...) -> (B * beam, ...), each row repeated ``beam_size``
        times."""
        return torch.repeat_interleave(torch.as_tensor(x), beam_size, dim=0)

    def initialize(self, initial_states, batch_size: int):
        """``(tokens, log_probs, finished, states)``: every beam starts at
        ``start_token``; beam 0 is live (log-prob 0) and the others at
        -1e9, so the first step expands one beam."""
        k = self.beam_size
        states = tree_map(lambda s: self.tile_beam_merge_with_batch(s, k),
                          initial_states)
        leaves = _leaves(states)
        dev = leaves[0].device if leaves else torch.device("cpu")
        tokens = torch.full((batch_size, k), self.start_token,
                            dtype=torch.int32, device=dev)
        log_probs = torch.tensor([0.0] + [-1e9] * (k - 1),
                                 dtype=torch.float32,
                                 device=dev)[None, :].repeat(batch_size, 1)
        finished = torch.zeros((batch_size, k), dtype=torch.bool, device=dev)
        return tokens, log_probs, finished, states

    def step(self, tokens, log_probs, finished, states):
        """One expansion: ``(tokens, log_probs, finished, states, parent)``
        of the kept beams, each (B, beam)."""
        b, k = tokens.shape
        inp = tokens.reshape(b * k)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        fin_mask = torch.full((v,), -1e9, device=logp.device)
        fin_mask[self.end_token] = 0.0
        logp = torch.where(finished[..., None], fin_mask, logp)
        total = log_probs[..., None] + logp
        top_val, top_idx = torch.topk(total.reshape(b, k * v), k, dim=-1)
        parent = (top_idx // v).to(torch.int32)
        token = (top_idx % v).to(torch.int32)

        def reorder(s):
            s = s.reshape(b, k, *s.shape[1:])
            idx = parent.long().reshape(b, k, *([1] * (s.dim() - 2)))
            s = s.gather(1, idx.expand(b, k, *s.shape[2:]))
            return s.reshape(b * k, *s.shape[2:])

        new_states = tree_map(reorder, new_states)
        new_fin = (finished.gather(1, parent.long())
                   | (token == self.end_token))
        return token, top_val, new_fin, new_states, parent


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 32, batch_size: Optional[int] = None,
                   **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps: ``(ids, log_probs)``, the token ids (B, beam, T) backtraced by
    :func:`functional.gather_tree` and the final totals (B, beam).  Each
    step reads back whether all beams have finished."""
    enforce(batch_size is not None or inits is not None,
            "dynamic_decode needs inits or batch_size")
    if batch_size is None:
        batch_size = _leaves(inits)[0].shape[0]
    tokens, log_probs, finished, states = decoder.initialize(inits,
                                                             batch_size)
    ids_steps, parent_steps = [], []
    for _ in range(max_step_num):
        tokens, log_probs, finished, states, parent = decoder.step(
            tokens, log_probs, finished, states)
        ids_steps.append(tokens)
        parent_steps.append(parent)
        if bool(finished.all()):
            break
    seqs = F.gather_tree(torch.stack(ids_steps), torch.stack(parent_steps))
    return seqs.permute(1, 2, 0), log_probs
