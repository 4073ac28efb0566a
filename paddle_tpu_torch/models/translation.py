"""The translation model of ``examples/seq2seq_translation.py`` on the port:
source and target ``Embedding``s, a learned position table, ``nn.Transformer``
and a ``Linear`` head over the target vocabulary, with the example's
batch collation and two beam-search cells.

    model = TranslationModel(vocab=30000, max_len=128)   # Transformer-base
    logits = model(src, tgt_in)                          # (B, T, vocab)

:meth:`TranslationModel.reencode_cell` is the example's cell: each step
runs the whole model on the source and the decoded prefix.
:meth:`TranslationModel.cached_cell` decodes on the incremental decoder
cache (``TransformerDecoder(cache=)``): the source is encoded once, and
each step runs the decoder on one token against the cached keys and
values.  Both follow the ``BeamSearchDecoder`` cell contract."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..nn.layer import Layer
from ..nn.layers import Embedding, Linear, Transformer

__all__ = ["TranslationModel", "collate"]

PAD_SRC, PAD_TGT_IN, PAD_TGT_NEXT = 2, 1, -100   # <unk>, </e>, ignored


def collate(batch: Sequence, length: int):
    """Pad a list of ``(src, tgt_in, tgt_next)`` items to ``length``:
    sources with ``<unk>`` (2), decoder inputs with ``</e>`` (1), labels
    with -100 (ignored by the loss).  Returns three int64 arrays."""
    src = np.full((len(batch), length), PAD_SRC, np.int64)
    tin = np.full((len(batch), length), PAD_TGT_IN, np.int64)
    tnx = np.full((len(batch), length), PAD_TGT_NEXT, np.int64)
    for i, (s, t, tn) in enumerate(batch):
        src[i, :len(s)] = s[:length]
        tin[i, :len(t)] = t[:length]
        tnx[i, :len(tn)] = tn[:length]
    return src, tin, tnx


class TranslationModel(Layer):
    """Embeddings plus a learned position table (``max_len`` rows) into
    ``nn.Transformer``, then the head; the decoder's self-attention takes
    the additive causal mask.  Parameter keys are the JAX example's
    (``src_emb``, ``tgt_emb``, ``pos``, ``core.encoder.layers.<i>...``,
    ``head``)."""

    def __init__(self, vocab: int, max_len: int, d_model: int = 512,
                 nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1,
                 device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab, self.max_len = vocab, max_len
        self.src_emb = Embedding(vocab, d_model, device=dev)
        self.tgt_emb = Embedding(vocab, d_model, device=dev)
        self.pos = Embedding(max_len, d_model, device=dev)
        self.core = Transformer(d_model, nhead, num_encoder_layers,
                                num_decoder_layers, dim_feedforward,
                                dropout, device=dev)
        self.head = Linear(d_model, vocab, device=dev)

    def _embed(self, emb, ids, start: int = 0):
        pos = torch.arange(start, start + ids.shape[1], device=ids.device)
        return emb(ids) + self.pos(pos)[None]

    def forward(self, src, tgt_in):
        mask = Transformer.generate_square_subsequent_mask(
            tgt_in.shape[1], device=tgt_in.device)
        out = self.core(self._embed(self.src_emb, src),
                        self._embed(self.tgt_emb, tgt_in), tgt_mask=mask)
        return self.head(out)

    def encode(self, src):
        """The encoder's memory of ``src``: (B, S, d_model)."""
        return self.core.encoder(self._embed(self.src_emb, src))

    def reencode_cell(self):
        """The example's cell: the state is ``{"src", "prefix"}``; each step
        appends the token to the prefix and runs the whole model."""
        def cell(tok, state):
            prefix = torch.cat([state["prefix"], tok[:, None].to(
                state["prefix"].dtype)], dim=1)
            logits = self(state["src"], prefix)
            return logits[:, -1], {"src": state["src"], "prefix": prefix}
        return cell

    def empty_cache(self, batch: int, like: torch.Tensor) -> List:
        """One empty ``(k, v)`` pair of (batch, heads, 0, head_dim) a
        decoder layer, in ``like``'s dtype and device."""
        attn = self.core.decoder.layers[0].self_attn
        shape = (batch, attn.num_heads, 0, attn.head_dim)
        return [(like.new_zeros(shape), like.new_zeros(shape))
                for _ in self.core.decoder.layers]

    def cached_cell(self):
        """A cell on the incremental decoder cache: the state is
        ``{"memory", "cache"}`` (the encoder's memory and one ``(k, v)``
        a decoder layer, the keys and values of the tokens so far); each
        step embeds the token at the next position and runs the decoder on
        it alone."""
        def cell(tok, state):
            t = state["cache"][0][0].shape[2]
            x = self._embed(self.tgt_emb, tok[:, None].long(), start=t)
            out, cache = self.core.decoder(x, state["memory"],
                                           cache=state["cache"])
            return (self.head(out[:, -1]),
                    {"memory": state["memory"], "cache": cache})
        return cell
