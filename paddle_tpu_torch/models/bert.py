"""BERT encoder family: the port of ``paddle_tpu/models/bert.py`` (BERT-base
pretraining, MLM + NSP, and sequence classification).

Same module tree, parameter names and (in, out) weight layout as the JAX
package, so ``state_dict`` keys carry over (``convert.py``).  Post-LN
blocks: ``LN(x + attn(x))`` then ``LN(x + fc_out(gelu(fc_in(x))))``.

Attention routes as the JAX layer does: with ``use_pallas_attention``, no
attention mask and no attention dropout in training, the non-causal flash
attention (``ops/flash_attention.py``: the flash kernels on the card, their
plain versions on the CPU); otherwise the plain
``nn.functional.scaled_dot_product_attention`` with the additive mask
``(1 - mask) * -1e9``, built in the activation dtype (in bfloat16 the
constant rounds to -998244352, as ``jnp.asarray(-1e9, bfloat16)``).

The MLM logits are a plain product with the tied word embedding (the JAX
package computes them outside any kernel too); the MLM loss is the
float32 cross-entropy over positions whose label is not -100, divided by
their count (floor 1), plus the NSP cross-entropy when NSP labels are
given.  Dtypes follow the JAX package: parameters float32; with
``dtype="bfloat16"`` the embeddings' output is cast to bfloat16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..distributed.mp_ops import parallel_cross_entropy
from ..framework.errors import enforce
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..ops.flash_attention import flash_attention

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "BertEmbeddings",
           "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base",
           "bert_large"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30528          # padded to a multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    use_pallas_attention: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        enforce(self.hidden_size % self.num_heads == 0,
                "num_heads must evenly divide hidden_size")
        enforce(self.dtype in _DTYPES, f"unsupported dtype {self.dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class BertSelfAttention(nn.Module):
    """Bidirectional self-attention; qkv is one (h, 3h) GEMM in head-major
    column order (head0: q|k|v, head1: q|k|v, ...)."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        std = c.initializer_range
        self.qkv_proj = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                             std=std, device=device)
        self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                          std=std, device=device)
        self.attn_dropout_p = c.attention_dropout

    def forward(self, x, attn_mask=None):
        c = self.config
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, c.num_heads, 3, c.head_dim)
        q = qkv[:, :, :, 0].transpose(1, 2)           # (b, heads, s, d)
        k = qkv[:, :, :, 1].transpose(1, 2)
        v = qkv[:, :, :, 2].transpose(1, 2)
        if (c.use_pallas_attention and attn_mask is None
                and not (self.attn_dropout_p > 0 and self.training)):
            out = flash_attention(q, k, v, causal=False, dropout_p=0.0,
                                  training=self.training)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=False,
                dropout_p=self.attn_dropout_p, training=self.training)
        out = out.transpose(1, 2).reshape(b, s, c.hidden_size)
        return self.out_proj(out)


class BertLayer(nn.Module):
    """Post-LN encoder block: attention -> dropout + residual + LN -> FFN
    -> dropout + residual + LN."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        std = c.initializer_range
        self.attn = BertSelfAttention(c, device=device)
        self.attn_dropout = Dropout(c.hidden_dropout)
        self.attn_ln = LayerNorm(c.hidden_size, epsilon=c.layer_norm_epsilon,
                                 device=device)
        self.fc_in = ColumnParallelLinear(c.hidden_size, c.intermediate_size,
                                          std=std, device=device)
        self.fc_out = RowParallelLinear(c.intermediate_size, c.hidden_size,
                                        std=std, device=device)
        self.ffn_dropout = Dropout(c.hidden_dropout)
        self.ffn_ln = LayerNorm(c.hidden_size, epsilon=c.layer_norm_epsilon,
                                device=device)

    def forward(self, x, attn_mask=None):
        h = self.attn(x, attn_mask=attn_mask)
        x = self.attn_ln(x + self.attn_dropout(h))
        h = self.fc_out(F.gelu(self.fc_in(x)))
        return self.ffn_ln(x + self.ffn_dropout(h))


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        std = c.initializer_range
        self.word_embeddings = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, std=std, device=device)
        self.position_embeddings = Embedding(
            c.max_position_embeddings, c.hidden_size, std=std, device=device)
        self.token_type_embeddings = Embedding(
            c.type_vocab_size, c.hidden_size, std=std, device=device)
        self.layer_norm = LayerNorm(c.hidden_size,
                                    epsilon=c.layer_norm_epsilon,
                                    device=device)
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Module):
    """Encoder backbone with the tanh pooler over the first ([CLS])
    position.  Returns ``(hidden (b, s, h), pooled (b, h))``."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.embeddings = BertEmbeddings(c, device=device)
        self.encoder = nn.ModuleList([BertLayer(c, device=device)
                                      for _ in range(c.num_layers)])
        self.pooler = Linear(c.hidden_size, c.hidden_size,
                             std=c.initializer_range, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        c = self.config
        x = self.embeddings(input_ids, token_type_ids)
        if c.dtype != "float32":
            x = x.to(c.torch_dtype)
        mask = None
        if attention_mask is not None:
            # (b, s) {0, 1} -> additive (b, 1, 1, s) in x's dtype
            keep = attention_mask[:, None, None, :].to(x.dtype)
            mask = (1.0 - keep) * torch.tensor(-1e9, dtype=x.dtype,
                                               device=x.device)
        for layer in self.encoder:
            x = layer(x, attn_mask=mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP pretraining heads; the MLM logits are tied to the word
    embedding, plus ``mlm_bias``.  Parameters are made on ``device``
    (``cuda`` when none is given; the CPU only when asked)."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.device = resolve_device(device)
        dev = self.device
        self.bert = BertModel(c, device=dev)
        std = c.initializer_range
        self.transform = Linear(c.hidden_size, c.hidden_size, std=std,
                                device=dev)
        self.transform_ln = LayerNorm(c.hidden_size,
                                      epsilon=c.layer_norm_epsilon,
                                      device=dev)
        self.mlm_bias = nn.Parameter(torch.zeros(c.vocab_size, device=dev))
        self.nsp = Linear(c.hidden_size, 2, std=std, device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mlm_labels=None, nsp_labels=None):
        """``(mlm_logits (b, s, vocab), nsp_logits (b, 2))`` without
        ``mlm_labels``, else ``(loss, mlm_logits)``."""
        hidden, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(F.gelu(self.transform(hidden)))
        table = self.bert.embeddings.word_embeddings.weight.to(h.dtype)
        logits = torch.matmul(h, table.t()) + self.mlm_bias.to(h.dtype)
        nsp_logits = self.nsp(pooled)
        if mlm_labels is None:
            return logits, nsp_logits
        valid = mlm_labels != -100
        safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
        per_tok = parallel_cross_entropy(logits.float(), safe,
                                         reduction="none")
        denom = valid.sum().clamp_min(1)
        loss = (per_tok * valid).sum() / denom
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits.float(),
                                          nsp_labels).mean()
        return loss, logits


class BertForSequenceClassification(nn.Module):
    """The pooled output -> dropout -> a linear classifier; with
    ``labels`` the mean float32 cross-entropy and the logits."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.bert = BertModel(config, device=self.device)
        self.dropout = Dropout(config.hidden_dropout)
        # the JAX Linear's defaults: XavierUniform weight, zero bias
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=self.device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.float(), labels).mean()
        return loss, logits


# -- standard configs (the JAX package's table) ------------------------------
def _cfg(defaults: Dict[str, Any], kw: Dict[str, Any]) -> BertConfig:
    return BertConfig(**{**defaults, **kw})


def bert_tiny(**kw) -> BertConfig:
    return _cfg(dict(hidden_size=128, num_layers=2, num_heads=4,
                     vocab_size=1024, max_position_embeddings=128), kw)


def bert_base(**kw) -> BertConfig:
    return _cfg(dict(hidden_size=768, num_layers=12, num_heads=12), kw)


def bert_large(**kw) -> BertConfig:
    return _cfg(dict(hidden_size=1024, num_layers=24, num_heads=16), kw)
