"""Fused transformer epilogues, rotary embedding and the memory-efficient
LM loss: the port of ``paddle_tpu/ops/fused.py``.

The epilogues (:func:`fused_bias_dropout_residual_layer_norm`,
:func:`fused_bias_dropout_residual`), :func:`fused_feedforward` and
:func:`rotary_position_embedding` are compositions in the JAX package too,
which XLA fuses on a TPU; here they are the same compositions in plain
PyTorch, op for op (the JAX module keeps them as named ops for API parity).
Dropout draws from the device's stream of ``framework/random.py``.

:func:`linear_softmax_cross_entropy` is the loss of ``softmax(hidden @
table.T)`` against ``labels`` without the full (B, S, V) logits: forward
loops over sequence chunks and keeps only the per-token logsumexp;
backward recomputes each chunk's logits and fuses the softmax gradient
into the dW and dh products (:class:`_LinearCE`, the counterpart of the
JAX ``custom_vjp`` ``_linear_ce``).  The products are plain large matrix
products, which the JAX package leaves to XLA; here they go to
``torch.matmul`` / ``torch.mm``.

As in the JAX op, every product returns float32 from operands of the
input dtype (``preferred_element_type=float32``): the logits reach the
logsumexp unrounded.  Float32 operands multiply in float32.  For bfloat16
operands on the card, ``torch.mm(..., out_dtype=torch.float32)`` runs the
bf16 product with float32 results where this torch has it; elsewhere the
operands are widened to float32 first, which gives the same exact products
at the float32 rate.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributed.mp_ops import masked_token_reduce, parallel_cross_entropy
from ..nn import functional as F

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "fused_bias_dropout_residual", "fused_feedforward",
           "rotary_position_embedding", "linear_softmax_cross_entropy"]


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate: float = 0.0, epsilon: float = 1e-5,
        training: bool = True):
    """``LayerNorm(residual + dropout(x + bias))``."""
    y = fused_bias_dropout_residual(x, residual, bias, dropout_rate,
                                    training)
    return F.layer_norm(y, (y.shape[-1],), ln_scale, ln_bias, epsilon)


def fused_bias_dropout_residual(x, residual, bias=None,
                                dropout_rate: float = 0.0,
                                training: bool = True):
    """``residual + dropout(x + bias)``; the bias takes x's dtype."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    if dropout_rate > 0.0 and training:
        x = F.dropout(x, dropout_rate, training=True)
    dt = torch.promote_types(residual.dtype, x.dtype)
    return residual.to(dt) + x.to(dt)


def fused_feedforward(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None,
                      activation: str = "gelu", dropout1: float = 0.0,
                      dropout2: float = 0.0, epsilon: float = 1e-5,
                      pre_layer_norm: bool = True, training: bool = True):
    """The FFN block: [pre-LN] -> ``x @ w1 + b1`` -> act -> dropout1 ->
    ``@ w2`` -> + b2, dropout2, + x -> [post-LN].  ``activation`` is
    ``"gelu"`` (exact) or ``"relu"``."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, (x.shape[-1],), ln_scale, ln_bias, epsilon)
    act = {"gelu": F.gelu, "relu": F.relu}[activation]
    h = act(F.linear(x, w1, b1))
    if dropout1 > 0.0 and training:
        h = F.dropout(h, dropout1, training=True)
    out = F.linear(h, w2, None)
    out = fused_bias_dropout_residual(out, residual, b2, dropout2, training)
    if not pre_layer_norm:
        out = F.layer_norm(out, (out.shape[-1],), ln_scale, ln_bias, epsilon)
    return out


def _inv_freq(head_dim: int, base: float, device=None) -> torch.Tensor:
    """``1 / base ** (arange(0, d, 2) / d)`` in float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (base ** exps)


@functools.lru_cache(maxsize=64)
def _rope_tables(seq_len: int, head_dim: int, base: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 cos / sin tables, (seq_len, head_dim / 2) each, on the
    host: computed once per ``(seq_len, head_dim, base)``."""
    angles = (torch.arange(seq_len, dtype=torch.float32)[:, None]
              * _inv_freq(head_dim, base))
    return torch.cos(angles), torch.sin(angles)


@functools.lru_cache(maxsize=64)
def _rope_tables_on(seq_len: int, head_dim: int, base: float,
                    device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_rope_tables` copied to ``device`` once."""
    cos, sin = _rope_tables(seq_len, head_dim, base)
    return cos.to(device), sin.to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """GPT-NeoX rotation of the two halves of the last dim, in float32,
    returned in x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rotary_position_embedding(q, k, position_ids=None,
                              base: float = 10000.0):
    """GPT-NeoX rotary embedding of (batch, heads, seq, head_dim) q and k.
    The positions are ``arange(seq)`` by default, or ``position_ids``
    ((batch | 1, seq)): host values (numpy, lists) index the cached tables;
    a tensor computes the angles on its own device."""
    b, h, s, d = q.shape
    if position_ids is None:
        cos, sin = _rope_tables_on(s, d, float(base), q.device)
        cos, sin = cos[None, None], sin[None, None]
    elif not torch.is_tensor(position_ids):
        pos = np.asarray(position_ids)
        cos, sin = _rope_tables_on(int(pos.max()) + 1, d, float(base),
                                   q.device)
        idx = torch.from_numpy(pos.astype(np.int64)).to(q.device)
        cos, sin = cos[idx][:, None], sin[idx][:, None]
    else:
        angles = (position_ids.to(q.device).float()[..., None]
                  * _inv_freq(d, float(base), q.device))
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    return _rotate(q, cos, sin), _rotate(k, cos, sin)

# aten::mm.dtype: the bf16 x bf16 -> float32 product, on CUDA only
_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def _lce_chunk(s: int, batch: int = 1, vocab: int = 0) -> Optional[int]:
    """Largest sequence chunk (a multiple of 128) dividing ``s`` whose
    float32 logits block (batch, chunk, vocab) stays under ~1.6 GB; the
    smallest such chunk when none does; None when no multiple of 128
    divides ``s`` (the caller falls back to the unfused loss)."""
    budget = 1.6e9
    best = None
    for c in (512, 256, 128):
        if s % c == 0:
            best = best or c
            if batch * c * vocab * 4 <= budget:
                return c
    return 128 if best else None


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, returned in float32 with
    float32 accumulation."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda and _MM_OUT_DTYPE:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(hidden, table, c0: int, chunk: int):
    h = hidden.shape[-1]
    hc = hidden[:, c0:c0 + chunk].reshape(-1, h)
    return hc, _f32_product(hc, table.t())


class _LinearCE(torch.autograd.Function):
    """Per-token losses ``lse - logit[label]`` (B, S) float32."""

    @staticmethod
    def forward(ctx, hidden, table, labels, chunk: int):
        b, s, _ = hidden.shape
        vocab = table.shape[0]
        loss = torch.empty((b, s), dtype=torch.float32, device=hidden.device)
        lse = torch.empty_like(loss)
        for c0 in range(0, s, chunk):
            _, logits = _chunk_logits(hidden, table, c0, chunk)
            lse_c = torch.logsumexp(logits, dim=-1)
            lab = labels[:, c0:c0 + chunk].reshape(-1).long()
            picked = logits.gather(1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
            lse[:, c0:c0 + chunk] = lse_c.view(b, chunk)
            loss[:, c0:c0 + chunk] = (lse_c - picked).view(b, chunk)
        ctx.save_for_backward(hidden, table, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, table, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h = hidden.shape
        vocab = table.shape[0]
        dh = torch.empty_like(hidden)
        dw = torch.zeros(table.shape, dtype=torch.float32,
                         device=table.device)
        for c0 in range(0, s, chunk):
            hc, logits = _chunk_logits(hidden, table, c0, chunk)
            p = torch.exp(logits - lse[:, c0:c0 + chunk].reshape(-1, 1))
            lab = labels[:, c0:c0 + chunk].reshape(-1).long()
            # p - onehot(label): an ignored or out-of-range label has no
            # one-hot column
            hit = (lab >= 0) & (lab < vocab)
            rows = torch.arange(lab.numel(), device=lab.device)[hit]
            p[rows, lab[hit]] -= 1.0
            grad = (p * g[:, c0:c0 + chunk].reshape(-1, 1)).to(table.dtype)
            dh[:, c0:c0 + chunk] = _f32_product(grad, table).view(
                b, chunk, h).to(hidden.dtype)
            dw += _f32_product(grad.t(), hc)
        return dh, dw.to(table.dtype), None, None


def linear_softmax_cross_entropy(hidden, table, labels, *,
                                 ignore_index: int = -100,
                                 reduction: str = "mean",
                                 seq_chunk: Optional[int] = None):
    """Cross-entropy of ``softmax(hidden @ table.T)`` against ``labels``
    without materialising the full logits.

    hidden: (b, s, h); table: (v, h), e.g. a tied embedding; labels: (b, s)
    integer ids, ``ignore_index`` masked out.  Falls back to the unfused
    loss (full logits, :func:`parallel_cross_entropy`) when no multiple of
    128 divides the sequence."""
    b, s, _ = hidden.shape
    dt = torch.promote_types(hidden.dtype, table.dtype)
    hidden, table = hidden.to(dt), table.to(dt)
    chunk = (seq_chunk if seq_chunk is not None
             else _lce_chunk(s, b, table.shape[0]))
    if chunk is None or s % chunk != 0:
        logits = torch.matmul(hidden, table.t())
        return parallel_cross_entropy(logits.float(), labels,
                                      ignore_index=ignore_index,
                                      reduction=reduction)
    loss = _LinearCE.apply(hidden, table, labels.to(torch.int32), chunk)
    return masked_token_reduce(loss, labels != ignore_index, reduction)
