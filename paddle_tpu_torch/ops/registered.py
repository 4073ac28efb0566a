"""The kernels of a full-sequence forward as registered ``torch.library``
ops, for ``torch.export`` (``jit.save``).

An exported program keeps what it traced: a Python branch on the device
or the row count would be frozen at export time.  So the four kernels a
GPT forward launches are exported as opaque ops whose bodies choose at
run time, as the eager wrappers do:

- ``ptpu::ln_linear`` — K1, ``LN(x) @ w + b`` (``fused_block.ln_linear_cuda``
  picks the stream, tiled, tensor-core or SIMT kernel from ``w`` and the
  rows it is given);
- ``ptpu::linear_residual`` — K2, ``r + dropout(x @ w + b)``;
- ``ptpu::ffn`` — K3, the FFN half of a pre-LN block;
- ``ptpu::flash_fwd`` — the flash forward over ``(batch * heads, seq,
  head_dim)``, its output only.

On CUDA tensors each body launches the port's kernel (a missing library
raises); on CPU tensors it runs the plain version.  So a program exported
on the CPU launches the kernels when it is loaded on the card, and a
dynamic batch picks its kernel per call.  Each op has a fake (meta)
implementation for tracing.  The call sites (``fused_block._route``,
``flash_attention``, ``fused_attention_block``) emit these ops only while
``torch.compiler.is_exporting()``; eager calls are unchanged.  A process
that loads an exported program imports this module first
(``jit.load`` does), so the ops are registered before the program is.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_fwd_cuda, flash_fwd_reference
from .fused_block import (ffn_cuda, ffn_reference, linear_residual_cuda,
                          linear_residual_reference, ln_linear_cuda,
                          ln_linear_reference)

__all__ = ["ln_linear", "linear_residual", "ffn", "flash_fwd", "EXPORTED",
           "OPS"]


@torch.library.custom_op("ptpu::ln_linear", mutates_args=())
def ln_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              g: torch.Tensor, beta: torch.Tensor,
              epsilon: float) -> torch.Tensor:
    if x.is_cuda:
        return ln_linear_cuda(x.contiguous(), w.contiguous(), b, g, beta,
                              epsilon)
    return ln_linear_reference(x, w, b, g, beta, epsilon)


@ln_linear.register_fake
def _(x, w, b, g, beta, epsilon):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=w.dtype)


@torch.library.custom_op("ptpu::linear_residual", mutates_args=())
def linear_residual(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    r: torch.Tensor, seed: int, dropout_p: float,
                    salt: int) -> torch.Tensor:
    if x.is_cuda:
        return linear_residual_cuda(x.contiguous(), w.contiguous(), b,
                                    r.contiguous(), seed, dropout_p, salt)
    return linear_residual_reference(x, w, b, r, seed, dropout_p, salt)


@linear_residual.register_fake
def _(x, w, b, r, seed, dropout_p, salt):
    return torch.empty_like(r)


@torch.library.custom_op("ptpu::ffn", mutates_args=())
def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor, seed: int, activation: str, dropout1: float,
        dropout2: float, epsilon: float) -> torch.Tensor:
    args = (seed, activation, dropout1, dropout2, epsilon)
    if x.is_cuda:
        return ffn_cuda(x.contiguous(), w1.contiguous(), b1, w2.contiguous(),
                        b2, g, beta, *args)
    return ffn_reference(x, w1, b1, w2, b2, g, beta, *args)


@ffn.register_fake
def _(x, w1, b1, w2, b2, g, beta, seed, activation, dropout1, dropout2,
      epsilon):
    return torch.empty_like(x)


@torch.library.custom_op("ptpu::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
              scale: float, causal: bool, dropout_p: float) -> torch.Tensor:
    fwd = flash_fwd_cuda if q.is_cuda else flash_fwd_reference
    return fwd(q.contiguous(), k.contiguous(), v.contiguous(), seed, scale,
               causal, dropout_p)[0]


@flash_fwd.register_fake
def _(q, k, v, seed, scale, causal, dropout_p):
    return torch.empty_like(q)


# the op ``fused_block._route`` emits for each card entry point
EXPORTED = {ln_linear_cuda: ln_linear, linear_residual_cuda: linear_residual,
            ffn_cuda: ffn}
# the ops' qualified names, as they appear in an exported graph
OPS = ("ptpu::ln_linear", "ptpu::linear_residual", "ptpu::ffn",
       "ptpu::flash_fwd")
