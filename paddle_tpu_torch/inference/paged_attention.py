"""Ragged paged-attention decode: the port of ``paddle_tpu/inference/
paged_attention.py``.

For a batch of single-token queries ``q`` of shape ``(batch, heads,
head_dim)`` it computes

    out[b] = softmax(q[b] · K[b]^T * scale) · V[b]

where ``K[b] / V[b]`` are gathered from the ``(num_slots + 1, heads,
head_dim)`` page arrays through ``block_tables[b]`` and cut at
``seq_lens[b]``; a row with ``seq_lens[b] == 0`` returns zeros.

- :func:`paged_attention_cuda` — the kernel (``csrc/paged_decode.cu``);
- :func:`paged_attention_reference` — gather + masked softmax in float32,
  the CPU path and the oracle the kernel is held against;
- :func:`paged_attention` — routes by the tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _kernels
from ..framework.errors import enforce

__all__ = ["paged_attention", "paged_attention_cuda",
           "paged_attention_reference"]

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256            # csrc/paged_decode.cu kMaxHeadDim


def _check_shapes(q, k_pages, v_pages, block_tables, seq_lens,
                  block_size: int):
    b, h, d = q.shape
    enforce(k_pages.dim() == 3 and k_pages.shape == v_pages.shape,
            f"page shape mismatch: k={tuple(k_pages.shape)} "
            f"v={tuple(v_pages.shape)}")
    enforce(k_pages.shape[1] == h and k_pages.shape[2] == d,
            f"pages {tuple(k_pages.shape)} disagree with q {tuple(q.shape)}")
    enforce(block_tables.dim() == 2 and block_tables.shape[0] == b
            and tuple(seq_lens.shape) == (b,),
            f"tables {tuple(block_tables.shape)} / lens "
            f"{tuple(seq_lens.shape)} disagree with batch {b}")
    num_slots = k_pages.shape[0] - 1    # trailing sentinel row
    enforce(num_slots % block_size == 0,
            f"{num_slots} slots not a multiple of block_size {block_size}")


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              block_size: int,
                              scale: Optional[float] = None):
    """Plain PyTorch ragged paged attention in float32."""
    _check_shapes(q, k_pages, v_pages, block_tables, seq_lens, block_size)
    b, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    max_ctx = block_tables.shape[1] * block_size
    offs = torch.arange(block_size, device=q.device)
    # (b, T) block ids -> (b, T*bs) flat slots -> gathered (b, L, h, d)
    slots = (block_tables.long()[:, :, None] * block_size
             + offs[None, None, :]).reshape(b, -1)
    k = k_pages[slots].float()
    v = v_pages[slots].float()
    s = torch.einsum("bhd,blhd->bhl", q.float(), k) * scale
    valid = (torch.arange(max_ctx, device=q.device)[None, :]
             < seq_lens.long()[:, None])[:, None, :]        # (b, 1, L)
    s = torch.where(valid, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhl,blhd->bhd", p, v)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def paged_attention_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                         block_size: int, scale: Optional[float] = None):
    """The paged-decode kernel: one warp per (row, head) walks the row's
    block table up to ``seq_lens[b]``.  Returns ``q``'s dtype."""
    name = "paged_decode"
    _check_shapes(q, k_pages, v_pages, block_tables, seq_lens, block_size)
    dev = _kernels.require_cuda(name, q, k_pages, v_pages, block_tables,
                                seq_lens)
    enforce(block_tables.dtype == torch.int32
            and seq_lens.dtype == torch.int32,
            f"{name}: block tables and lengths must be int32")
    enforce(k_pages.dtype == v_pages.dtype,
            f"{name}: k and v pages differ in dtype")
    b, h, d = q.shape
    enforce(d <= _MAX_HEAD_DIM, f"{name}: head_dim {d} > {_MAX_HEAD_DIM}")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    c, p = ctypes.c_int, ctypes.c_void_p
    fn = _kernels.bind(name, "ptt_paged_decode",
                       [p, c, p, p, c, p, p, p, c, c, c, c, c,
                        ctypes.c_float, p])
    pt, cd = _kernels.ptr, _kernels.dtype_code
    rc = fn(pt(q), cd(q), pt(k_pages), pt(v_pages), cd(k_pages),
            pt(block_tables), pt(seq_lens), pt(out), b, h, d,
            block_tables.shape[1], int(block_size), float(scale),
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    block_size: int, scale: Optional[float] = None):
    """Ragged paged-attention decode for ``q`` of shape ``(batch, heads,
    head_dim)``: the kernel for a CUDA tensor, the plain version for a CPU
    one."""
    if q.is_cuda:
        return paged_attention_cuda(q.contiguous(), k_pages, v_pages,
                                    block_tables, seq_lens, block_size,
                                    scale)
    return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     seq_lens, block_size, scale)
