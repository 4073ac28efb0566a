"""Flash attention: the port of ``paddle_tpu/ops/flash_attention.py``
(``flash_attention`` and its recompute backward; the fixed-cache decode
kernel comes with the ``generate`` slice).

Three kernels, each CUDA C++ for Hopper beside its plain PyTorch version:

  [flash_fwd]   out, lse = attention(q, k, v)        csrc/flash_fwd.cu
  [flash_dkdv]  dK, dV of the recompute backward     csrc/flash_dkdv.cu
  [flash_dq]    dQ of the recompute backward         csrc/flash_dq.cu

They work on (batch*heads, seq, head_dim) tensors.  :class:`_FlashCore`,
a ``torch.autograd.Function``, is the counterpart of the JAX package's
``custom_vjp`` ``_flash_attention_core``: forward saves ``(q, k, v, seed,
out, lse)``; backward computes ``delta = rowsum(dO * out)`` in float32 and
runs dK/dV and dQ, which replay ``p = exp(s - lse)`` instead of keeping a
probability tensor.  Routing is by the tensor's device: a CPU tensor takes
the plain versions, a CUDA tensor launches the kernels or raises.

Semantics follow the JAX package: causal masking is aligned bottom-right
(``offset = kv_len - q_len``), masked scores are -1e30, ``l`` is clamped at
1e-30, and attention dropout is the in-kernel counter hash
(:func:`_keep_mask`, bit-identical to JAX's) applied to the P.V product only:
``l`` and ``lse`` stay dropout-free and the output is divided by
``l * (1 - p)``.  Any length is taken (the kernels mask ragged edges; the
JAX wrapper pads instead).  A query row that sees no key at all (causal with
``q_len > kv_len``) gives zeros and no gradient; the JAX kernel's result for
such rows depends on its block sizes.

The plain versions round where the TPU kernels round: products of the input
dtype summed in float32, ``p`` rounded to v's dtype before P.V, and in
backward ``pd`` rounded to dO's dtype for dV and ``ds`` to q's / k's dtype
for dK / dQ.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _kernels
from ..framework import random as fw_random
from ..framework.errors import enforce

__all__ = ["flash_attention", "flash_fwd_reference", "flash_fwd_cuda",
           "flash_dkdv_reference", "flash_dkdv_cuda", "flash_dq_reference",
           "flash_dq_cuda"]

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)        # the csrc/flash_*.cu instantiations
_MAX_GRID_Y = 65535                   # batch*heads ride the grid's y axis
_M32 = 0xFFFFFFFF

_c = ctypes.c_int
_f = ctypes.c_float
_p = ctypes.c_void_p


# ---------------------------------------------------------------------------
# Counter-hash dropout (paddle_tpu/ops/flash_attention.py _keep_mask), in
# int64 holding uint32 values
# ---------------------------------------------------------------------------
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for uint32 values held in int64, split in
    16-bit halves of ``c`` so no product leaves the int64 range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _keep_mask(seed, salt, rows, cols, dropout_p: float) -> torch.Tensor:
    """keep(seed, salt, row, col) — bit-identical to the JAX hash: a
    murmur3-fmix of the four counters whose top 24 bits become a uniform in
    [0, 1).  ``rows`` / ``cols`` / ``salt`` broadcast; ``seed`` is an int32
    (wrapped to uint32 as JAX's astype does).  Flash attention salts with
    the flattened batch*head index; the fused-block epilogues with their
    own constants."""
    as64 = lambda v: torch.as_tensor(v, dtype=torch.int64) & _M32  # noqa: E731
    x = (_mul32(as64(rows), 0x85EBCA6B) ^ _mul32(as64(cols), 0xC2B2AE35)
         ^ as64(seed) ^ _mul32(as64(salt), 0x9E3779B1))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))
    return u >= dropout_p


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _check(q, k, v, name: str) -> None:
    enforce(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
            f"{name}: q, k, v must be (batch*heads, seq, head_dim)")
    bh, sq, d = q.shape
    enforce(k.shape == v.shape and k.shape[0] == bh and k.shape[2] == d,
            f"{name}: k/v shape mismatch: q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}")
    enforce(sq > 0 and k.shape[1] > 0, f"{name}: empty sequence")


def _visible(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    """(sq, sk) mask of the keys each query row sees (bottom-right causal
    alignment)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    if causal:
        return rows + (sk - sq) >= cols
    return torch.ones((sq, sk), dtype=torch.bool, device=device)


def _keep(seed: int, bh: int, sq: int, sk: int, dropout_p: float,
          device) -> torch.Tensor:
    """(bh, sq, sk) keep mask over the flattened batch*head index and the
    global row and column."""
    idx = torch.arange(max(bh, sq, sk), device=device)
    return _keep_mask(seed, idx[:bh, None, None], idx[None, :sq, None],
                      idx[None, None, :sk], dropout_p)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The value a store to ``dtype`` and a load back give, in float32."""
    return x.to(dtype).float()


def flash_fwd_reference(q, k, v, seed: int = 0, scale: Optional[float] = None,
                        causal: bool = True, dropout_p: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for q (BH, sq, d), k / v (BH, sk, d): out in q's
    dtype, lse (BH, sq) float32."""
    _check(q, k, v, "flash_fwd_reference")
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    vis = _visible(sq, sk, causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    s = torch.where(vis, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros((), device=q.device))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_p > 0.0:
        p = torch.where(_keep(seed, bh, sq, sk, dropout_p, q.device), p,
                        torch.zeros((), device=q.device))
    acc = torch.matmul(_round(p, v.dtype), v.float())
    out = (acc / (l_safe * (1.0 - dropout_p))).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def _recompute(q, k, v, do, lse, delta, seed, scale, causal, dropout_p):
    """(pd, ds) of the recompute backward, float32 (BH, sq, sk)."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    vis = _visible(sq, sk, causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    pd = p
    if dropout_p > 0.0:
        keep_scale = 1.0 / (1.0 - dropout_p)
        pd = torch.where(_keep(seed, bh, sq, sk, dropout_p, q.device),
                         p * keep_scale, torch.zeros((), device=q.device))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (pd * dp - p * delta[..., None]) * scale
    return pd, ds


def flash_dkdv_reference(q, k, v, do, lse, delta, seed: int = 0,
                         scale: Optional[float] = None, causal: bool = True,
                         dropout_p: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in k's / v's dtype, from the saved ``lse`` and
    ``delta = rowsum(do * out)`` (both (BH, sq) float32)."""
    _check(q, k, v, "flash_dkdv_reference")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    pd, ds = _recompute(q, k, v, do, lse, delta, seed, scale, causal,
                        dropout_p)
    dv = torch.matmul(_round(pd, do.dtype).transpose(1, 2), do.float())
    dk = torch.matmul(_round(ds, q.dtype).transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_reference(q, k, v, do, lse, delta, seed: int = 0,
                       scale: Optional[float] = None, causal: bool = True,
                       dropout_p: float = 0.0) -> torch.Tensor:
    """``dq`` in q's dtype."""
    _check(q, k, v, "flash_dq_reference")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, ds = _recompute(q, k, v, do, lse, delta, seed, scale, causal,
                       dropout_p)
    return torch.matmul(_round(ds, k.dtype), k.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
def _check_cuda(name: str, q, k, v, *rest) -> torch.device:
    _check(q, k, v, name)
    dev = _kernels.require_cuda(name, q, k, v, *rest)
    enforce(q.dtype == k.dtype == v.dtype,
            f"{name}: q, k, v differ in dtype ({q.dtype}, {k.dtype}, "
            f"{v.dtype})")
    enforce(q.shape[-1] in _HEAD_DIMS,
            f"{name}: head_dim {q.shape[-1]} is not one of {_HEAD_DIMS}")
    enforce(q.shape[0] <= _MAX_GRID_Y,
            f"{name}: batch*heads {q.shape[0]} > {_MAX_GRID_Y}")
    return dev


def _dropout_args(seed: int, dropout_p: float):
    """(dropout_p, seed as uint32) for the C entry points."""
    return float(dropout_p), ctypes.c_uint(int(seed) & _M32)


def flash_fwd_cuda(q, k, v, seed: int = 0, scale: Optional[float] = None,
                   causal: bool = True, dropout_p: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(out, lse)`` as :func:`flash_fwd_reference`."""
    name = "flash_fwd"
    dev = _check_cuda(name, q, k, v)
    bh, sq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    fn = _kernels.bind(name, "ptt_flash_fwd",
                       [_p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _f, _c, _f,
                        _f, ctypes.c_uint, _p])
    p, seed_u32 = _dropout_args(seed, dropout_p)
    pt = _kernels.ptr
    rc = fn(pt(q), pt(k), pt(v), pt(out), pt(lse), _kernels.dtype_code(q),
            bh, sq, k.shape[1], d, float(scale), int(bool(causal)), p,
            1.0 - p, seed_u32, _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out, lse


def flash_dkdv_cuda(q, k, v, do, lse, delta, seed: int = 0,
                    scale: Optional[float] = None, causal: bool = True,
                    dropout_p: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: ``(dk, dv)`` as :func:`flash_dkdv_reference`."""
    name = "flash_dkdv"
    dev = _check_cuda(name, q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    _check_stats(name, q, do, lse, delta)
    scale = d ** -0.5 if scale is None else scale
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _kernels.bind(name, "ptt_flash_dkdv",
                       [_p, _p, _p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c,
                        _f, _c, _f, _f, ctypes.c_uint, _p])
    p, seed_u32 = _dropout_args(seed, dropout_p)
    pt = _kernels.ptr
    rc = fn(pt(q), pt(k), pt(v), pt(do), pt(lse), pt(delta), pt(dk), pt(dv),
            _kernels.dtype_code(q), bh, sq, k.shape[1], d, float(scale),
            int(bool(causal)), p, 1.0 / (1.0 - p), seed_u32,
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return dk, dv


def flash_dq_cuda(q, k, v, do, lse, delta, seed: int = 0,
                  scale: Optional[float] = None, causal: bool = True,
                  dropout_p: float = 0.0) -> torch.Tensor:
    """The dQ kernel: ``dq`` as :func:`flash_dq_reference`."""
    name = "flash_dq"
    dev = _check_cuda(name, q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    _check_stats(name, q, do, lse, delta)
    scale = d ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    fn = _kernels.bind(name, "ptt_flash_dq",
                       [_p, _p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _f,
                        _c, _f, _f, ctypes.c_uint, _p])
    p, seed_u32 = _dropout_args(seed, dropout_p)
    pt = _kernels.ptr
    rc = fn(pt(q), pt(k), pt(v), pt(do), pt(lse), pt(delta), pt(dq),
            _kernels.dtype_code(q), bh, sq, k.shape[1], d, float(scale),
            int(bool(causal)), p, 1.0 / (1.0 - p), seed_u32,
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return dq


def _check_stats(name: str, q, do, lse, delta) -> None:
    enforce(do.shape == q.shape and do.dtype == q.dtype,
            f"{name}: dO {tuple(do.shape)} {do.dtype} disagrees with q")
    enforce(lse.shape == q.shape[:2] and delta.shape == q.shape[:2]
            and lse.dtype == delta.dtype == torch.float32,
            f"{name}: lse / delta must be float32 {tuple(q.shape[:2])}")


# ---------------------------------------------------------------------------
# Autograd and the public op
# ---------------------------------------------------------------------------
class _FlashCore(torch.autograd.Function):
    """``custom_vjp`` ``_flash_attention_core`` of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, seed: int, scale: float, causal: bool,
                dropout_p: float):
        fwd = flash_fwd_cuda if q.is_cuda else flash_fwd_reference
        out, lse = fwd(q, k, v, seed, scale, causal, dropout_p)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (seed, scale, causal, dropout_p)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        if q.is_cuda:
            dk, dv = flash_dkdv_cuda(q, k, v, do, lse, delta, *ctx.args)
            dq = flash_dq_cuda(q, k, v, do, lse, delta, *ctx.args)
        else:
            dk, dv = flash_dkdv_reference(q, k, v, do, lse, delta, *ctx.args)
            dq = flash_dq_reference(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    training: bool = True, seed: Optional[int] = None):
    """Fused attention over (batch, heads, seq, head_dim) inputs of one
    dtype, differentiable in q, k and v.

    Matches ``nn.functional.scaled_dot_product_attention(...,
    is_causal=causal)`` (bottom-right causal alignment) without
    materialising the (seq, seq) probabilities.  ``dropout_p > 0`` keeps
    the fused path with the counter-hash mask, deterministic given
    ``seed``; with ``seed=None`` one is drawn from the framework's host
    stream (``framework/random.py``)."""
    enforce(q.dim() == 4, f"flash_attention: q must be (batch, heads, seq, "
            f"head_dim), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    enforce(k.shape == (b, h, sk, d) and v.shape == (b, h, sk, d),
            f"k/v shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} "
            f"v={tuple(v.shape)}")
    enforce(k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention: q, k, v differ in dtype ({q.dtype}, "
            f"{k.dtype}, {v.dtype})")
    scale = d ** -0.5 if scale is None else scale
    if not training:
        dropout_p = 0.0
    if dropout_p > 0.0:
        seed = fw_random.draw_seed() if seed is None else int(seed)
    else:
        seed = 0
    out = _FlashCore.apply(q.reshape(b * h, sq, d).contiguous(),
                           k.reshape(b * h, sk, d).contiguous(),
                           v.reshape(b * h, sk, d).contiguous(), seed,
                           float(scale), bool(causal), float(dropout_p))
    return out.reshape(b, h, sq, d)
