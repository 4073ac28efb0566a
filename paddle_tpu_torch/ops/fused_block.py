"""Block-level fused transformer ops: the port of ``paddle_tpu/ops/
fused_block.py`` that the serving and ``generate`` paths run.

Three fused surfaces, each a CUDA kernel for Hopper beside its plain PyTorch
version:

  [K1 ln_linear]        LN(x) @ W + b          csrc/ln_linear.cu
  [K2 linear_residual]  r + dropout(x @ W + b) csrc/linear_residual.cu
  [K3 ffn]              x + W2 act(W1 LN(x) + b1) + b2   csrc/ffn.cu

and the decode-step attention half over a fixed-shape cache,
:func:`fused_attention_block_kvcache`: K1 -> cache write -> the flash
decode kernel (``ops/flash_attention.py``) -> K2.

Routing is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises).  The plain versions repeat the
JAX reference route's arithmetic op for op, so the CPU tests hold them
against the JAX package; the kernels are held against the plain versions on
the card.  The kernels compute in float32 and store in the dtype the JAX
function returns, taking float32 or bfloat16 on each operand independently.

Dropout is the counter-based hash of the JAX package (murmur3-fmix of seed,
salt, row, col; ``_keep_mask`` of ``ops/flash_attention.py``), emulated in
int64 with ``& 0xFFFFFFFF`` so the masks match JAX bit for bit.  Only the
plain versions apply it: the serving path runs with dropout 0, and a CUDA
call with dropout > 0 raises until slice 2b (fused-block training, ROADMAP)
brings the in-kernel hash to the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .. import _kernels
from ..framework import random as fw_random
from ..framework.errors import UnimplementedError, enforce
from .flash_attention import _NEG_INF, _keep_mask, flash_attention_kvcache

__all__ = ["fused_ln_linear", "fused_linear_residual", "fused_ffn_block",
           "fused_attention_block_kvcache",
           "ln_linear_reference", "ln_linear_cuda",
           "linear_residual_reference", "linear_residual_cuda",
           "ffn_reference", "ffn_cuda"]

# distinct dropout sub-streams per epilogue (the bh slot of the flash hash)
_SALT_RESID = 0x52455344
_SALT_FFN1 = 0x46464E31
_SALT_FFN2 = 0x46464E32

_SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
_TILE_ROWS, _TILE_COLS, _TILE_DEPTH = 16, 64, 32   # csrc/common.cuh tiles

_c = ctypes.c_int
_p = ctypes.c_void_p


def _no_dropout_on_card(p: float, what: str) -> None:
    if p > 0.0:
        raise UnimplementedError(
            f"{what}: dropout > 0 on a CUDA tensor is not ported yet; the "
            "in-kernel hash dropout of K2/K3 comes with slice 2b, fused-block "
            "training (serving runs with dropout 0)")


# ---------------------------------------------------------------------------
# Counter-hash dropout (ops/fused_block.py _hash_drop of the JAX package),
# with the mask of ops/flash_attention.py
# ---------------------------------------------------------------------------
def _hash_drop(y: torch.Tensor, seed, salt: int, p: float) -> torch.Tensor:
    """Dropout of a (n, c) tensor by the hash mask over its global (row,
    col) indices, with the 1/(1-p) rescale."""
    n, c = y.shape
    rows = torch.arange(n, device=y.device)[:, None]
    cols = torch.arange(c, device=y.device)[None, :]
    keep = _keep_mask(seed, salt, rows, cols, p).to(y.device)
    return torch.where(keep, y / (1.0 - p), torch.zeros((), dtype=y.dtype,
                                                        device=y.device))


def _seed_or_draw(seed, need: bool) -> int:
    """The int32 dropout seed; drawn from the framework's host stream
    (``framework/random.py``) when the caller passed none."""
    if not need:
        return 0
    return fw_random.draw_seed() if seed is None else int(seed)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype (jnp.matmul promotes mixed inputs;
    torch.matmul refuses them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _ln_f32(x, g, beta, epsilon: float) -> torch.Tensor:
    """LayerNorm in float32 (the JAX oracle's op order), returned in
    float32 — callers cast to the GEMM dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if g is not None:
        y = y * g.float()
    if beta is not None:
        y = y + beta.float()
    return y


def _splits(device: torch.device, row_tiles: int, tiles: int) -> int:
    """Blocks per row tile that the column (or ffn) tiles are dealt to:
    enough for about two blocks per SM, at most one per tile."""
    want = -(-2 * _kernels.sm_count(device) // row_tiles)
    return max(1, min(tiles, want))


# ---------------------------------------------------------------------------
# K1: LN(x) @ W + b
# ---------------------------------------------------------------------------
def ln_linear_reference(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    y = _ln_f32(x, g, beta, epsilon).to(w.dtype)
    return torch.matmul(y, w) + b.to(w.dtype)


def ln_linear_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 on the card: ``x`` (N, h), ``w`` (h, cols); returns (N, cols) in
    ``w``'s dtype, as the JAX kernel does."""
    name = "ln_linear"
    dev = _kernels.require_cuda(name, x, w, b, g, beta)
    n, k = x.shape
    enforce(w.dim() == 2 and w.shape[0] == k,
            f"{name}: w {tuple(w.shape)} does not take x {tuple(x.shape)}")
    cols = w.shape[1]
    enforce(b.shape == (cols,) and g.shape == (k,) and beta.shape == (k,),
            f"{name}: bias / LN parameter shapes disagree with w")
    enforce(4 * (_TILE_ROWS * k + _TILE_DEPTH * _TILE_COLS) <= _SMEM_LIMIT,
            f"{name}: hidden size {k} does not fit a block's shared memory")
    out = torch.empty((n, cols), dtype=w.dtype, device=dev)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_ln_linear",
                       [_p, _c, _p, _c, _p, _c, _p, _c, _p, _c, _p, _c,
                        _c, _c, _c, ctypes.c_float, _c, _p])
    row_tiles = -(-n // _TILE_ROWS)
    splits = _splits(dev, row_tiles, -(-cols // _TILE_COLS))
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), cd(w), pt(b), cd(b), pt(g), cd(g),
            pt(beta), cd(beta), pt(out), cd(out), n, k, cols,
            float(epsilon), splits, _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def fused_ln_linear(x, w, b, ln_scale, ln_bias, *, epsilon: float = 1e-5):
    """``LN(x) @ w + b`` over the last dim of ``x`` — the pre-LN + QKV pair
    as one kernel pass.  LN runs in float32 on the raw activations; the
    GEMM and the output take ``w``'s dtype."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda:
        out = ln_linear_cuda(x2.contiguous(), w, b, ln_scale, ln_bias,
                             float(epsilon))
    else:
        out = ln_linear_reference(x2, w, b, ln_scale, ln_bias,
                                  float(epsilon))
    return out.reshape(*shape[:-1], w.shape[1])


# ---------------------------------------------------------------------------
# K2: r + dropout(x @ W + b)
# ---------------------------------------------------------------------------
def linear_residual_reference(x, w, b, r, seed: int = 0,
                              dropout_p: float = 0.0,
                              salt: int = _SALT_RESID) -> torch.Tensor:
    y = _mm(x, w).float() + b.float()
    if dropout_p > 0.0:
        y = _hash_drop(y, seed, salt, dropout_p)
    return (r.float() + y).to(r.dtype)


def linear_residual_cuda(x, w, b, r) -> torch.Tensor:
    """K2 on the card (dropout 0): ``x`` (N, k), ``w`` (k, cols), ``r``
    (N, cols); returns (N, cols) in ``r``'s dtype."""
    name = "linear_residual"
    dev = _kernels.require_cuda(name, x, w, b, r)
    n, k = x.shape
    enforce(w.dim() == 2 and w.shape[0] == k,
            f"{name}: w {tuple(w.shape)} does not take x {tuple(x.shape)}")
    cols = w.shape[1]
    enforce(b.shape == (cols,) and r.shape == (n, cols),
            f"{name}: bias {tuple(b.shape)} / residual {tuple(r.shape)} "
            f"disagree with ({n}, {cols})")
    enforce(4 * (_TILE_ROWS * k + _TILE_DEPTH * _TILE_COLS) <= _SMEM_LIMIT,
            f"{name}: depth {k} does not fit a block's shared memory")
    out = torch.empty((n, cols), dtype=r.dtype, device=dev)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_linear_residual",
                       [_p, _c, _p, _c, _p, _c, _p, _c, _p,
                        _c, _c, _c, _c, _p])
    row_tiles = -(-n // _TILE_ROWS)
    splits = _splits(dev, row_tiles, -(-cols // _TILE_COLS))
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), cd(w), pt(b), cd(b), pt(r), cd(r), pt(out),
            n, k, cols, splits, _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def fused_linear_residual(x, w, b, residual, *, dropout_p: float = 0.0,
                          training: bool = True, seed=None,
                          salt: int = _SALT_RESID):
    """``residual + dropout(x @ w + b)`` — the out-projection epilogue
    (bias + dropout + residual) in one output pass."""
    if not training:
        dropout_p = 0.0
    shape = residual.shape
    x2 = x.reshape(-1, x.shape[-1])
    r2 = residual.reshape(-1, shape[-1])
    if x2.is_cuda:
        _no_dropout_on_card(dropout_p, "fused_linear_residual")
        out = linear_residual_cuda(x2.contiguous(), w, b, r2.contiguous())
    else:
        out = linear_residual_reference(
            x2, w, b, r2, _seed_or_draw(seed, dropout_p > 0.0),
            float(dropout_p), int(salt))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# K3: x + drop2(W2 act(drop1(W1 LN(x) + b1)) + b2)
# ---------------------------------------------------------------------------
_ffn_clusters: Dict[Tuple[int, int], int] = {}


def _ffn_grid(device: torch.device, n: int, h: int,
              ffn: int) -> Tuple[int, int]:
    """(groups, cluster): the ffn tiles of a row tile are dealt to
    ``groups`` thread-block clusters of ``cluster`` blocks.  A cluster sums
    its blocks' accumulators on chip; each group beyond one costs a float32
    (N, h) partial in device memory, so ``groups * h < ffn`` keeps those
    partials smaller than the (N, ffn) intermediate.  Within that, enough
    blocks for about two per SM."""
    key = (device.index, h)
    if key not in _ffn_clusters:
        fn = _kernels.bind("ffn", "ptt_ffn_max_cluster",
                           [_c, ctypes.POINTER(_c)])
        limit = _c(0)
        with torch.cuda.device(device):
            _kernels.check(fn(h, ctypes.byref(limit)), "ffn")
        _ffn_clusters[key] = limit.value
    tiles = -(-ffn // _TILE_COLS)
    cluster = 1
    while cluster * 2 <= min(tiles, _ffn_clusters[key]):
        cluster *= 2
    want = -(-2 * _kernels.sm_count(device) // -(-n // _TILE_ROWS))
    groups = max(1, min(tiles // cluster, want // cluster, (ffn - 1) // h))
    return groups, cluster


def _activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return torch.clamp_min(h, 0.0)


def ffn_reference(x, w1, b1, w2, b2, g, beta, seed: int = 0,
                  activation: str = "gelu", dropout1: float = 0.0,
                  dropout2: float = 0.0,
                  epsilon: float = 1e-5) -> torch.Tensor:
    lnx = _ln_f32(x, g, beta, epsilon).to(w1.dtype)
    h = torch.matmul(lnx, w1).float() + b1.float()
    h = _activate(h, activation)
    if dropout1 > 0.0:
        h = _hash_drop(h, seed, _SALT_FFN1, dropout1)
    y = _mm(h.to(w2.dtype), w2).float() + b2.float()
    if dropout2 > 0.0:
        y = _hash_drop(y, seed, _SALT_FFN2, dropout2)
    return (x.float() + y).to(x.dtype)


def ffn_cuda(x, w1, b1, w2, b2, g, beta, activation: str = "gelu",
             epsilon: float = 1e-5) -> torch.Tensor:
    """K3 on the card (dropout 0): ``x`` (N, h), ``w1`` (h, ffn), ``w2``
    (ffn, h); returns (N, h) in ``x``'s dtype.  The (N, ffn) intermediate
    stays in shared memory.  With more than one cluster group per row tile
    (:func:`_ffn_grid`), each group's float32 (N, h) sum goes to a scratch
    allocated here, smaller than that intermediate."""
    name = "ffn"
    dev = _kernels.require_cuda(name, x, w1, b1, w2, b2, g, beta)
    n, h = x.shape
    enforce(w1.dim() == 2 and w1.shape[0] == h,
            f"{name}: w1 {tuple(w1.shape)} does not take x {tuple(x.shape)}")
    ffn = w1.shape[1]
    enforce(w2.shape == (ffn, h) and b1.shape == (ffn,) and b2.shape == (h,)
            and g.shape == (h,) and beta.shape == (h,),
            f"{name}: parameter shapes disagree with h={h}, ffn={ffn}")
    enforce(4 * (2 * _TILE_ROWS * h + _TILE_ROWS * _TILE_COLS
                 + _TILE_DEPTH * _TILE_COLS) <= _SMEM_LIMIT,
            f"{name}: hidden size {h} does not fit a block's shared memory "
            "(LN(x) and the accumulator of 16 rows)")
    enforce(activation in ("gelu", "relu"),
            f"{name}: unsupported activation {activation!r}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_ffn",
                       [_p, _c, _p, _c, _p, _c, _p, _c, _p, _c, _p, _c, _p,
                        _c, _p, _p, _c, _c, _c, ctypes.c_float, _c, _c, _c,
                        _p])
    groups, cluster = _ffn_grid(dev, n, h, ffn)
    part = (torch.empty((groups, n, h), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w1), cd(w1), pt(b1), cd(b1), pt(w2), cd(w2),
            pt(b2), cd(b2), pt(g), cd(g), pt(beta), cd(beta),
            None if part is None else pt(part), pt(out), n, h, ffn,
            float(epsilon), 0 if activation == "gelu" else 1, groups,
            cluster, _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def fused_ffn_block(x, w1, b1, w2, b2, ln_scale, ln_bias, *,
                    activation: str = "gelu", dropout1: float = 0.0,
                    dropout2: float = 0.0, epsilon: float = 1e-5,
                    training: bool = True, seed=None):
    """The FFN half of a pre-LN decoder block as one fused op:

        out = x + drop2(W2 · act(drop1(W1 · LN(x) + b1)) + b2)

    ``activation`` ∈ {gelu (exact), relu}."""
    enforce(activation in ("gelu", "relu"),
            f"fused_ffn_block: unsupported activation {activation!r}")
    if not training:
        dropout1 = dropout2 = 0.0
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda:
        _no_dropout_on_card(max(dropout1, dropout2), "fused_ffn_block")
        out = ffn_cuda(x2.contiguous(), w1, b1, w2, b2, ln_scale, ln_bias,
                       activation, float(epsilon))
    else:
        seed = _seed_or_draw(seed, dropout1 > 0.0 or dropout2 > 0.0)
        out = ffn_reference(x2, w1, b1, w2, b2, ln_scale, ln_bias, seed,
                            activation, float(dropout1), float(dropout2),
                            float(epsilon))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# The attention half of a decode step over a fixed-shape cache
# ---------------------------------------------------------------------------
def _split_heads(qkv, b: int, s: int, num_heads: int, head_dim: int):
    """(N, 3h) -> q, k, v as (b, s, heads, d): head-major column order
    (head0: q|k|v, head1: ...), GPTAttention's factorization."""
    qkv = qkv.reshape(b, s, num_heads, 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def fused_attention_block_kvcache(x, qkv_w, qkv_b, out_w, out_b, ln_scale,
                                  ln_bias, k_buf, v_buf, used, *,
                                  num_heads: int, epsilon: float = 1e-5,
                                  scale=None, rotary: bool = False,
                                  rope_base: float = 10000.0):
    """Decode step of the attention half against a fixed-shape cache:
    fused LN -> QKV (K1), the new k / v written at ``used`` (a 0-d int32
    tensor), attention over the cache, out-projection + residual (K2).
    Inference only.  Returns ``(out, k_buf, v_buf)``; the buffers are
    written in place (the JAX package builds new arrays).

    The two routes of the JAX function are kept apart, as their dtypes
    differ: on the card a single-token step (``s == 1``, ``L % 8 == 0``,
    ``head_dim % 8 == 0``) runs the flash decode kernel, whose output takes
    q's dtype (K1's, the weights'), as on a TPU; every other call runs the
    einsum route of the JAX package's CPU path, whose probabilities and
    output take the cache dtype."""
    if rotary:
        raise UnimplementedError(
            "fused_attention_block_kvcache: rotary=True is not ported yet "
            "(_apply_rope, ROADMAP Queue 1 item 4)")
    b, s, hidden = x.shape
    head_dim = hidden // num_heads
    if scale is None:
        scale = head_dim ** -0.5
    used = torch.as_tensor(used, dtype=torch.int32, device=x.device)
    qkv = fused_ln_linear(x, qkv_w, qkv_b, ln_scale, ln_bias,
                          epsilon=epsilon)
    q, k, v = _split_heads(qkv.reshape(b * s, -1), b, s, num_heads,
                           head_dim)
    q = q.transpose(1, 2)                             # (b, heads, s, d)
    rows = used.long() + torch.arange(s, device=x.device)
    k_buf.index_copy_(2, rows, k.transpose(1, 2).to(k_buf.dtype))
    v_buf.index_copy_(2, rows, v.transpose(1, 2).to(v_buf.dtype))
    cap = k_buf.shape[2]
    if x.is_cuda and s == 1 and cap % 8 == 0 and head_dim % 8 == 0:
        out = flash_attention_kvcache(q, k_buf, v_buf, used + 1, scale=scale)
    else:
        dt = torch.promote_types(q.dtype, k_buf.dtype)
        scores = (torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k_buf.to(dt))
                  * scale).float()
        cols = torch.arange(cap, device=x.device)
        valid = cols[None, :] <= rows[:, None]
        scores = torch.where(valid, scores,
                             torch.full((), _NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(v_buf.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v_buf)
    out = out.transpose(1, 2).reshape(b, s, hidden)
    y = fused_linear_residual(out, out_w, out_b, x, dropout_p=0.0,
                              training=False)
    return y, k_buf, v_buf
