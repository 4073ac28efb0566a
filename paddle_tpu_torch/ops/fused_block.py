"""Block-level fused transformer ops: the port of ``paddle_tpu/ops/
fused_block.py`` that the serving, ``generate`` and fused-block training
paths run.

Three fused surfaces, each a CUDA kernel for Hopper beside its plain PyTorch
version:

  [K1 ln_linear]        LN(x) @ W + b          csrc/ln_linear.cu
  [K2 linear_residual]  r + dropout(x @ W + b) csrc/linear_residual.cu
  [K3 ffn]              x + drop2(W2 drop1(act(W1 LN(x) + b1)) + b2)
                                                csrc/ffn.cu

the attention half of a training block, :func:`fused_attention_block`: K1
-> flash attention (``ops/flash_attention.py``, attention dropout in the
kernel) -> K2; and the decode-step attention half over a fixed-shape cache,
:func:`fused_attention_block_kvcache`: K1 -> cache write -> the flash
decode kernel -> K2.

Routing is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises).  The plain versions repeat the
JAX reference route's arithmetic op for op, so the CPU tests hold them
against the JAX package; the kernels are held against the plain versions on
the card.  The kernels compute in float32 and store in the dtype the JAX
function returns, taking float32 or bfloat16 on each operand independently.

Gradients follow the JAX package's ``custom_vjp``s: on the card each
kernel sits in a ``torch.autograd.Function`` whose backward recomputes the
plain composition and returns its VJP (the dropout seed gets none); on the
CPU autograd runs through the plain versions themselves.  Under
``amp.auto_cast`` each op casts its inputs where the JAX op does, outside
those Functions, so gradients flow back through the casts.

Dropout is the counter-based hash of the JAX package (murmur3-fmix of seed,
salt, row, col; ``_keep_mask`` of ``ops/flash_attention.py``), emulated in
int64 with ``& 0xFFFFFFFF`` so the masks match JAX bit for bit; the K2 and
K3 kernels compute the same hash in their epilogues (``keep`` in
``csrc/common.cuh``).  A seed the caller does not give is drawn from the
framework's host stream, so the card and the CPU drop the same elements at
the same ``framework.random.seed``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .. import _kernels
from ..amp import state as amp_state
from ..framework import random as fw_random
from ..framework.errors import UnimplementedError, enforce
from .flash_attention import (_M32, _NEG_INF, _keep_mask, flash_attention,
                              flash_attention_kvcache)

__all__ = ["fused_ln_linear", "fused_linear_residual", "fused_ffn_block",
           "fused_attention_block", "fused_attention_block_kvcache",
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
_f = ctypes.c_float
_u = ctypes.c_uint
_p = ctypes.c_void_p


def _drop_args(p: float):
    """(p, 1 - p) as the kernels take them: ``1 - p`` is computed in double
    and rounded to float32, the value a float32 ``y / (1.0 - p)`` of the
    JAX package divides by."""
    return float(p), float(1.0 - p)


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


class _Recompute(torch.autograd.Function):
    """The JAX package's ``custom_vjp``s of K1-K3 (``_ln_linear_p``,
    ``_linear_residual_p``, ``_ffn_p``): forward launches ``kernel``;
    backward recomputes ``plain`` on the saved inputs under autograd and
    returns its VJP.  ``args`` are the ``n`` tensor inputs, then the
    static ones (epsilon, the seed, dropout rates, ...), which get no
    gradient."""

    @staticmethod
    def forward(ctx, kernel, plain, n, *args):
        ctx.plain, ctx.n, ctx.static = plain, n, args[n:]
        ctx.save_for_backward(*args[:n])
        return kernel(*args)

    @staticmethod
    def backward(ctx, gout):
        need = ctx.needs_input_grad[3:3 + ctx.n]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r)
                   for t, r in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*ins, *ctx.static)
            grads = iter(torch.autograd.grad(
                out, [t for t, r in zip(ins, need) if r], gout))
        return (None, None, None, *(next(grads) if r else None
                                    for r in need),
                *(None for _ in ctx.static))


def _route(kernel, plain, tensors, *static):
    """``kernel`` on CUDA tensors, differentiable by recompute
    (:class:`_Recompute`) when a gradient is wanted; ``plain`` on CPU
    tensors, differentiable by autograd.  Both take ``(*tensors,
    *static)``."""
    if not tensors[0].is_cuda:
        return plain(*tensors, *static)
    tensors = tuple(t.contiguous() for t in tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Recompute.apply(kernel, plain, len(tensors), *tensors,
                                *static)
    return kernel(*tensors, *static)


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
    GEMM and the output take ``w``'s dtype (under ``auto_cast`` only ``w``
    is cast, as in the JAX package)."""
    _, w = amp_state.cast_for_op("linear", x, w)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    out = _route(ln_linear_cuda, ln_linear_reference,
                 (x2, w, b, ln_scale, ln_bias), float(epsilon))
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


def linear_residual_cuda(x, w, b, r, seed: int = 0, dropout_p: float = 0.0,
                         salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 on the card: ``x`` (N, k), ``w`` (k, cols), ``r`` (N, cols);
    returns (N, cols) in ``r``'s dtype, with the hash dropout of ``seed``
    and ``salt`` over the global (row, col) when ``dropout_p > 0``."""
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
                        _c, _c, _c, _c, _u, _u, _f, _f, _p])
    row_tiles = -(-n // _TILE_ROWS)
    splits = _splits(dev, row_tiles, -(-cols // _TILE_COLS))
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), cd(w), pt(b), cd(b), pt(r), cd(r), pt(out),
            n, k, cols, splits, int(seed) & _M32, int(salt) & _M32,
            *_drop_args(dropout_p), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def fused_linear_residual(x, w, b, residual, *, dropout_p: float = 0.0,
                          training: bool = True, seed=None,
                          salt: int = _SALT_RESID):
    """``residual + dropout(x @ w + b)`` — the out-projection epilogue
    (bias + dropout + residual) in one output pass, the mask regenerated
    from ``seed`` in backward instead of stored.  Under ``auto_cast``
    ``x`` and ``w`` are cast, as in the JAX package."""
    x, w = amp_state.cast_for_op("linear", x, w)
    if not training:
        dropout_p = 0.0
    seed = _seed_or_draw(seed, dropout_p > 0.0)
    shape = residual.shape
    x2 = x.reshape(-1, x.shape[-1])
    r2 = residual.reshape(-1, shape[-1])
    out = _route(linear_residual_cuda, linear_residual_reference,
                 (x2, w, b, r2), seed, float(dropout_p), int(salt))
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


def ffn_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
             activation: str = "gelu", dropout1: float = 0.0,
             dropout2: float = 0.0, epsilon: float = 1e-5) -> torch.Tensor:
    """K3 on the card: ``x`` (N, h), ``w1`` (h, ffn), ``w2`` (ffn, h);
    returns (N, h) in ``x``'s dtype, with the hash dropouts of ``seed``
    (``dropout1`` after the activation, ``dropout2`` after ``+ b2``).  The
    (N, ffn) intermediate stays in shared memory.  With more than one
    cluster group per row tile (:func:`_ffn_grid`), or with ``dropout2``,
    each group's float32 (N, h) sum goes to a scratch allocated here,
    smaller than that intermediate, and the finalize kernel adds the
    groups and applies ``dropout2``."""
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
                        _c, _p, _p, _c, _c, _c, _f, _c, _c, _c,
                        _u, _u, _f, _f, _u, _f, _f, _p])
    groups, cluster = _ffn_grid(dev, n, h, ffn)
    part = (torch.empty((groups, n, h), dtype=torch.float32, device=dev)
            if groups > 1 or dropout2 > 0.0 else None)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w1), cd(w1), pt(b1), cd(b1), pt(w2), cd(w2),
            pt(b2), cd(b2), pt(g), cd(g), pt(beta), cd(beta),
            None if part is None else pt(part), pt(out), n, h, ffn,
            float(epsilon), 0 if activation == "gelu" else 1, groups,
            cluster, int(seed) & _M32, _SALT_FFN1, *_drop_args(dropout1),
            _SALT_FFN2, *_drop_args(dropout2), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def fused_ffn_block(x, w1, b1, w2, b2, ln_scale, ln_bias, *,
                    activation: str = "gelu", dropout1: float = 0.0,
                    dropout2: float = 0.0, epsilon: float = 1e-5,
                    training: bool = True, seed=None):
    """The FFN half of a pre-LN decoder block as one fused op:

        out = x + drop2(W2 · act(drop1(W1 · LN(x) + b1)) + b2)

    ``activation`` ∈ {gelu (exact), relu}.  Under ``auto_cast`` only
    ``w1`` and ``w2`` are cast, as in the JAX package."""
    enforce(activation in ("gelu", "relu"),
            f"fused_ffn_block: unsupported activation {activation!r}")
    _, w1 = amp_state.cast_for_op("linear", x, w1)
    _, w2 = amp_state.cast_for_op("linear", x, w2)
    if not training:
        dropout1 = dropout2 = 0.0
    seed = _seed_or_draw(seed, dropout1 > 0.0 or dropout2 > 0.0)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    out = _route(ffn_cuda, ffn_reference,
                 (x2, w1, b1, w2, b2, ln_scale, ln_bias), seed, activation,
                 float(dropout1), float(dropout2), float(epsilon))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# The attention half: K1 -> flash -> K2 under one op call
# ---------------------------------------------------------------------------
def _split_heads(qkv, b: int, s: int, num_heads: int, head_dim: int):
    """(N, 3h) -> q, k, v as (b, s, heads, d): head-major column order
    (head0: q|k|v, head1: ...), GPTAttention's factorization."""
    qkv = qkv.reshape(b, s, num_heads, 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _attention_ref(q, k, v, scale: float, causal: bool, dropout_p: float,
                   seed: int) -> torch.Tensor:
    """Attention in (b, s, heads, d) layout, the JAX package's
    ``_attention_ref``: scores in the inputs' dtype, then float32; a
    top-left causal mask; float32 softmax; the hash attention dropout over
    ``(b * heads + h, row, col)``, the flash kernels' indexing, so both
    routes drop the same elements for one seed; probabilities rounded to
    v's dtype before P.V."""
    b, s, nh, _ = q.shape
    dev = q.device
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt))
              * scale).float()
    idx = torch.arange(s, device=dev)
    if causal:
        scores = torch.where(idx[:, None] >= idx[None, :], scores,
                             torch.full((), _NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        bh = torch.arange(b * nh, device=dev).reshape(b, nh, 1, 1)
        keep = _keep_mask(seed, bh, idx[:, None], idx[None, :], dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=dev))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def fused_attention_block(x, qkv_w, qkv_b, out_w, out_b, ln_scale, ln_bias,
                          *, num_heads: int, causal: bool = True,
                          epsilon: float = 1e-5, attn_dropout: float = 0.0,
                          hidden_dropout: float = 0.0, rotary: bool = False,
                          rope_base: float = 10000.0, scale=None,
                          training: bool = True, seed=None):
    """The attention half of a pre-LN decoder block as one fused op:

        out = x + drop(W_out · attention(split(W_qkv · LN(x) + b)) + b)

    K1 (``fused_ln_linear``), then the flash kernels on the card
    (attention dropout in the kernel; they raise on a head dim they have
    no instantiation for) or :func:`_attention_ref` on the CPU, then K2
    (``fused_linear_residual``).  One seed serves the block: the flash
    dropout (salted by ``b * heads + h``) and K2's (``_SALT_RESID``), as in
    the JAX package.  ``qkv_w`` is (h, 3h) in head-major column order
    (head0: q|k|v, head1: ...), the GPTAttention layout."""
    if rotary:
        raise UnimplementedError(
            "fused_attention_block: rotary=True is not ported yet "
            "(_apply_rope, ROADMAP Queue 1)")
    b, s, hidden = x.shape
    enforce(hidden % num_heads == 0,
            f"hidden {hidden} not divisible by num_heads {num_heads}")
    head_dim = hidden // num_heads
    if scale is None:
        scale = head_dim ** -0.5
    if not training:
        attn_dropout = hidden_dropout = 0.0
    seed = _seed_or_draw(seed, attn_dropout > 0.0 or hidden_dropout > 0.0)
    qkv = fused_ln_linear(x, qkv_w, qkv_b, ln_scale, ln_bias,
                          epsilon=epsilon)
    q, k, v = _split_heads(qkv.reshape(b * s, -1), b, s, num_heads,
                           head_dim)
    if x.is_cuda:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, scale=scale,
                              dropout_p=attn_dropout, training=training,
                              seed=seed).transpose(1, 2)
    else:
        out = _attention_ref(q, k, v, scale, causal, attn_dropout, seed)
    return fused_linear_residual(out.reshape(b, s, hidden), out_w, out_b, x,
                                 dropout_p=hidden_dropout, training=training,
                                 seed=seed, salt=_SALT_RESID)


# ---------------------------------------------------------------------------
# The attention half of a decode step over a fixed-shape cache
# ---------------------------------------------------------------------------

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
            "(_apply_rope, ROADMAP Queue 1)")
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
