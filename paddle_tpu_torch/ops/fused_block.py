"""Block-level fused transformer ops: the port of ``paddle_tpu/ops/
fused_block.py`` that the serving, ``generate`` and fused-block training
paths run.

Three fused surfaces, each a CUDA kernel for Hopper beside its plain PyTorch
version:

  [K1 ln_linear]        LN(x) @ W + b          csrc/ln_linear.cu (float32 W)
                                               csrc/ln_linear_mma.cu (bf16 W)
                                               csrc/ln_linear_stream.cu
                                               (float32 W, a few rows)
                                               csrc/ln_linear_tiled.cu
                                               (float32 W, more rows)
  [K2 linear_residual]  r + dropout(x @ W + b) csrc/linear_residual.cu
                                               (float32 operands)
                                               csrc/linear_residual_mma.cu
                                               (bf16 x and W)
                                               csrc/linear_residual_stream.cu
                                               (float32 W, a few rows)
                                               csrc/linear_residual_tiled.cu
                                               (float32 W, more rows)
  [K3 ffn]              x + drop2(W2 drop1(act(W1 LN(x) + b1)) + b2)
                                                csrc/ffn.cu (float32 weights)
                                                csrc/ffn_mma.cu (bf16 weights)
                                                csrc/ffn_stream.cu (float32
                                                weights, a few rows)
                                                csrc/ffn_tiled.cu (float32
                                                weights, more rows)

Each bf16 kernel (``*_mma``: mma.sync on the tensor cores), each
weight-streaming kernel (``*_stream``: float32 weights at a few rows, up
to ``_LN_STREAM_MAX_ROWS``, ``_RESID_STREAM_MAX_ROWS`` and
``_FFN_STREAM_MAX_ROWS``, the decode steps of serving and ``generate``) and
each register-blocked float32 kernel (``*_tiled``, on the shared GEMM body
of ``csrc/tiled.cuh``: float32 weights above those rows, the prefills)
takes the calls that its route function (``ln_linear_route``,
``linear_residual_route``, ``ffn_route``) names from dtypes, shapes,
addresses and row counts on the host; every other CUDA call (widths or
addresses none of them can stage) runs the SIMT float32 kernel beside
them.

the attention half of a training block, :func:`fused_attention_block`: K1
-> [rope] -> flash attention (``ops/flash_attention.py``, attention dropout
in the kernel) -> K2; and the decode-step attention half over a fixed-shape
cache, :func:`fused_attention_block_kvcache`: K1 -> [rope] -> cache write
-> the flash decode kernel -> K2.  With ``rotary=True`` the rotary
embedding runs between the kernels in plain PyTorch (:func:`_apply_rope`),
as XLA computes it outside Pallas in the JAX package.

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
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .. import _kernels
from ..amp import state as amp_state
from ..framework import random as fw_random
from ..framework.errors import enforce
from .flash_attention import (_M32, _NEG_INF, _keep_mask, flash_attention,
                              flash_attention_kvcache)
from .fused import _rope_tables_on, _rotate

__all__ = ["fused_ln_linear", "fused_linear_residual", "fused_ffn_block",
           "fused_attention_block", "fused_attention_block_kvcache",
           "ln_linear_reference", "ln_linear_cuda", "ln_linear_mma_cuda",
           "ln_linear_stream_cuda", "ln_linear_tiled_cuda",
           "ln_linear_simt_cuda", "ln_linear_route",
           "linear_residual_reference",
           "linear_residual_cuda", "linear_residual_mma_cuda",
           "linear_residual_stream_cuda", "linear_residual_tiled_cuda",
           "linear_residual_simt_cuda", "linear_residual_route",
           "ffn_reference", "ffn_cuda", "ffn_mma_cuda", "ffn_stream_cuda",
           "ffn_tiled_cuda", "ffn_simt_cuda", "ffn_route"]

# distinct dropout sub-streams per epilogue (the bh slot of the flash hash)
_SALT_RESID = 0x52455344
_SALT_FFN1 = 0x46464E31
_SALT_FFN2 = 0x46464E32

_SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
_TILE_ROWS, _TILE_COLS, _TILE_DEPTH = 16, 64, 32   # csrc/common.cuh tiles

# The hidden sizes (K1's and K2's depth, K3's h) with an instantiation in
# the tensor-core kernels (csrc/*_mma.cu): gpt_tiny's and GPT-125M's
_MMA_HIDDEN = (128, 768)

# The weight-streaming kernels (csrc/*_stream.cu) take float32-weight calls
# of a few rows, each route up to its own bound below.  Their widths (K2's
# depth and columns, K3's h, K1's h) are at most _STREAM_MAX_H: a thread
# owns one quad of K3's output columns (256 threads).  K1's columns (the
# QKV projection's 3h) are at most _LN_STREAM_MAX_COLS, 3h at that h: up to
# it a grid of one depth chunk a block, about one block an SM, fits a
# block's shared memory at 64 rows.
_STREAM_MAX_H = 1024
_LN_STREAM_MAX_COLS = 3 * _STREAM_MAX_H
# The most rows of a float32-weight call that each weight-streaming kernel
# takes: above them the register-blocked kernel of its route (csrc/
# *_tiled.cu) is faster in the card's alternated timings at GPT-125M's
# widths (PERF.md, findings), stream against tiled, ms: K1 0.0315 / 0.0360
# at 32 rows, 0.0461 / 0.0369 at 48; K2 0.0165 / 0.0169 at 32, 0.0210 /
# 0.0171 at 48; K3 0.0632 / 0.0806 at 32, 0.0908 / 0.0816 at 48 (ffn_stream
# walks N in launches of 16 rows)
_LN_STREAM_MAX_ROWS = 32
_RESID_STREAM_MAX_ROWS = 32
_FFN_STREAM_MAX_ROWS = 32

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
    *static)``.  While ``torch.export`` traces, the registered op of
    ``kernel`` (``ops/registered.py``), which chooses at run time."""
    if torch.compiler.is_exporting():
        from .registered import EXPORTED
        return EXPORTED[kernel](*tensors, *static)
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


def _bf16_operand(t: torch.Tensor) -> bool:
    """A bf16 GEMM operand that the tensor-core kernels stage in 16-byte
    copies: 2-d, rows a multiple of 8 elements, 16-byte aligned."""
    return (t.dtype == torch.bfloat16 and t.dim() == 2
            and t.shape[1] % 8 == 0 and t.data_ptr() % 16 == 0)


def _check_smem(name: str, h: int) -> None:
    """The dynamic shared memory a block of ``name``'s instantiation for
    ``h`` takes (``ptt_<name>_smem`` of its library says; 0 for no
    instantiation) fits a block."""
    smem = _kernels.bind(name, f"ptt_{name}_smem", [_c])(h)
    enforce(0 < smem <= _SMEM_LIMIT,
            f"{name}: {smem} bytes of shared memory a block at h={h}")


# ---------------------------------------------------------------------------
# The weight-streaming GEMM of K1 and K2 at a few rows
# ---------------------------------------------------------------------------
def _stream_weight(w: torch.Tensor) -> bool:
    """A float32 weight that the weight-streaming kernels stage in 16-byte
    copies: 2-d, rows a multiple of 4 elements, 16-byte aligned."""
    return (w.dtype == torch.float32 and w.dim() == 2
            and w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0)


# The weight-streaming kernels' most blocks of a cluster (portable size)
_STREAM_MAX_CLUSTER = 8


def _stream_gemm_smem(n: int, width: int, depth: int) -> int:
    """Bytes of dynamic shared memory a block of ``linear_residual_stream``
    or ``ln_linear_stream`` takes (``ptt_*_stream_smem``, ``ptt_stream::
    gemm`` of ``csrc/stream.cuh``): its W chunk, the A rows over its depth
    (rounded up to 8 rows) and its (n, width) partial."""
    return 4 * (depth * width + -(-n // 8) * 8 * depth + n * width)


@functools.lru_cache(maxsize=None)
def _stream_gemm_grid(sms: int, n: int, k: int,
                      cols: int) -> Optional[Tuple[int, int, int]]:
    """(cluster, width, depth) of the depth-split weight-streaming GEMM
    (``linear_residual_stream``, ``ln_linear_stream``) for N=n rows of a
    (k, cols) weight on a card of ``sms`` SMs: column tiles of ``width``
    columns (a multiple of 4; 32 or more where cols allows: rows of 128
    bytes or more), each split by depth into ``cluster`` chunks of ``depth``
    rows, one chunk a block.  Of the cluster sizes up to 8 whose blocks fit
    in shared memory, the one with the most blocks, at most one an SM; the
    smaller cluster on a tie.  None when no size fits."""
    best = None
    for cluster in range(1, _STREAM_MAX_CLUSTER + 1):
        tiles = max(1, sms // cluster)
        width = max(min(32, 4 * -(-cols // 4)), 4 * -(-cols // (4 * tiles)))
        depth = -(-k // cluster)
        if (depth * (cluster - 1) >= k
                or _stream_gemm_smem(n, width, depth) > _SMEM_LIMIT):
            continue
        blocks = cluster * -(-cols // width)
        if best is None or blocks > best[0]:
            best = (blocks, (cluster, width, depth))
    return None if best is None else best[1]


# ---------------------------------------------------------------------------
# K1: LN(x) @ W + b
# ---------------------------------------------------------------------------
def ln_linear_reference(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    y = _ln_f32(x, g, beta, epsilon).to(w.dtype)
    return torch.matmul(y, w) + b.to(w.dtype)


def _check_ln_linear_shapes(name, x, w, b, g, beta):
    n, k = x.shape
    enforce(w.dim() == 2 and w.shape[0] == k,
            f"{name}: w {tuple(w.shape)} does not take x {tuple(x.shape)}")
    cols = w.shape[1]
    enforce(b.shape == (cols,) and g.shape == (k,) and beta.shape == (k,),
            f"{name}: bias / LN parameter shapes disagree with w")
    return n, k, cols


def ln_linear_route(w: torch.Tensor, n: int) -> str:
    """The K1 kernel a CUDA call of :func:`ln_linear_cuda` of N=``n`` rows
    launches, decided on the host from the weight and the row count:
    ``"ln_linear_mma"`` (``csrc/ln_linear_mma.cu``, bf16 tensor cores) when
    ``w`` (h, cols) is bfloat16, h is one of ``_MMA_HIDDEN``, cols is a
    multiple of 8 and ``w`` starts on a 16-byte boundary; for a float32
    ``w`` that the weight-streaming kernels can stage (cols a multiple of
    4, a 16-byte aligned start), ``"ln_linear_stream"``
    (``csrc/ln_linear_stream.cu``) at N at most ``_LN_STREAM_MAX_ROWS`` with h
    at most ``_STREAM_MAX_H`` and cols at most ``_LN_STREAM_MAX_COLS``, and
    otherwise ``"ln_linear_tiled"`` (``csrc/ln_linear_tiled.cu``,
    register-blocked float32) when h is a multiple of 8 (x's rows then move
    in 16-byte copies); ``"ln_linear"`` (``csrc/ln_linear.cu``, the SIMT
    float32 kernel) for every other call.  ``x`` may be float32 or bfloat16
    on each."""
    if _bf16_operand(w) and w.shape[0] in _MMA_HIDDEN:
        return "ln_linear_mma"
    if _stream_weight(w):
        h, cols = w.shape
        if (n <= _LN_STREAM_MAX_ROWS and h <= _STREAM_MAX_H
                and cols <= _LN_STREAM_MAX_COLS):
            return "ln_linear_stream"
        if h % 8 == 0:
            return "ln_linear_tiled"
    return "ln_linear"


# K1's tensor-core kernel: a 64-row tile a block, column tiles of 256, one
# block an SM (csrc/ln_linear_mma.cu)
_MMA_LN_ROWS, _MMA_LN_COLS = 64, 256


def _mma_splits(device: torch.device, row_tiles: int, tiles: int) -> int:
    """Blocks per 64-row tile that ``ln_linear_mma`` deals its column tiles
    to, one block an SM: the fewest that minimise the whole waves of blocks
    times a block's work, its column tiles plus its LN of the row tile
    (counted as half a column tile).  1 at the training shape (256 row
    tiles, 2 waves of 9 tiles), 2 at N=4096, every tile its own block at
    N=8."""
    sms = _kernels.sm_count(device)
    return min(range(1, tiles + 1),
               key=lambda s: (-(-row_tiles * s // sms)
                              * (2 * -(-tiles // s) + 1), s))


def ln_linear_mma_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 on the tensor cores (``csrc/ln_linear_mma.cu``), for the calls
    that :func:`ln_linear_route` sends there; as :func:`ln_linear_cuda`.
    LN(x) is computed once per 64-row tile and kept in shared memory as
    bf16; the bias is added in float32 and the sum rounded once to bf16."""
    name = "ln_linear_mma"
    dev = _kernels.require_cuda(name, x, w, b, g, beta)
    n, k, cols = _check_ln_linear_shapes(name, x, w, b, g, beta)
    enforce(ln_linear_route(w, n) == name,
            f"{name}: takes a bf16 w with h in {_MMA_HIDDEN}, cols a "
            f"multiple of 8 and 16-byte aligned rows; got {w.dtype} "
            f"{tuple(w.shape)}")
    _check_smem(name, k)
    out = torch.empty((n, cols), dtype=w.dtype, device=dev)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_ln_linear_mma",
                       [_p, _c, _p, _p, _c, _p, _c, _p, _c, _p, _c, _c, _c,
                        _f, _c, _p])
    splits = _mma_splits(dev, -(-n // _MMA_LN_ROWS), -(-cols // _MMA_LN_COLS))
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), pt(b), cd(b), pt(g), cd(g), pt(beta),
            cd(beta), pt(out), n, k, cols, float(epsilon), splits,
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def ln_linear_stream_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 by weight streaming (``csrc/ln_linear_stream.cu``), for the calls
    that :func:`ln_linear_route` sends there; as :func:`ln_linear_cuda`.
    One launch on the grid of K2's stream kernel
    (:func:`_stream_gemm_grid`): each block holds its whole chunk of W in
    flight at once while it takes LN(x) of the rows over its depth slice,
    and a cluster sums its depth chunks through distributed shared memory
    before + b.  Any N whose grid fits: the route adds the bound on N."""
    name = "ln_linear_stream"
    dev = _kernels.require_cuda(name, x, w, b, g, beta)
    n, k, cols = _check_ln_linear_shapes(name, x, w, b, g, beta)
    enforce(_stream_weight(w) and k <= _STREAM_MAX_H
            and cols <= _LN_STREAM_MAX_COLS,
            f"{name}: takes a float32 w with h at most {_STREAM_MAX_H}, cols "
            f"at most {_LN_STREAM_MAX_COLS} and a multiple of 4 and a "
            f"16-byte aligned start; got {w.dtype} {tuple(w.shape)}")
    out = torch.empty((n, cols), dtype=w.dtype, device=dev)
    if n == 0:
        return out
    grid = _stream_gemm_grid(_kernels.sm_count(dev), n, k, cols)
    enforce(grid is not None,
            f"{name}: no grid fits shared memory at N={n}, k={k}")
    cluster, width, depth = grid
    smem = _kernels.bind(name, "ptt_ln_linear_stream_smem", [_c, _c, _c])
    enforce(smem(n, width, depth) == _stream_gemm_smem(n, width, depth),
            f"{name}: the library's shared memory a block is not the "
            "grid's")
    fn = _kernels.bind(name, "ptt_ln_linear_stream",
                       [_p, _c, _p, _p, _c, _p, _c, _p, _c, _p, _c, _c, _c,
                        _c, _c, _c, _f, _p])
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), pt(b), cd(b), pt(g), cd(g), pt(beta),
            cd(beta), pt(out), n, k, cols, width, depth, cluster,
            float(epsilon), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


# The register-blocked float32 kernels (csrc/ln_linear_tiled.cu,
# ffn_tiled.cu, linear_residual_tiled.cu, on the GEMM body of
# csrc/tiled.cuh): a 64 x 128 output tile a block of 128 threads, 16-deep
# slabs
_TILED_ROWS, _TILED_COLS, _TILED_DEPTH = 64, 128, 16


def _tiled_raw_smem() -> int:
    """Bytes of dynamic shared memory a block of a tiled kernel whose A is
    taken as it is takes at any depth (``linear_residual_tiled``, the down
    pass of ``ffn_tiled``; ``ptt_linear_residual_tiled_smem``): a 3-stage
    ring of W slabs, two transposed A slabs and a 3-stage ring of raw A
    slabs (sized for float32)."""
    return 4 * (3 * _TILED_DEPTH * _TILED_COLS + 2 * _TILED_DEPTH * _TILED_ROWS
                + 3 * _TILED_ROWS * _TILED_DEPTH)


def _tiled_smem(h: int) -> int:
    """Bytes of dynamic shared memory a block of a tiled kernel with the
    LayerNorm prologue takes at depth h (``ln_linear_tiled``, the up pass
    of ``ffn_tiled``; ``ptt_ln_linear_tiled_smem``): the raw body's
    (:func:`_tiled_raw_smem`), each row's mean and rstd, and g and beta as
    float32."""
    return _tiled_raw_smem() + 4 * (2 * _TILED_ROWS + 2 * h)


def _tiled_splits(sms: int, n: int, k: int, cols: int) -> int:
    """Depth chunks of a tiled kernel's pass of N=n rows over a (k, cols)
    W: the blocks of a thread-block cluster that split each 64 x 128 output
    tile's depth, their partials summed through distributed shared memory.
    The most that keep the blocks at no more than 2.5 an SM (the card holds
    3; more chunks cost more: each block of an LN pass repeats its rows'
    statistics, and every chunk adds a partial to the sum), at most 8 (a
    portable cluster), and at least 4 slabs of 16 a chunk.  K1 at
    GPT-125M's QKV projection: 1 at generate's 4096 rows, 2 at serving's
    512, up to 8 for the smaller prefill buckets (where a sweep of 1-8 at
    64-1024 rows on the card found the best; PERF.md, findings)."""
    tiles = -(-n // _TILED_ROWS) * -(-cols // _TILED_COLS)
    return max(1, min(_STREAM_MAX_CLUSTER, 5 * sms // (2 * tiles),
                      -(-k // _TILED_DEPTH) // 4))


def ln_linear_tiled_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 by the register-blocked float32 kernel
    (``csrc/ln_linear_tiled.cu``), for the calls that
    :func:`ln_linear_route` sends there; as :func:`ln_linear_cuda`.  Each
    block takes its rows' LN statistics, then normalises each x slab as it
    stages it; the depth of a tile is split over :func:`_tiled_splits`
    blocks of a cluster.  Any N and h."""
    name = "ln_linear_tiled"
    dev = _kernels.require_cuda(name, x, w, b, g, beta)
    n, k, cols = _check_ln_linear_shapes(name, x, w, b, g, beta)
    enforce(_stream_weight(w) and k % 8 == 0,
            f"{name}: takes a float32 w with h a multiple of 8, cols a "
            f"multiple of 4 and a 16-byte aligned start; got {w.dtype} "
            f"{tuple(w.shape)}")
    smem = _kernels.bind(name, "ptt_ln_linear_tiled_smem", [_c])(k)
    enforce(smem == _tiled_smem(k) <= _SMEM_LIMIT,
            f"{name}: {smem} bytes of shared memory a block at h={k} (the "
            f"wrapper counts {_tiled_smem(k)})")
    out = torch.empty((n, cols), dtype=w.dtype, device=dev)
    if n == 0:
        return out
    if x.data_ptr() % 16:
        # a view that starts inside its storage: x's rows move in 16-byte
        # copies, so they must start on a 16-byte boundary
        x = x.clone()
    fn = _kernels.bind(name, "ptt_ln_linear_tiled",
                       [_p, _c, _p, _p, _c, _p, _c, _p, _c, _p, _c, _c, _c,
                        _c, _f, _p])
    cluster = _tiled_splits(_kernels.sm_count(dev), n, k, cols)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), pt(b), cd(b), pt(g), cd(g), pt(beta),
            cd(beta), pt(out), n, k, cols, cluster, float(epsilon),
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def ln_linear_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 on the card: ``x`` (N, h), ``w`` (h, cols); returns (N, cols) in
    ``w``'s dtype, as the JAX kernel does.  The kernel is the one
    :func:`ln_linear_route` names: the tensor-core kernel
    (:func:`ln_linear_mma_cuda`), the weight-streaming one
    (:func:`ln_linear_stream_cuda`), the register-blocked float32 one
    (:func:`ln_linear_tiled_cuda`) or the SIMT float32 one
    (:func:`ln_linear_simt_cuda`)."""
    route = ln_linear_route(w, x.shape[0])
    if route == "ln_linear_mma":
        return ln_linear_mma_cuda(x, w, b, g, beta, epsilon)
    if route == "ln_linear_stream":
        return ln_linear_stream_cuda(x, w, b, g, beta, epsilon)
    if route == "ln_linear_tiled":
        return ln_linear_tiled_cuda(x, w, b, g, beta, epsilon)
    return ln_linear_simt_cuda(x, w, b, g, beta, epsilon)


def ln_linear_simt_cuda(x, w, b, g, beta, epsilon: float) -> torch.Tensor:
    """K1 by the float32 kernel of ``csrc/ln_linear.cu`` (CUDA cores), for
    the calls that :func:`ln_linear_route` sends there (and any other it
    can take); as :func:`ln_linear_cuda`."""
    name = "ln_linear"
    dev = _kernels.require_cuda(name, x, w, b, g, beta)
    n, k, cols = _check_ln_linear_shapes(name, x, w, b, g, beta)
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


def _check_linear_residual_shapes(name, x, w, b, r):
    n, k = x.shape
    enforce(w.dim() == 2 and w.shape[0] == k,
            f"{name}: w {tuple(w.shape)} does not take x {tuple(x.shape)}")
    cols = w.shape[1]
    enforce(b.shape == (cols,) and r.shape == (n, cols),
            f"{name}: bias {tuple(b.shape)} / residual {tuple(r.shape)} "
            f"disagree with ({n}, {cols})")
    return n, k, cols


def linear_residual_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The K2 kernel a CUDA call of :func:`linear_residual_cuda` launches,
    decided on the host: ``"linear_residual_mma"``
    (``csrc/linear_residual_mma.cu``, bf16 tensor cores) when ``w`` (k,
    cols) is bfloat16 with k one of ``_MMA_HIDDEN``, cols a multiple of 8
    and a 16-byte aligned start, and ``x`` (N, k) is bfloat16 and 16-byte
    aligned; for a float32 ``w`` with cols a multiple of 4 and a 16-byte
    aligned start, ``"linear_residual_stream"``
    (``csrc/linear_residual_stream.cu``, float32 weight streaming) at N at
    most ``_RESID_STREAM_MAX_ROWS`` with k and cols at most
    ``_STREAM_MAX_H``, and otherwise ``"linear_residual_tiled"``
    (``csrc/linear_residual_tiled.cu``, register-blocked float32) when k
    is a multiple of 8 (x's rows then move in 16-byte copies);
    ``"linear_residual"`` (``csrc/linear_residual.cu``, the SIMT float32
    kernel) for every other call.  ``x`` and ``r`` may be float32 or
    bfloat16 on the last three."""
    if (_bf16_operand(w) and w.shape[0] in _MMA_HIDDEN
            and _bf16_operand(x)):
        return "linear_residual_mma"
    if _stream_weight(w):
        if (x.shape[0] <= _RESID_STREAM_MAX_ROWS
                and max(w.shape) <= _STREAM_MAX_H):
            return "linear_residual_stream"
        if w.shape[0] % 8 == 0:
            return "linear_residual_tiled"
    return "linear_residual"


def linear_residual_mma_cuda(x, w, b, r, seed: int = 0,
                             dropout_p: float = 0.0,
                             salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 on the tensor cores (``csrc/linear_residual_mma.cu``), for the
    calls that :func:`linear_residual_route` sends there; as
    :func:`linear_residual_cuda`.  b, the dropout and r are applied in
    float32 and the sum rounded once to ``r``'s dtype."""
    name = "linear_residual_mma"
    dev = _kernels.require_cuda(name, x, w, b, r)
    n, k, cols = _check_linear_residual_shapes(name, x, w, b, r)
    enforce(linear_residual_route(x, w) == name,
            f"{name}: takes bf16 x and w with k in {_MMA_HIDDEN}, cols a "
            f"multiple of 8 and 16-byte aligned rows; got x {x.dtype}, w "
            f"{w.dtype} {tuple(w.shape)}")
    _check_smem(name, k)
    out = torch.empty((n, cols), dtype=r.dtype, device=dev)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_linear_residual_mma",
                       [_p, _p, _p, _c, _p, _c, _p, _c, _c, _c,
                        _u, _u, _f, _f, _p])
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), pt(w), pt(b), cd(b), pt(r), cd(r), pt(out), n, k, cols,
            int(seed) & _M32, int(salt) & _M32, *_drop_args(dropout_p),
            _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def linear_residual_stream_cuda(x, w, b, r, seed: int = 0,
                                dropout_p: float = 0.0,
                                salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 by weight streaming (``csrc/linear_residual_stream.cu``), for the
    calls that :func:`linear_residual_route` sends there; as
    :func:`linear_residual_cuda`.  One launch: each block holds its whole
    chunk of W in flight at once, a cluster sums its depth chunks through
    distributed shared memory, and b, the dropout and r are applied in
    float32 with one rounding to ``r``'s dtype.  Any N whose grid fits
    (:func:`_stream_gemm_grid`): the route adds the bound on
    N."""
    name = "linear_residual_stream"
    dev = _kernels.require_cuda(name, x, w, b, r)
    n, k, cols = _check_linear_residual_shapes(name, x, w, b, r)
    enforce(_stream_weight(w) and max(w.shape) <= _STREAM_MAX_H,
            f"{name}: takes a float32 w with k and cols at most "
            f"{_STREAM_MAX_H}, cols a multiple of 4 and a 16-byte aligned "
            f"start; got {w.dtype} {tuple(w.shape)}")
    out = torch.empty((n, cols), dtype=r.dtype, device=dev)
    if n == 0:
        return out
    grid = _stream_gemm_grid(_kernels.sm_count(dev), n, k, cols)
    enforce(grid is not None,
            f"{name}: no grid fits shared memory at N={n}, k={k}")
    cluster, width, depth = grid
    fn = _kernels.bind(name, "ptt_linear_residual_stream",
                       [_p, _c, _p, _p, _c, _p, _c, _p, _c, _c, _c, _c, _c,
                        _c, _u, _u, _f, _f, _p])
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), pt(b), cd(b), pt(r), cd(r), pt(out), n, k,
            cols, width, depth, cluster, int(seed) & _M32, int(salt) & _M32,
            *_drop_args(dropout_p), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def linear_residual_tiled_cuda(x, w, b, r, seed: int = 0,
                               dropout_p: float = 0.0,
                               salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 by the register-blocked float32 kernel
    (``csrc/linear_residual_tiled.cu``), for the calls that
    :func:`linear_residual_route` sends there; as
    :func:`linear_residual_cuda`.  One launch of the GEMM body of
    ``csrc/tiled.cuh`` with x taken as it is; the depth of a tile is split
    over :func:`_tiled_splits` blocks of a cluster, and b, the dropout and
    r are applied in float32 with one rounding to ``r``'s dtype.  Any N."""
    name = "linear_residual_tiled"
    dev = _kernels.require_cuda(name, x, w, b, r)
    n, k, cols = _check_linear_residual_shapes(name, x, w, b, r)
    enforce(_stream_weight(w) and k % 8 == 0,
            f"{name}: takes a float32 w with k a multiple of 8, cols a "
            f"multiple of 4 and a 16-byte aligned start; got {w.dtype} "
            f"{tuple(w.shape)}")
    smem = _kernels.bind(name, "ptt_linear_residual_tiled_smem", [])()
    enforce(smem == _tiled_raw_smem(),
            f"{name}: {smem} bytes of shared memory a block (the wrapper "
            f"counts {_tiled_raw_smem()})")
    out = torch.empty((n, cols), dtype=r.dtype, device=dev)
    if n == 0:
        return out
    if x.data_ptr() % 16:
        # a view that starts inside its storage: x's rows move in 16-byte
        # copies, so they must start on a 16-byte boundary
        x = x.clone()
    fn = _kernels.bind(name, "ptt_linear_residual_tiled",
                       [_p, _c, _p, _p, _c, _p, _c, _p, _c, _c, _c, _c,
                        _u, _u, _f, _f, _p])
    cluster = _tiled_splits(_kernels.sm_count(dev), n, k, cols)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w), pt(b), cd(b), pt(r), cd(r), pt(out), n, k,
            cols, cluster, int(seed) & _M32, int(salt) & _M32,
            *_drop_args(dropout_p), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def linear_residual_cuda(x, w, b, r, seed: int = 0, dropout_p: float = 0.0,
                         salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 on the card: ``x`` (N, k), ``w`` (k, cols), ``r`` (N, cols);
    returns (N, cols) in ``r``'s dtype, with the hash dropout of ``seed``
    and ``salt`` over the global (row, col) when ``dropout_p > 0``.  The
    kernel is the one :func:`linear_residual_route` names: the tensor-core
    kernel (:func:`linear_residual_mma_cuda`), the weight-streaming one
    (:func:`linear_residual_stream_cuda`), the register-blocked float32 one
    (:func:`linear_residual_tiled_cuda`) or the SIMT float32 one
    (:func:`linear_residual_simt_cuda`)."""
    route = linear_residual_route(x, w)
    if route == "linear_residual_mma":
        return linear_residual_mma_cuda(x, w, b, r, seed, dropout_p, salt)
    if route == "linear_residual_stream":
        return linear_residual_stream_cuda(x, w, b, r, seed, dropout_p, salt)
    if route == "linear_residual_tiled":
        return linear_residual_tiled_cuda(x, w, b, r, seed, dropout_p, salt)
    return linear_residual_simt_cuda(x, w, b, r, seed, dropout_p, salt)


def linear_residual_simt_cuda(x, w, b, r, seed: int = 0,
                              dropout_p: float = 0.0,
                              salt: int = _SALT_RESID) -> torch.Tensor:
    """K2 by the float32 kernel of ``csrc/linear_residual.cu`` (CUDA
    cores), for the calls that :func:`linear_residual_route` sends there
    (and any other it can take); as :func:`linear_residual_cuda`."""
    name = "linear_residual"
    dev = _kernels.require_cuda(name, x, w, b, r)
    n, k, cols = _check_linear_residual_shapes(name, x, w, b, r)
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


def _check_ffn_shapes(name, x, w1, b1, w2, b2, g, beta):
    n, h = x.shape
    enforce(w1.dim() == 2 and w1.shape[0] == h,
            f"{name}: w1 {tuple(w1.shape)} does not take x {tuple(x.shape)}")
    ffn = w1.shape[1]
    enforce(w2.shape == (ffn, h) and b1.shape == (ffn,) and b2.shape == (h,)
            and g.shape == (h,) and beta.shape == (h,),
            f"{name}: parameter shapes disagree with h={h}, ffn={ffn}")
    return n, h, ffn


# K3's tensor-core kernel (csrc/ffn_mma.cu; an instantiation for each of
# _MMA_HIDDEN, 96 accumulator floats a thread at 768): its ffn tile and row
# tile (a cluster of two blocks per 64 rows)
_MMA_FFN_TILE, _MMA_ROWS = 256, 64


# K3's weight-streaming kernel (csrc/ffn_stream.cu): rows a pass, the most
# ffn columns a block (one 4-column quad a warp) and the rows a launch it
# may take (the scratch rule below bounds them)
_STREAM_ROWS, _STREAM_MAX_PER, _STREAM_LAUNCH_ROWS = 8, 32, (16, 8)


def _ffn_stream_scratch_fits(groups: int, rows: int, h: int,
                             ffn: int) -> bool:
    """ffn_stream's float32 (groups, rows, h) scratch stays under 5% of the
    float32 W1 and W2 bytes."""
    return 20 * groups * rows * h * 4 < 2 * h * ffn * 4


def _ffn_stream_takes(w1: torch.Tensor, w2: torch.Tensor, n: int) -> bool:
    """What ``ffn_stream`` can take: float32 ``w1`` (h, ffn) and ``w2``
    (ffn, h) with h at most ``_STREAM_MAX_H``, h and ffn multiples of 4,
    both 16-byte aligned, and a scratch rule that admits one cluster group
    at 8 rows a launch (so a grid exists, :func:`_ffn_stream_grid`)."""
    h, ffn = w1.shape
    return (_stream_weight(w1) and w2.dtype == torch.float32
            and h % 4 == 0 and h <= _STREAM_MAX_H and w2.data_ptr() % 16 == 0
            and _ffn_stream_scratch_fits(1, min(n, _STREAM_ROWS), h, ffn))


def _ffn_tiled_takes(w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """What ``ffn_tiled`` can take: float32 ``w1`` (h, ffn) and ``w2``
    (ffn, h), both 16-byte aligned, h a multiple of 8 (x's rows move in
    16-byte copies) and ffn a multiple of 4 (W1's and the intermediate's
    rows do)."""
    return (_stream_weight(w1) and w2.dtype == torch.float32
            and w1.shape[0] % 8 == 0 and w2.data_ptr() % 16 == 0)


def ffn_route(w1: torch.Tensor, w2: torch.Tensor, n: int) -> str:
    """The K3 kernel a CUDA call of :func:`ffn_cuda` of N=``n`` rows
    launches, decided on the host before any launch from the weights'
    dtypes, shapes and addresses and the row count: ``"ffn_mma"``
    (``csrc/ffn_mma.cu``, bf16 tensor cores) when ``w1`` (h, ffn) and
    ``w2`` (ffn, h) are both bfloat16, h is one of ``_MMA_HIDDEN``, ffn is
    a multiple of 8 (16-byte rows of ``w1``) and both weights start on a
    16-byte boundary; ``"ffn_stream"`` (``csrc/ffn_stream.cu``, float32
    weight streaming) for float32 weights that :func:`_ffn_stream_takes`
    at N at most ``_FFN_STREAM_MAX_ROWS``; ``"ffn_tiled"``
    (``csrc/ffn_tiled.cu``, register-blocked float32) for float32 weights
    that :func:`_ffn_tiled_takes` at any other N; ``"ffn"``
    (``csrc/ffn.cu``, the SIMT float32 kernel) for every other call.
    ``x`` may be float32 or bfloat16 on each."""
    if (_bf16_operand(w1) and w1.shape[0] in _MMA_HIDDEN
            and w2.dtype == torch.bfloat16 and w2.data_ptr() % 16 == 0):
        return "ffn_mma"
    if n <= _FFN_STREAM_MAX_ROWS and _ffn_stream_takes(w1, w2, n):
        return "ffn_stream"
    if _ffn_tiled_takes(w1, w2):
        return "ffn_tiled"
    return "ffn"


def _ffn_mma_groups(device: torch.device, n: int, h: int, ffn: int) -> int:
    """Cluster groups the ffn tiles of a 64-row tile are dealt to: enough
    clusters of two blocks to give every SM one, at most one per ffn tile,
    and ``groups * h < ffn``, so that the float32 (N, h) partials stay
    smaller than the (N, ffn) intermediate.  One at the training and
    prefill shapes; several for a few rows."""
    tiles = -(-ffn // _MMA_FFN_TILE)
    want = _kernels.sm_count(device) // (2 * -(-n // _MMA_ROWS))
    return max(1, min(tiles, want, (ffn - 1) // h))


def _ffn_scratch(dev, groups: int, n: int, h: int, dropout2: float):
    """The float32 (groups, N, h) scratch of K3's partial sums, which both
    K3 kernels take when the ffn tiles are split across several cluster
    groups or when ``dropout2`` is on (the finalize kernel of
    ``csrc/ffn.cu`` then adds the groups, ``b2``, ``dropout2`` and ``x``);
    None otherwise."""
    if groups > 1 or dropout2 > 0.0:
        return torch.empty((groups, n, h), dtype=torch.float32, device=dev)
    return None


def ffn_mma_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
                 activation: str = "gelu", dropout1: float = 0.0,
                 dropout2: float = 0.0,
                 epsilon: float = 1e-5) -> torch.Tensor:
    """K3 on the tensor cores (``csrc/ffn_mma.cu``), for the calls that
    :func:`ffn_route` sends there; as :func:`ffn_cuda`.  With several
    cluster groups (:func:`_ffn_mma_groups`) or with ``dropout2``, the
    kernel stores its float32 sums to the scratch of :func:`_ffn_scratch`
    and the finalize kernel of ``csrc/ffn.cu`` finishes: at the training
    shape a drop2 in this kernel's epilogue ran 5% slower than that round
    trip (PERF.md, findings)."""
    name = "ffn_mma"
    dev = _kernels.require_cuda(name, x, w1, b1, w2, b2, g, beta)
    n, h, ffn = _check_ffn_shapes(name, x, w1, b1, w2, b2, g, beta)
    enforce(ffn_route(w1, w2, n) == name,
            f"{name}: takes bf16 weights with h in {_MMA_HIDDEN}, ffn a "
            f"multiple of 8 and 16-byte aligned rows; got {w1.dtype} "
            f"{tuple(w1.shape)}, {w2.dtype}")
    enforce(activation in ("gelu", "relu"),
            f"{name}: unsupported activation {activation!r}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = _kernels.bind(name, "ptt_ffn_mma",
                       [_p, _c, _p, _p, _c, _p, _p, _c, _p, _c, _p, _c,
                        _p, _p, _c, _c, _c, _f, _c, _c, _u, _u, _f, _f, _p])
    groups = _ffn_mma_groups(dev, n, h, ffn)
    part = _ffn_scratch(dev, groups, n, h, dropout2)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    stream = _kernels.stream(dev)
    rc = fn(pt(x), cd(x), pt(w1), pt(b1), cd(b1), pt(w2), pt(b2), cd(b2),
            pt(g), cd(g), pt(beta), cd(beta),
            None if part is None else pt(part), pt(out), n, h, ffn,
            float(epsilon), 0 if activation == "gelu" else 1, groups,
            int(seed) & _M32, _SALT_FFN1, *_drop_args(dropout1), stream)
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    if part is not None:
        rc = _ffn_finalize()(pt(part), groups, pt(x), cd(x), pt(b2), cd(b2),
                             pt(out), n, h, 0, int(seed) & _M32, _SALT_FFN2,
                             *_drop_args(dropout2), stream)
        _kernels.check(rc, "ffn")
    return out


def _ffn_finalize():
    """``ptt_ffn_finalize`` of ``csrc/ffn.cu``: out = x + dropout2(the
    scratch's groups summed in order + b2), over rows row0 .. of the
    caller's tensor; it finishes ``ffn_mma`` and ``ffn_stream``."""
    return _kernels.bind("ffn", "ptt_ffn_finalize",
                         [_p, _c, _p, _c, _p, _c, _p, _c, _c, _c,
                          _u, _u, _f, _f, _p])


def _ffn_stream_smem(h: int, per: int) -> int:
    """Bytes of dynamic shared memory an ``ffn_stream`` block takes
    (``ptt_ffn_stream_smem``): its W1 columns and W2 rows, LN(x) of 8 rows
    (then their partial) and the activation."""
    return 4 * (h * per + per * h + _STREAM_ROWS * h + per * _STREAM_ROWS)


_ffn_resident: Dict[int, Tuple[Tuple[int, int], ...]] = {}


def _ffn_stream_resident(device: torch.device) -> Tuple[Tuple[int, int],
                                                        ...]:
    """((cluster, clusters), ...): how many thread-block clusters of 1, 2,
    4 and 8 ``ffn_stream`` blocks the card holds at once, one block an SM
    (``cudaOccupancyMaxActiveClusters``; GPCs of uneven size hold fewer
    than SMs / cluster).  Asked once per device."""
    key = device.index
    if key not in _ffn_resident:
        fn = _kernels.bind("ffn_stream", "ptt_ffn_stream_resident",
                           [_c, ctypes.POINTER(_c)])
        held = []
        with torch.cuda.device(device):
            for cluster in (1, 2, 4, _STREAM_MAX_CLUSTER):
                count = _c(0)
                _kernels.check(fn(cluster, ctypes.byref(count)),
                               "ffn_stream")
                held.append((cluster, count.value))
        _ffn_resident[key] = tuple(held)
    return _ffn_resident[key]


@functools.lru_cache(maxsize=None)
def _ffn_stream_grid(resident: Tuple[Tuple[int, int], ...], n: int, h: int,
                     ffn: int) -> Optional[Tuple[int, int, int, int]]:
    """(cluster, groups, per, rows) of ``ffn_stream`` for N=n rows at
    widths (h, ffn), given ``resident`` ((cluster size, clusters the card
    holds at once), ...): ``groups`` clusters of ``cluster`` blocks, each
    block ``per`` ffn columns (a multiple of 4, at most
    ``_STREAM_MAX_PER``, with shared memory that fits), ``rows`` rows a
    launch.  Every ffn column (W1 column, W2 row) lies in exactly one
    block and every cluster has one; the scratch (groups, rows, h) stays
    under 5% of the weights.  Of those grids: the fewest waves of clusters,
    then the most blocks, the most rows a launch, the fewest groups.  None
    when none exists."""
    best = None
    for rows in sorted({min(n, r) for r in _STREAM_LAUNCH_ROWS}):
        for cluster, held in resident:
            groups = 1
            while _ffn_stream_scratch_fits(groups, rows, h, ffn):
                per = 4 * -(-ffn // (4 * cluster * groups))
                blocks = -(-ffn // per)
                if (held > 0 and per <= _STREAM_MAX_PER
                        and -(-blocks // cluster) == groups
                        and _ffn_stream_smem(h, per) <= _SMEM_LIMIT):
                    key = (-(-groups // held), -blocks, -rows, groups)
                    if best is None or key < best[0]:
                        best = (key, (cluster, groups, per, rows))
                groups += 1
    return None if best is None else best[1]


def ffn_stream_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
                    activation: str = "gelu", dropout1: float = 0.0,
                    dropout2: float = 0.0,
                    epsilon: float = 1e-5) -> torch.Tensor:
    """K3 by weight streaming (``csrc/ffn_stream.cu``), for the calls that
    :func:`ffn_route` sends there; as :func:`ffn_cuda`.  Each block holds
    its whole share of W1 and W2 in flight at once; each cluster of the
    grid (:func:`_ffn_stream_grid`) stores one float32 (rows, h) partial
    to a scratch, and the finalize kernel of ``csrc/ffn.cu`` adds the
    groups, ``b2``, ``dropout2`` and ``x``.  N is walked in launches of
    ``rows`` rows (the scratch rule bounds them), each with its finalize.
    Any N that :func:`_ffn_stream_takes`: the route adds the bound on
    N."""
    name = "ffn_stream"
    dev = _kernels.require_cuda(name, x, w1, b1, w2, b2, g, beta)
    n, h, ffn = _check_ffn_shapes(name, x, w1, b1, w2, b2, g, beta)
    enforce(_ffn_stream_takes(w1, w2, n),
            f"{name}: takes float32 weights with h at most {_STREAM_MAX_H}, "
            "h and ffn multiples of 4, 16-byte aligned starts and ffn above "
            f"10 x min(N, 8); got {w1.dtype} {tuple(w1.shape)}, "
            f"{w2.dtype}, N={n}")
    enforce(activation in ("gelu", "relu"),
            f"{name}: unsupported activation {activation!r}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    grid = _ffn_stream_grid(_ffn_stream_resident(dev), n, h, ffn)
    enforce(grid is not None, f"{name}: no grid at N={n}, h={h}, ffn={ffn}")
    cluster, groups, per, rows = grid
    fn = _kernels.bind(name, "ptt_ffn_stream",
                       [_p, _c, _p, _p, _c, _p, _p, _c, _p, _c, _p, _c, _c,
                        _c, _c, _c, _c, _c, _f, _c, _u, _u, _f, _f, _p])
    fin = _ffn_finalize()
    part = torch.empty((groups, rows, h), dtype=torch.float32, device=dev)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    stream = _kernels.stream(dev)
    seed = int(seed) & _M32
    for r0 in range(0, n, rows):
        m = min(rows, n - r0)
        xs, outs = x[r0:r0 + m], out[r0:r0 + m]
        rc = fn(pt(xs), cd(x), pt(w1), pt(b1), cd(b1), pt(w2), pt(g), cd(g),
                pt(beta), cd(beta), pt(part), m, r0, h, ffn, per, cluster,
                groups, float(epsilon), 0 if activation == "gelu" else 1,
                seed, _SALT_FFN1, *_drop_args(dropout1), stream)
        _kernels.check(rc, name)
        _kernels.launches[name] += 1
        rc = fin(pt(part), groups, pt(xs), cd(x), pt(b2), cd(b2), pt(outs),
                 m, h, r0, seed, _SALT_FFN2, *_drop_args(dropout2), stream)
        _kernels.check(rc, "ffn")
    return out


def ffn_tiled_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
                   activation: str = "gelu", dropout1: float = 0.0,
                   dropout2: float = 0.0,
                   epsilon: float = 1e-5) -> torch.Tensor:
    """K3 by the register-blocked float32 kernels (``csrc/ffn_tiled.cu``),
    for the calls that :func:`ffn_route` sends there; as :func:`ffn_cuda`.
    Two launches of the GEMM body of ``csrc/tiled.cuh``, counted as one
    call: the up pass (LN(x) as it stages x, then + b1, the activation and
    ``dropout1``) writes the float32 (N, ffn) intermediate to a scratch
    allocated here; the down pass takes it as its A and adds ``b2``,
    ``dropout2`` and ``x``.  Each pass splits a tile's depth over
    :func:`_tiled_splits` blocks of a cluster.  Any N."""
    name = "ffn_tiled"
    dev = _kernels.require_cuda(name, x, w1, b1, w2, b2, g, beta)
    n, h, ffn = _check_ffn_shapes(name, x, w1, b1, w2, b2, g, beta)
    enforce(_ffn_tiled_takes(w1, w2),
            f"{name}: takes float32 weights with h a multiple of 8, ffn a "
            f"multiple of 4 and 16-byte aligned starts; got {w1.dtype} "
            f"{tuple(w1.shape)}, {w2.dtype}")
    enforce(activation in ("gelu", "relu"),
            f"{name}: unsupported activation {activation!r}")
    smem = _kernels.bind(name, "ptt_ffn_tiled_smem", [_c, _c])
    enforce(smem(h, 0) == _tiled_smem(h) <= _SMEM_LIMIT
            and smem(h, 1) == _tiled_raw_smem(),
            f"{name}: {smem(h, 0)} / {smem(h, 1)} bytes of shared memory a "
            f"block of the up / down pass at h={h} (the wrapper counts "
            f"{_tiled_smem(h)} / {_tiled_raw_smem()})")
    out = torch.empty_like(x)
    if n == 0:
        return out
    if x.data_ptr() % 16:
        # a view that starts inside its storage: x's rows move in 16-byte
        # copies, so they must start on a 16-byte boundary
        x = x.clone()
    fn = _kernels.bind(name, "ptt_ffn_tiled",
                       [_p, _c, _p, _p, _c, _p, _p, _c, _p, _c, _p, _c, _p,
                        _p, _c, _c, _c, _f, _c, _c, _c, _u, _u, _f, _f, _u,
                        _f, _f, _p])
    hbuf = torch.empty((n, ffn), dtype=torch.float32, device=dev)
    sms = _kernels.sm_count(dev)
    cd, pt = _kernels.dtype_code, _kernels.ptr
    rc = fn(pt(x), cd(x), pt(w1), pt(b1), cd(b1), pt(w2), pt(b2), cd(b2),
            pt(g), cd(g), pt(beta), cd(beta), pt(hbuf), pt(out), n, h, ffn,
            float(epsilon), 0 if activation == "gelu" else 1,
            _tiled_splits(sms, n, h, ffn), _tiled_splits(sms, n, ffn, h),
            int(seed) & _M32, _SALT_FFN1, *_drop_args(dropout1), _SALT_FFN2,
            *_drop_args(dropout2), _kernels.stream(dev))
    _kernels.check(rc, name)
    _kernels.launches[name] += 1
    return out


def ffn_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
             activation: str = "gelu", dropout1: float = 0.0,
             dropout2: float = 0.0, epsilon: float = 1e-5) -> torch.Tensor:
    """K3 on the card: ``x`` (N, h), ``w1`` (h, ffn), ``w2`` (ffn, h);
    returns (N, h) in ``x``'s dtype, with the hash dropouts of ``seed``
    (``dropout1`` after the activation, ``dropout2`` after ``+ b2``).  The
    (N, ffn) intermediate stays on chip but on the tiled route, which
    passes it in float32 through a scratch.  The kernel is the one
    :func:`ffn_route` names: the tensor-core kernel (:func:`ffn_mma_cuda`),
    the weight-streaming one (:func:`ffn_stream_cuda`), the register-blocked
    float32 one (:func:`ffn_tiled_cuda`) or the SIMT float32 one
    (:func:`ffn_simt_cuda`)."""
    args = (x, w1, b1, w2, b2, g, beta, seed, activation, dropout1, dropout2,
            epsilon)
    route = ffn_route(w1, w2, x.shape[0])
    if route == "ffn_mma":
        return ffn_mma_cuda(*args)
    if route == "ffn_stream":
        return ffn_stream_cuda(*args)
    if route == "ffn_tiled":
        return ffn_tiled_cuda(*args)
    return ffn_simt_cuda(*args)


def ffn_simt_cuda(x, w1, b1, w2, b2, g, beta, seed: int = 0,
                  activation: str = "gelu", dropout1: float = 0.0,
                  dropout2: float = 0.0,
                  epsilon: float = 1e-5) -> torch.Tensor:
    """K3 by the float32 kernel of ``csrc/ffn.cu`` (CUDA cores), for the
    calls that :func:`ffn_route` sends there (and any other it can take);
    as :func:`ffn_cuda`.  With more than one cluster group per row tile
    (:func:`_ffn_grid`), or with ``dropout2``, each group's float32 (N, h)
    sum goes to a scratch allocated here, smaller than the (N, ffn)
    intermediate, and the finalize kernel adds the groups and applies
    ``dropout2``."""
    name = "ffn"
    dev = _kernels.require_cuda(name, x, w1, b1, w2, b2, g, beta)
    n, h, ffn = _check_ffn_shapes(name, x, w1, b1, w2, b2, g, beta)
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
    part = _ffn_scratch(dev, groups, n, h, dropout2)
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


def _apply_rope(q, k, base: float):
    """GPT-NeoX rope of (b, s, heads, d) q and k from the cached tables, at
    positions 0 .. s-1 of this call, as the JAX package's ``_apply_rope``
    (``paddle_tpu/ops/fused_block.py:527``) rotates them: a decode step of
    :func:`fused_attention_block_kvcache` is rotated as position 0 whatever
    the cache already holds.  That is a defect of the reference, kept here
    so the two packages agree (``ROADMAP.md`` Queue 3)."""
    s, d = q.shape[1], q.shape[-1]
    cos, sin = _rope_tables_on(s, d, float(base), q.device)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


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

    K1 (``fused_ln_linear``), with ``rotary`` the rope of q and k
    (:func:`_apply_rope`, base ``rope_base``), then the flash kernels on
    the card (attention dropout in the kernel; they raise on a head dim
    they have no instantiation for) or :func:`_attention_ref` on the CPU,
    then K2 (``fused_linear_residual``).  One seed serves the block: the
    flash dropout (salted by ``b * heads + h``) and K2's (``_SALT_RESID``),
    as in the JAX package.  ``qkv_w`` is (h, 3h) in head-major column order
    (head0: q|k|v, head1: ...), the GPTAttention layout."""
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
    if rotary:
        q, k = _apply_rope(q, k, rope_base)
    if x.is_cuda or torch.compiler.is_exporting():
        # exported: the flash op, which runs the kernel on the card and
        # its plain version (bottom-right causal, equal here) on the CPU
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
    fused LN -> QKV (K1), with ``rotary`` the rope of q and k at their
    positions within this call (:func:`_apply_rope`), the new k / v written
    at ``used`` (a 0-d int32 tensor), attention over the cache,
    out-projection + residual (K2).
    Inference only.  Returns ``(out, k_buf, v_buf)``; the buffers are
    written in place (the JAX package builds new arrays).

    The two routes of the JAX function are kept apart, as their dtypes
    differ: on the card a single-token step (``s == 1``, ``L % 8 == 0``,
    ``head_dim % 8 == 0``) runs the flash decode kernel, whose output takes
    q's dtype (K1's, the weights'), as on a TPU; every other call runs the
    einsum route of the JAX package's CPU path, whose probabilities and
    output take the cache dtype."""
    b, s, hidden = x.shape
    head_dim = hidden // num_heads
    if scale is None:
        scale = head_dim ** -0.5
    used = torch.as_tensor(used, dtype=torch.int32, device=x.device)
    qkv = fused_ln_linear(x, qkv_w, qkv_b, ln_scale, ln_bias,
                          epsilon=epsilon)
    q, k, v = _split_heads(qkv.reshape(b * s, -1), b, s, num_heads,
                           head_dim)
    if rotary:
        q, k = _apply_rope(q, k, rope_base)
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
