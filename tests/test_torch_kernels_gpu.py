"""The port's CUDA kernels against their plain versions on the card, at small
shapes with ragged edges.  Marked ``gpu``: they skip where no CUDA device is
visible and run on an H100 with

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import _kernels
from paddle_tpu_torch.inference.paged_attention import (
    _paged_decode_split, paged_attention_cuda, paged_attention_reference)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.gpu

EPS = 1e-5
# float32 sums in another order than cuBLAS (no TF32): ~1e-6 apart
F32_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(dev, *shape, dtype=torch.float32, std=1.0, seed=0):
    g = np.random.default_rng(seed + sum(shape))
    a = g.standard_normal(shape, dtype=np.float32) * std
    return torch.from_numpy(a).to(dev).to(dtype)


def _tol(ref, dtype):
    if dtype == torch.float32:
        return F32_TOL
    return float(ref.float().abs().max()) * 2.0 ** -7   # one bf16 ulp


# the SIMT K1 through its own wrapper (a float32 w takes ln_linear_stream
# or ln_linear_tiled through ln_linear_cuda); ragged rows (not a multiple
# of 16) and columns (not a multiple of 64)
@pytest.mark.parametrize("n,h,cols", [(8, 128, 384), (37, 96, 200)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ln_linear(dev, n, h, cols, xdtype):
    x = _t(dev, n, h, dtype=xdtype)
    w, b = _t(dev, h, cols, std=0.05), _t(dev, cols, std=0.05)
    g, beta = 1 + _t(dev, h, std=0.1), _t(dev, h, std=0.1)
    before = _kernels.launches["ln_linear"]
    out = fb.ln_linear_simt_cuda(x, w, b, g, beta, EPS)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert _kernels.launches["ln_linear"] == before + 1
    assert out.dtype == ref.dtype == torch.float32
    assert float((out - ref).abs().max()) <= F32_TOL


@pytest.mark.parametrize("n,k,cols", [(8, 128, 128), (37, 96, 200)])
@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16])
def test_linear_residual(dev, n, k, cols, rdtype):
    x, w, b = _t(dev, n, k), _t(dev, k, cols, std=0.05), _t(dev, cols)
    r = _t(dev, n, cols, dtype=rdtype, seed=1)
    out = fb.linear_residual_simt_cuda(x, w, b, r)
    ref = fb.linear_residual_reference(x, w, b, r)
    assert out.dtype == rdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)


# the SIMT kernel, through its own wrapper (the route sends float32 weights
# at few rows to the stream kernel); one cluster group per row tile (the
# result stored by the cluster) and, at ffn = 2200, two groups (partials
# summed by the finalize kernel)
@pytest.mark.parametrize("n,h,ffn", [(8, 128, 512), (37, 96, 200),
                                     (37, 96, 2200)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_ffn(dev, n, h, ffn, xdtype, activation):
    groups, cluster = fb._ffn_grid(dev, n, h, ffn)
    assert groups * h < ffn and cluster > 1
    assert groups > 1 if ffn == 2200 else groups == 1
    x = _t(dev, n, h, dtype=xdtype)
    w1, b1 = _t(dev, h, ffn, std=0.05), _t(dev, ffn, std=0.05)
    w2, b2 = _t(dev, ffn, h, std=0.05), _t(dev, h, std=0.05)
    g, beta = 1 + _t(dev, h, std=0.1), _t(dev, h, std=0.1)
    out = fb.ffn_simt_cuda(x, w1, b1, w2, b2, g, beta,
                           activation=activation, epsilon=EPS)
    ref = fb.ffn_reference(x, w1, b1, w2, b2, g, beta,
                           activation=activation, epsilon=EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)


# paged decode: table widths that give 1 split (4 entries of 16), 2 splits
# (8), splits that do not divide the width (13 = 5 + 5 + 3) and the serving
# width (64 = 4 x 16); lengths one before, at and one after every split
# edge, 0, 1 and the full width
PAGED_WIDTHS = (4, 8, 13, 64)
PAGED_BS = 16


def _paged_split_edges(width):
    """The paged-decode kernel's split of a ``width``-entry table and the
    lengths one before, at and one after the first position of every block
    but the first."""
    splits, per = _paged_decode_split(width, PAGED_BS)
    return splits, {b * per * PAGED_BS + o for b in range(1, splits)
                    for o in (-1, 0, 1)}


def _paged_lens(width):
    return sorted({0, 1, 17, width * PAGED_BS, *_paged_split_edges(width)[1]})


def _paged_inputs(dev, width, d, qdtype, page_dtype, h=3):
    """One row per length of ``_paged_lens(width)`` (the last at the full
    width) plus a row that shares the full-width row's blocks up to half
    its length, as a shared prompt prefix does; the tables are otherwise a
    permutation of the blocks, so no other rows share one."""
    lens = _paged_lens(width)
    b = len(lens) + 1
    nb = b * width
    q = _t(dev, b, h, d, dtype=qdtype)
    kp = _t(dev, nb * PAGED_BS + 1, h, d, dtype=page_dtype, seed=1)
    vp = _t(dev, nb * PAGED_BS + 1, h, d, dtype=page_dtype, seed=2)
    perm = np.random.default_rng(3).permutation(nb).reshape(b, width)
    perm[-1] = perm[-2]
    tables = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lens = torch.tensor([*lens, width * PAGED_BS // 2 + 3], dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("width", PAGED_WIDTHS)
@pytest.mark.parametrize("qdtype,page_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode(dev, width, qdtype, page_dtype, d):
    q, kp, vp, tables, lens = _paged_inputs(dev, width, d, qdtype,
                                            page_dtype)
    before = _kernels.launches["paged_decode"]
    out = paged_attention_cuda(q, kp, vp, tables, lens, PAGED_BS)
    ref = paged_attention_reference(q, kp, vp, tables, lens, PAGED_BS)
    assert _kernels.launches["paged_decode"] == before + 1
    assert out.dtype == qdtype and out.shape == q.shape
    # the kernel rounds p to the page dtype before PV (2^-9 relative for
    # bf16); float32 pages differ by summation order only; a bf16 output is
    # rounded once more on each side (one bf16 unit, 2^-7 relative)
    tol = 1e-5 if page_dtype == torch.float32 else \
        float(vp.float().abs().max()) * 2.0 ** -8
    if qdtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    assert bool(((out.float() - ref.float()).abs() <= tol).all())
    assert float(out[0].abs().max()) == 0.0            # length 0


def test_paged_decode_lens_cover_the_split_edges(dev):
    # the split follows the table width and the block size alone
    assert _paged_decode_split(64, 16) == (4, 16)
    assert _paged_decode_split(4, 16) == (1, 4)
    assert _paged_decode_split(13, 16) == (3, 5)
    assert _paged_decode_split(8, 16) == (2, 4)
    splits, edges = _paged_split_edges(64)
    assert splits == 4 and edges == {255, 256, 257, 511, 512, 513, 767, 768,
                                     769}
    assert edges <= set(_paged_lens(64)) and 1024 in _paged_lens(64)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_paged_decode_repeats_exactly(dev, qdtype):
    """No atomics and a fixed combine order: two launches, and two replays
    of one captured launch, give the same bits."""
    q, kp, vp, tables, lens = _paged_inputs(dev, 64, 64, qdtype,
                                            torch.bfloat16)
    a = paged_attention_cuda(q, kp, vp, tables, lens, PAGED_BS)
    b = paged_attention_cuda(q, kp, vp, tables, lens, PAGED_BS)
    torch.cuda.synchronize()
    graph, holder = torch.cuda.CUDAGraph(), {}
    recorded = _kernels.capture(graph, lambda: holder.update(
        out=paged_attention_cuda(q, kp, vp, tables, lens, PAGED_BS)))
    assert recorded == {"paged_decode": 1}
    _kernels.replay(graph, recorded)
    first = holder["out"].clone()
    _kernels.replay(graph, recorded)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(first, holder["out"]) and torch.equal(first, a)


def test_paged_decode_refuses_unaligned_head_dims(dev):
    q, kp, vp, tables, lens = _paged_inputs(dev, 4, 32, torch.float32,
                                            torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_cuda(q[..., :20].contiguous(),
                             kp[..., :20].contiguous(),
                             vp[..., :20].contiguous(), tables, lens,
                             PAGED_BS)


# The SIMT K2 / K3's hash dropout: decode rows, a prefill bucket and the
# generate prefill's rows; at h = 768, ffn = 3072 K3 takes several cluster
# groups at N=8 and one from 512.  dropout2 is applied by the finalize
# kernel, which every shape takes when it is on; with dropout2 0 one group
# stores its output at the cluster's exit (dropout1 alone covers that
# exit)
DROP_ROWS = (8, 512, 4096)
# a residual this small next to the addend (|y| ~ 0.1-1) never absorbs a
# kept value, and a dropped one leaves it bit for bit: the elements equal
# to it are the dropped ones.  K3's LN is scale-free, given an epsilon below
# the tiny rows' variance (~2^-80)
TINY, TINY_EPS = 2.0 ** -40, 1e-30


def _dropped(out, base):
    return (out == base).cpu()


@pytest.mark.parametrize("n", DROP_ROWS)
@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16])
def test_linear_residual_dropout(dev, n, rdtype):
    h = 768
    x, w, b = _t(dev, n, h), _t(dev, h, h, std=0.02), _t(dev, h, std=0.02)
    r = _t(dev, n, h, dtype=rdtype, seed=1)
    args = (77, 0.1, fb._SALT_RESID)
    out = fb.linear_residual_simt_cuda(x, w, b, r, *args)
    ref = fb.linear_residual_reference(x, w, b, r, *args)
    assert out.dtype == rdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)
    tiny = (r.float() * TINY).to(rdtype)
    got = fb.linear_residual_simt_cuda(x, w, b, tiny, *args)
    want = fb.linear_residual_reference(x, w, b, tiny, *args)
    keep = fb._keep_mask(77, fb._SALT_RESID, torch.arange(n)[:, None],
                         torch.arange(h)[None, :], 0.1)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)
    # dropout 0 is the kernel of the serving path, unchanged
    assert torch.equal(fb.linear_residual_simt_cuda(x, w, b, r, 77, 0.0),
                       fb.linear_residual_simt_cuda(x, w, b, r))


@pytest.mark.parametrize("n", DROP_ROWS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drops", [(0.0, 0.1), (0.2, 0.4), (0.3, 0.0)])
def test_ffn_dropout(dev, n, xdtype, drops):
    h, ffn = 768, 3072
    groups, _ = fb._ffn_grid(dev, n, h, ffn)
    assert groups > 1 if n == 8 else groups == 1
    x = _t(dev, n, h, dtype=xdtype)
    w1, b1 = _t(dev, h, ffn, std=0.02), _t(dev, ffn, std=0.02)
    w2, b2 = _t(dev, ffn, h, std=0.02), _t(dev, h, std=0.02)
    g, beta = 1 + _t(dev, h, std=0.1), _t(dev, h, std=0.1)
    d1, d2 = drops
    out = fb.ffn_simt_cuda(x, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                           EPS)
    ref = fb.ffn_reference(x, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                           EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)
    if d2 == 0.0:
        return
    tiny = (x.float() * TINY).to(xdtype)
    got = fb.ffn_simt_cuda(tiny, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                           TINY_EPS)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                            TINY_EPS)
    keep = fb._keep_mask(5, fb._SALT_FFN2, torch.arange(n)[:, None],
                         torch.arange(h)[None, :], d2)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)


# K3's tensor-core route (csrc/ffn_mma.cu): bf16 W1 / W2, h in
# fb._MMA_HIDDEN.  Rows: one, a few (several cluster groups), ragged edges
# of the 64-row tile, a prefill's rows.  The plain version rounds each
# product to bf16 where torch's bf16 matmul returns bf16, the kernel keeps
# float32 sums as the TPU kernel does: one bf16 unit of the range, for x in
# float32 too.  The residual x (std 1) sets that range; so each case also
# runs with a residual of 2^-40 (LN is scale-free), where the output is the
# FFN's own contribution, held within one bf16 unit of its range
MMA_ROWS = (1, 8, 37, 300, 4096)


def _bf16_tol(ref):
    return _tol(ref, torch.bfloat16)


def _mma_params(dev, h, ffn, std=0.02):
    w1 = _t(dev, h, ffn, dtype=torch.bfloat16, std=std)
    w2 = _t(dev, ffn, h, dtype=torch.bfloat16, std=std, seed=1)
    b1, b2 = _t(dev, ffn, std=0.02), _t(dev, h, std=0.02, seed=2)
    g, beta = 1 + _t(dev, h, std=0.1, seed=3), _t(dev, h, std=0.1, seed=4)
    return w1, b1, w2, b2, g, beta


def _ffn_addend(x, params, *args):
    """K3's kernel and plain outputs with a residual of 2^-40 of ``x``:
    the FFN's own contribution, rounded to x's dtype."""
    tiny = (x.float() * TINY).to(x.dtype)
    got = fb.ffn_cuda(tiny, *params, *args, TINY_EPS)
    want = fb.ffn_reference(tiny, *params, *args, TINY_EPS)
    return tiny, got, want


@pytest.mark.parametrize("n", MMA_ROWS)
@pytest.mark.parametrize("h", [128, 768])
@pytest.mark.parametrize("ffn", [512, 3072])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_ffn_mma(dev, n, h, ffn, xdtype, activation):
    x = _t(dev, n, h, dtype=xdtype, seed=5)
    params = _mma_params(dev, h, ffn)
    assert fb.ffn_route(params[0], params[2], n) == "ffn_mma"
    before = dict(_kernels.launches)
    out = fb.ffn_cuda(x, *params, activation=activation, epsilon=EPS)
    assert _kernels.launches["ffn_mma"] == before["ffn_mma"] + 1
    assert _kernels.launches["ffn"] == before["ffn"]
    ref = fb.ffn_reference(x, *params, activation=activation, epsilon=EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)
    _, got, want = _ffn_addend(x, params, 0, activation, 0.0, 0.0)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("n", MMA_ROWS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drops", [(0.0, 0.1), (0.2, 0.4), (0.3, 0.0)])
def test_ffn_mma_dropout(dev, n, xdtype, drops):
    # dropout2 in the finalize kernel (one cluster group, or several up to
    # 300 rows): values within one bf16 unit, the FFN's own contribution
    # too; with a residual of 2^-40 the dropped elements are exactly the
    # hash mask's
    h, ffn = 768, 3072
    groups = fb._ffn_mma_groups(dev, n, h, ffn)
    assert groups > 1 if n <= 300 else groups == 1
    x = _t(dev, n, h, dtype=xdtype, seed=6)
    params = _mma_params(dev, h, ffn)
    d1, d2 = drops
    before = _kernels.launches["ffn_mma"]
    out = fb.ffn_cuda(x, *params, 5, "gelu", d1, d2, EPS)
    assert _kernels.launches["ffn_mma"] == before + 1
    ref = fb.ffn_reference(x, *params, 5, "gelu", d1, d2, EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)
    tiny, got, want = _ffn_addend(x, params, 5, "gelu", d1, d2)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)
    if d2 == 0.0:
        return
    keep = fb._keep_mask(5, fb._SALT_FFN2, torch.arange(n)[:, None],
                         torch.arange(h)[None, :], d2)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)


@pytest.mark.parametrize("n", [8, 4096])
def test_ffn_mma_addend_check_rejects_b1_left_out(dev, n):
    # the check above sees a fault of the FFN's size: K3 without b1 (std
    # 0.02, about 0.01 at the output) lies outside one bf16 unit of the
    # FFN's range
    x = _t(dev, n, 768, dtype=torch.bfloat16, seed=10)
    w1, b1, w2, b2, g, beta = _mma_params(dev, 768, 3072)
    tiny, _, want = _ffn_addend(x, (w1, b1, w2, b2, g, beta), 0, "gelu",
                                0.0, 0.1)
    bad = fb.ffn_cuda(tiny, w1, torch.zeros_like(b1), w2, b2, g, beta, 0,
                      "gelu", 0.0, 0.1, TINY_EPS)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)


@pytest.mark.parametrize("n", [8, 300, 4096])
@pytest.mark.parametrize("h,ffn", [(768, 3072), (128, 128), (128, 200)])
def test_ffn_mma_dropout1_mask(dev, n, h, ffn):
    # W2 = the (ffn, h) identity and b2 = 0 make the output x + the
    # activation of ffn columns below h: with a residual of 2^-40 the
    # elements equal to it are exactly drop1's dropped ones (gelu is 0 only
    # at 0).  ffn = 128 and 200 leave a block's half of the 256-column ffn
    # tile empty or ragged: zero-filled W1 columns and W2 rows
    w1, b1, _, _, g, beta = _mma_params(dev, h, ffn)
    w2 = torch.eye(ffn, h, dtype=torch.bfloat16, device=dev)
    b2 = torch.zeros(h, device=dev)
    tiny = (_t(dev, n, h, seed=7) * TINY).to(torch.bfloat16)
    got = fb.ffn_cuda(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3, 0.0,
                      TINY_EPS)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3,
                            0.0, TINY_EPS)
    cols = min(h, ffn)
    keep = fb._keep_mask(21, fb._SALT_FFN1, torch.arange(n)[:, None],
                         torch.arange(cols)[None, :], 0.3)
    assert torch.equal(_dropped(got, tiny)[:, :cols], ~keep)
    assert torch.equal(_dropped(want, tiny)[:, :cols], ~keep)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("n,d2", [(8, 0.1), (300, 0.0), (4096, 0.1)])
def test_ffn_mma_repeats_exactly(dev, n, d2):
    x = _t(dev, n, 768, dtype=torch.bfloat16, seed=8)
    params = _mma_params(dev, 768, 3072)
    runs = [fb.ffn_cuda(x, *params, 9, "gelu", 0.1, d2, EPS)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("wdtype,h,ffn", [
    (torch.float32, 100, 400),        # float32, h not a multiple of 8
    (torch.bfloat16, 96, 200),        # h without an instantiation
    (torch.bfloat16, 128, 100)])      # ffn rows of w1 not 16-byte aligned
def test_ffn_route_keeps_the_simt_kernel(dev, wdtype, h, ffn):
    # rows above the stream kernels' bound (below it float32 weights take
    # ffn_stream; above it ffn_tiled, where h % 8 == 0)
    n = fb._FFN_STREAM_MAX_ROWS + 1
    x = _t(dev, n, h, dtype=torch.bfloat16, seed=9)
    w1, b1, w2, b2, g, beta = _mma_params(dev, h, ffn)
    w1, w2 = w1.to(wdtype), w2.to(wdtype)
    assert fb.ffn_route(w1, w2, n) == "ffn"
    before = dict(_kernels.launches)
    out = fb.ffn_cuda(x, w1, b1, w2, b2, g, beta, epsilon=EPS)
    assert _kernels.launches["ffn"] == before["ffn"] + 1
    assert _kernels.launches["ffn_mma"] == before["ffn_mma"]
    ref = fb.ffn_reference(x, w1, b1, w2, b2, g, beta, epsilon=EPS)
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)


def test_ffn_mma_refuses_what_it_cannot_take(dev):
    x = _t(dev, 8, 96, dtype=torch.bfloat16)
    w1, b1, w2, b2, g, beta = _mma_params(dev, 96, 256)
    with pytest.raises(ValueError, match="ffn_mma: takes bf16 weights"):
        fb.ffn_mma_cuda(x, w1, b1, w2, b2, g, beta)


# K1's and K2's tensor-core routes (csrc/ln_linear_mma.cu,
# csrc/linear_residual_mma.cu): bf16 W (K2: and x), h in fb._MMA_HIDDEN.
# Rows as for ffn_mma; columns: a whole number of tiles (K1: 3h, the QKV
# projection, in tiles of 256; K2: h, in tiles of 128), a ragged last tile
# (200) and a single chunk (8).  The plain versions round the bf16 product
# before + b where the kernels keep float32 sums, as the TPU kernels do:
# one bf16 unit of the range.
LINEAR_SHAPES = [(128, 384), (768, 2304), (768, 200), (128, 8)]


def _ln_linear_params(dev, h, cols):
    w = _t(dev, h, cols, dtype=torch.bfloat16, std=0.02, seed=11)
    b = _t(dev, cols, std=0.02, seed=12)
    g, beta = 1 + _t(dev, h, std=0.1, seed=13), _t(dev, h, std=0.1, seed=14)
    return w, b, g, beta


@pytest.mark.parametrize("n", MMA_ROWS)
@pytest.mark.parametrize("h,cols", LINEAR_SHAPES)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ln_linear_mma(dev, n, h, cols, xdtype):
    x = _t(dev, n, h, dtype=xdtype, seed=15)
    w, b, g, beta = _ln_linear_params(dev, h, cols)
    assert fb.ln_linear_route(w, n) == "ln_linear_mma"
    before = dict(_kernels.launches)
    out = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    assert _kernels.launches["ln_linear_mma"] == before["ln_linear_mma"] + 1
    assert _kernels.launches["ln_linear"] == before["ln_linear"]
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert out.shape == (n, cols)
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)


def test_ln_linear_mma_rejects_b_left_out(dev):
    # the check above sees a fault of the bias's size (std 0.02 against an
    # output of ~0.5): K1 without b lies outside one bf16 unit of the range
    x = _t(dev, 300, 768, dtype=torch.bfloat16, seed=16)
    w, b, g, beta = _ln_linear_params(dev, 768, 2304)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    bad = fb.ln_linear_mma_cuda(x, w, torch.zeros_like(b), g, beta, EPS)
    assert float((bad.float() - ref.float()).abs().max()) > _bf16_tol(ref)


def _linear_residual_inputs(dev, n, k, cols, rdtype):
    x = _t(dev, n, k, dtype=torch.bfloat16, seed=17)
    w = _t(dev, k, cols, dtype=torch.bfloat16, std=0.02, seed=18)
    b = _t(dev, cols, std=0.02, seed=19)
    r = _t(dev, n, cols, dtype=rdtype, seed=20)
    return x, w, b, r


def _linear_residual_addend(x, w, b, r, *args):
    """K2's kernel and plain outputs with a residual of 2^-40 of ``r``: the
    projection's own contribution, rounded to r's dtype."""
    tiny = (r.float() * TINY).to(r.dtype)
    return (tiny, fb.linear_residual_cuda(x, w, b, tiny, *args),
            fb.linear_residual_reference(x, w, b, tiny, *args))


@pytest.mark.parametrize("n", MMA_ROWS)
@pytest.mark.parametrize("k,cols", [(128, 128), (768, 768), (768, 200),
                                    (128, 8)])
@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16])
def test_linear_residual_mma(dev, n, k, cols, rdtype):
    x, w, b, r = _linear_residual_inputs(dev, n, k, cols, rdtype)
    assert fb.linear_residual_route(x, w) == "linear_residual_mma"
    before = dict(_kernels.launches)
    out = fb.linear_residual_cuda(x, w, b, r)
    assert (_kernels.launches["linear_residual_mma"]
            == before["linear_residual_mma"] + 1)
    assert _kernels.launches["linear_residual"] == before["linear_residual"]
    ref = fb.linear_residual_reference(x, w, b, r)
    assert out.dtype == rdtype and out.shape == (n, cols)
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)
    _, got, want = _linear_residual_addend(x, w, b, r)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("n", MMA_ROWS)
@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16])
def test_linear_residual_mma_dropout(dev, n, rdtype):
    # p = 0.1 as fused training drops: values and the projection's own
    # contribution within one bf16 unit; with a residual of 2^-40 the
    # dropped elements are exactly the hash mask's
    x, w, b, r = _linear_residual_inputs(dev, n, 768, 768, rdtype)
    args = (77, 0.1, fb._SALT_RESID)
    before = _kernels.launches["linear_residual_mma"]
    out = fb.linear_residual_cuda(x, w, b, r, *args)
    assert _kernels.launches["linear_residual_mma"] == before + 1
    ref = fb.linear_residual_reference(x, w, b, r, *args)
    assert out.dtype == rdtype
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)
    tiny, got, want = _linear_residual_addend(x, w, b, r, *args)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)
    keep = fb._keep_mask(77, fb._SALT_RESID, torch.arange(n)[:, None],
                         torch.arange(768)[None, :], 0.1)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)
    # p = 0 takes the instantiation without dropout, as no seed does
    assert torch.equal(fb.linear_residual_cuda(x, w, b, r, 77, 0.0),
                       fb.linear_residual_cuda(x, w, b, r))


@pytest.mark.parametrize("n", [8, 4096])
def test_linear_residual_mma_addend_check_rejects_b_left_out(dev, n):
    x, w, b, r = _linear_residual_inputs(dev, n, 768, 768, torch.bfloat16)
    args = (3, 0.1, fb._SALT_RESID)
    tiny, _, want = _linear_residual_addend(x, w, b, r, *args)
    bad = fb.linear_residual_cuda(x, w, torch.zeros_like(b), tiny, *args)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)


@pytest.mark.parametrize("n", [8, 300, 4096])
def test_ln_linear_and_linear_residual_mma_repeat_exactly(dev, n):
    x = _t(dev, n, 768, dtype=torch.bfloat16, seed=21)
    w, b, g, beta = _ln_linear_params(dev, 768, 2304)
    k1 = [fb.ln_linear_cuda(x, w, b, g, beta, EPS) for _ in range(2)]
    xa, wo, bo, r = _linear_residual_inputs(dev, n, 768, 768, torch.bfloat16)
    k2 = [fb.linear_residual_cuda(xa, wo, bo, r, 9, 0.1) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k1[0], k1[1]) and torch.equal(k2[0], k2[1])


@pytest.mark.parametrize("case", ["float32", "bf16-h96", "bf16-misaligned"])
def test_ln_linear_route_keeps_the_simt_kernel(dev, case):
    h, cols = (96, 288) if case == "bf16-h96" else (128, 384)
    w, b, g, beta = _ln_linear_params(dev, h, cols)
    if case == "float32":                 # starts 4 bytes into its buffer
        w = torch.empty(h * cols + 1, device=dev)[1:].view(h, cols).copy_(w)
    elif case == "bf16-misaligned":       # starts 2 bytes into its buffer
        w = torch.empty(h * cols + 1, dtype=torch.bfloat16,
                        device=dev)[1:].view(h, cols).copy_(w)
    assert fb.ln_linear_route(w, 37) == "ln_linear"
    x = _t(dev, 37, h, dtype=torch.bfloat16, seed=22)
    before = dict(_kernels.launches)
    out = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    assert _kernels.launches["ln_linear"] == before["ln_linear"] + 1
    assert _kernels.launches["ln_linear_mma"] == before["ln_linear_mma"]
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref,
                                                                  w.dtype)


@pytest.mark.parametrize("xdtype,wdtype,k", [
    (torch.float32, torch.float32, 100),      # float32, k % 8 != 0
    (torch.float32, torch.bfloat16, 768),     # x not bf16
    (torch.bfloat16, torch.float32, 100),
    (torch.bfloat16, torch.bfloat16, 96)])    # k without an instantiation
def test_linear_residual_route_keeps_the_simt_kernel(dev, xdtype, wdtype, k):
    # rows above the stream kernels' bound (below it a float32 w takes
    # linear_residual_stream; above it linear_residual_tiled, where k % 8
    # == 0)
    x, w, b, r = _linear_residual_inputs(dev, fb._RESID_STREAM_MAX_ROWS + 1,
                                         k, k, torch.bfloat16)
    x, w = x.to(xdtype), w.to(wdtype)
    assert fb.linear_residual_route(x, w) == "linear_residual"
    before = dict(_kernels.launches)
    out = fb.linear_residual_cuda(x, w, b, r)
    assert _kernels.launches["linear_residual"] == before["linear_residual"] + 1
    assert (_kernels.launches["linear_residual_mma"]
            == before["linear_residual_mma"])
    ref = fb.linear_residual_reference(x, w, b, r)
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)


def test_ln_linear_and_linear_residual_mma_refuse_what_they_cannot_take(dev):
    x = _t(dev, 8, 96, dtype=torch.bfloat16)
    w, b, g, beta = _ln_linear_params(dev, 96, 288)
    with pytest.raises(ValueError, match="ln_linear_mma: takes a bf16 w"):
        fb.ln_linear_mma_cuda(x, w, b, g, beta, EPS)
    xa, wo, bo, r = _linear_residual_inputs(dev, 8, 768, 768, torch.bfloat16)
    with pytest.raises(ValueError, match="linear_residual_mma: takes bf16"):
        fb.linear_residual_mma_cuda(xa.float(), wo, bo, r)
    with pytest.raises(ValueError, match="linear_residual_mma: takes bf16"):
        fb.linear_residual_mma_cuda(xa, wo[:, :100].contiguous(), bo[:100],
                                    r[:, :100].contiguous())


# The weight-streaming K3 and K2 (csrc/ffn_stream.cu,
# csrc/linear_residual_stream.cu): float32 weights at a few rows, GPT-125M's
# widths and a ragged small one.  Rows: one, a few, the decode rows, 17 (a
# second launch of K3 and a ragged 8-row pass), the route's bound and 64
# (4 launches of K3); the wrappers take each, the route those up to the
# bound.  Values within float32 sums (a float32 output) or one bf16 unit
# (a bf16 one), with and without dropout; with a residual of 2^-40 the
# addend alone within the same tolerance of its own range and its dropped
# elements exactly the hash mask's
STREAM_ROWS = sorted({1, 3, 8, 17, fb._FFN_STREAM_MAX_ROWS,
                      fb._RESID_STREAM_MAX_ROWS, 64})
STREAM_WIDTHS = [(768, 3072), (96, 200)]


def _stream_params(dev, h, ffn):
    return (_t(dev, h, ffn, std=0.02, seed=31), _t(dev, ffn, std=0.02,
                                                   seed=32),
            _t(dev, ffn, h, std=0.02, seed=33), _t(dev, h, std=0.02, seed=34),
            1 + _t(dev, h, std=0.1, seed=35), _t(dev, h, std=0.1, seed=36))


def _stream_launches(dev, name, n, h, ffn):
    """Launches of one ``name`` call at N=n: ffn_stream walks N in launches
    of its grid's rows."""
    if name == "linear_residual_stream":
        return 1
    rows = fb._ffn_stream_grid(fb._ffn_stream_resident(dev), n, h, ffn)[3]
    return -(-n // rows)


@pytest.mark.parametrize("n", STREAM_ROWS)
@pytest.mark.parametrize("h,ffn", STREAM_WIDTHS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drops", [(0.0, 0.0), (0.2, 0.1)])
def test_ffn_stream(dev, n, h, ffn, xdtype, drops):
    x = _t(dev, n, h, dtype=xdtype, seed=37)
    params = _stream_params(dev, h, ffn)
    assert (fb.ffn_route(params[0], params[2], n) == "ffn_stream") == (
        n <= fb._FFN_STREAM_MAX_ROWS)
    before = dict(_kernels.launches)
    out = fb.ffn_stream_cuda(x, *params, 5, "gelu", *drops, EPS)
    assert _kernels.launches["ffn_stream"] == (
        before["ffn_stream"] + _stream_launches(dev, "ffn_stream", n, h, ffn))
    assert all(_kernels.launches[k] == before[k] for k in ("ffn", "ffn_mma"))
    ref = fb.ffn_reference(x, *params, 5, "gelu", *drops, EPS)
    assert out.dtype == xdtype and out.shape == (n, h)
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)
    tiny = (x.float() * TINY).to(xdtype)
    got = fb.ffn_stream_cuda(tiny, *params, 5, "gelu", *drops, TINY_EPS)
    want = fb.ffn_reference(tiny, *params, 5, "gelu", *drops, TINY_EPS)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   xdtype)
    if drops[1] > 0.0:
        keep = fb._keep_mask(5, fb._SALT_FFN2, torch.arange(n)[:, None],
                             torch.arange(h)[None, :], drops[1])
        assert torch.equal(_dropped(got, tiny), ~keep)
        assert torch.equal(_dropped(want, tiny), ~keep)


@pytest.mark.parametrize("n", STREAM_ROWS)
@pytest.mark.parametrize("h,ffn", [(768, 3072), (128, 128), (128, 200)])
def test_ffn_stream_dropout1_mask(dev, n, h, ffn):
    # W2 = the (ffn, h) identity and b2 = 0: the output is x + the
    # activation of the ffn columns below h, so with a residual of 2^-40 the
    # elements equal to it are exactly drop1's dropped ones, over the global
    # (row, ffn column) in every block's slice and launch
    w1, b1, _, _, g, beta = _stream_params(dev, h, ffn)
    w2 = torch.eye(ffn, h, device=dev)
    b2 = torch.zeros(h, device=dev)
    tiny = (_t(dev, n, h, seed=38) * TINY).to(torch.bfloat16)
    got = fb.ffn_stream_cuda(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3,
                             0.0, TINY_EPS)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3,
                            0.0, TINY_EPS)
    cols = min(h, ffn)
    keep = fb._keep_mask(21, fb._SALT_FFN1, torch.arange(n)[:, None],
                         torch.arange(cols)[None, :], 0.3)
    assert torch.equal(_dropped(got, tiny)[:, :cols], ~keep)
    assert torch.equal(_dropped(want, tiny)[:, :cols], ~keep)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("n", STREAM_ROWS)
@pytest.mark.parametrize("k,cols", [(768, 768), (96, 200), (128, 20)])
@pytest.mark.parametrize("xdtype,rdtype", [
    (torch.float32, torch.bfloat16),          # serving and generate
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_linear_residual_stream(dev, n, k, cols, xdtype, rdtype, p):
    x = _t(dev, n, k, dtype=xdtype, seed=39)
    w, b = _t(dev, k, cols, std=0.02, seed=40), _t(dev, cols, std=0.02,
                                                   seed=41)
    r = _t(dev, n, cols, dtype=rdtype, seed=42)
    assert (fb.linear_residual_route(x, w) == "linear_residual_stream") == (
        n <= fb._RESID_STREAM_MAX_ROWS)
    args = (77, p, fb._SALT_RESID)
    before = dict(_kernels.launches)
    out = fb.linear_residual_stream_cuda(x, w, b, r, *args)
    assert (_kernels.launches["linear_residual_stream"]
            == before["linear_residual_stream"] + 1)
    assert all(_kernels.launches[q] == before[q]
               for q in ("linear_residual", "linear_residual_mma"))
    ref = fb.linear_residual_reference(x, w, b, r, *args)
    assert out.dtype == rdtype and out.shape == (n, cols)
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)
    tiny = (r.float() * TINY).to(rdtype)
    got = fb.linear_residual_stream_cuda(x, w, b, tiny, *args)
    want = fb.linear_residual_reference(x, w, b, tiny, *args)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   rdtype)
    if p > 0.0:
        keep = fb._keep_mask(77, fb._SALT_RESID, torch.arange(n)[:, None],
                             torch.arange(cols)[None, :], p)
        assert torch.equal(_dropped(got, tiny), ~keep)
        assert torch.equal(_dropped(want, tiny), ~keep)


@pytest.mark.parametrize("n", [8, 64])
def test_stream_addend_checks_reject_a_bias_left_out(dev, n):
    # the addend checks above see a fault of the bias's size: K3 without b1
    # and K2 without b lie outside one bf16 unit of the addend's range
    h, ffn = 768, 3072
    w1, b1, w2, b2, g, beta = _stream_params(dev, h, ffn)
    tiny = (_t(dev, n, h, seed=43) * TINY).to(torch.bfloat16)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 3, "gelu", 0.0,
                            0.1, TINY_EPS)
    bad = fb.ffn_stream_cuda(tiny, w1, torch.zeros_like(b1), w2, b2, g, beta,
                             3, "gelu", 0.0, 0.1, TINY_EPS)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)
    x, w = _t(dev, n, h, seed=44), _t(dev, h, h, std=0.02, seed=45)
    b = _t(dev, h, std=0.02, seed=46)
    want = fb.linear_residual_reference(x, w, b, tiny, 3, 0.1)
    bad = fb.linear_residual_stream_cuda(x, w, torch.zeros_like(b), tiny, 3,
                                         0.1)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)


@pytest.mark.parametrize("n", [8, 64])
def test_stream_kernels_repeat_exactly_and_under_graph_replay(dev, n):
    # no atomics and fixed summation orders: two calls, and two replays of
    # one captured call (the decode step of generate is a graph replay),
    # give the same bits
    h, ffn = 768, 3072
    params = _stream_params(dev, h, ffn)
    x = _t(dev, n, h, dtype=torch.bfloat16, seed=47)
    attn, w = _t(dev, n, h, seed=48), _t(dev, h, h, std=0.02, seed=49)
    b = _t(dev, h, std=0.02, seed=50)

    def step():
        return (fb.ffn_stream_cuda(x, *params, 9, "gelu", 0.1, 0.1, EPS),
                fb.linear_residual_stream_cuda(attn, w, b, x, 9, 0.1))
    eager = [step() for _ in range(2)]
    torch.cuda.synchronize()
    graph, holder = torch.cuda.CUDAGraph(), {}
    recorded = _kernels.capture(graph, lambda: holder.update(out=step()))
    assert recorded == {
        "ffn_stream": _stream_launches(dev, "ffn_stream", n, h, ffn),
        "linear_residual_stream": 1}
    _kernels.replay(graph, recorded)
    first = [o.clone() for o in holder["out"]]
    _kernels.replay(graph, recorded)
    torch.cuda.synchronize()
    for a, b_, c, d in zip(eager[0], eager[1], first, holder["out"]):
        assert torch.equal(a, b_) and torch.equal(a, c) and torch.equal(a, d)


def test_stream_smem_counts_match_the_libraries(dev):
    # the wrappers size the grid from their own count of a block's shared
    # memory; the libraries launch with theirs
    import ctypes
    k3 = _kernels.bind("ffn_stream", "ptt_ffn_stream_smem",
                       [ctypes.c_int, ctypes.c_int])
    k2 = _kernels.bind("linear_residual_stream",
                       "ptt_linear_residual_stream_smem",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    for h, per in [(768, 24), (768, 28), (96, 16), (128, 4)]:
        assert k3(h, per) == fb._ffn_stream_smem(h, per)
    k1 = _kernels.bind("ln_linear_stream", "ptt_ln_linear_stream_smem",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    for n, width, depth in [(8, 36, 128), (64, 48, 96), (3, 20, 31),
                            (8, 108, 128), (64, 108, 128)]:
        assert k2(n, width, depth) == fb._stream_gemm_smem(n, width, depth)
        assert k1(n, width, depth) == fb._stream_gemm_smem(n, width, depth)
    tiled = _kernels.bind("ln_linear_tiled", "ptt_ln_linear_tiled_smem",
                          [ctypes.c_int])
    for h in (128, 768, 1000):
        assert tiled(h) == fb._tiled_smem(h)
    held = dict(fb._ffn_stream_resident(dev))
    assert held[1] >= held[2] >= held[4] >= held[8] > 0


def test_stream_kernels_refuse_what_they_cannot_take(dev):
    w1, b1, w2, b2, g, beta = _stream_params(dev, 768, 3072)
    x = _t(dev, 8, 768, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ffn_stream: takes float32"):
        fb.ffn_stream_cuda(x, w1.bfloat16(), b1, w2.bfloat16(), b2, g, beta)
    w = torch.empty(768 * 768 + 1, device=dev)[1:].view(768, 768)
    with pytest.raises(ValueError, match="linear_residual_stream: takes"):
        fb.linear_residual_stream_cuda(x.float(), w, b2, x)


# K1's float32 routes (csrc/ln_linear_stream.cu at the decode rows,
# csrc/ln_linear_tiled.cu above them): GPT-125M's QKV projection and
# gpt_tiny's, the tiled kernel also at a ragged column tile (200 columns)
# and ragged rows; float32 or bf16 x (serving's residual stream), float32
# w.  Both compute in float32 FMA, as the SIMT kernel does: float32 sums
# in another order than cuBLAS, within F32_TOL
LN_STREAM_WIDTHS = [(768, 2304), (128, 384)]
LN_TILED_ROWS = (fb._LN_STREAM_MAX_ROWS + 1, 64, 65, 100, 128, 512, 1000,
                 4096)


def _ln_f32_params(dev, h, cols):
    w = _t(dev, h, cols, std=0.02, seed=51)
    b = _t(dev, cols, std=0.02, seed=52)
    g, beta = 1 + _t(dev, h, std=0.1, seed=53), _t(dev, h, std=0.1, seed=54)
    return w, b, g, beta


def _k1_launched(before, name):
    """Launches of each K1 kernel since ``before``: one of ``name``."""
    k1 = ("ln_linear", "ln_linear_mma", "ln_linear_stream", "ln_linear_tiled")
    return {q: _kernels.launches[q] - before[q] for q in k1} == {
        q: int(q == name) for q in k1}


@pytest.mark.parametrize("n", range(1, fb._LN_STREAM_MAX_ROWS + 1))
@pytest.mark.parametrize("h,cols", LN_STREAM_WIDTHS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ln_linear_stream(dev, n, h, cols, xdtype):
    x = _t(dev, n, h, dtype=xdtype, seed=55)
    w, b, g, beta = _ln_f32_params(dev, h, cols)
    assert fb.ln_linear_route(w, n) == "ln_linear_stream"
    before = dict(_kernels.launches)
    out = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    assert _k1_launched(before, "ln_linear_stream")
    again = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert out.dtype == ref.dtype == torch.float32 and out.shape == (n, cols)
    assert float((out - ref).abs().max()) <= F32_TOL
    assert torch.equal(out, again)           # no atomics: the same bits


@pytest.mark.parametrize("n", LN_TILED_ROWS)
@pytest.mark.parametrize("h,cols", [*LN_STREAM_WIDTHS, (768, 200)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ln_linear_tiled(dev, n, h, cols, xdtype):
    x = _t(dev, n, h, dtype=xdtype, seed=56)
    w, b, g, beta = _ln_f32_params(dev, h, cols)
    assert fb.ln_linear_route(w, n) == "ln_linear_tiled"
    before = dict(_kernels.launches)
    out = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    assert _k1_launched(before, "ln_linear_tiled")
    again = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert out.dtype == ref.dtype == torch.float32 and out.shape == (n, cols)
    assert float((out - ref).abs().max()) <= F32_TOL
    assert torch.equal(out, again)


@pytest.mark.parametrize("n", [8, 64])
def test_ln_linear_stream_rejects_b_left_out(dev, n):
    # the check above sees a fault of the bias's size (std 0.02): err/tol
    # far above 1
    x = _t(dev, n, 768, dtype=torch.bfloat16, seed=57)
    w, b, g, beta = _ln_f32_params(dev, 768, 2304)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    bad = fb.ln_linear_stream_cuda(x, w, torch.zeros_like(b), g, beta, EPS)
    assert float((bad - ref).abs().max()) > 10 * F32_TOL


@pytest.mark.parametrize("n", [128, 4096])
def test_ln_linear_tiled_rejects_b_left_out(dev, n):
    x = _t(dev, n, 768, dtype=torch.bfloat16, seed=58)
    w, b, g, beta = _ln_f32_params(dev, 768, 2304)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    bad = fb.ln_linear_tiled_cuda(x, w, torch.zeros_like(b), g, beta, EPS)
    assert float((bad - ref).abs().max()) > 10 * F32_TOL


def test_ln_linear_stream_and_tiled_refuse_what_they_cannot_take(dev):
    x = _t(dev, 8, 768, dtype=torch.bfloat16)
    w, b, g, beta = _ln_f32_params(dev, 768, 2304)
    with pytest.raises(ValueError, match="ln_linear_stream: takes"):
        fb.ln_linear_stream_cuda(x, w.bfloat16(), b, g, beta, EPS)
    wide = _t(dev, 768, 4096, std=0.02)
    with pytest.raises(ValueError, match="ln_linear_stream: takes"):
        fb.ln_linear_stream_cuda(x, wide, wide[0], g, beta, EPS)
    odd = torch.empty(768 * 2304 + 1, device=dev)[1:].view(768, 2304)
    with pytest.raises(ValueError, match="ln_linear_tiled: takes"):
        fb.ln_linear_tiled_cuda(x, odd, b, g, beta, EPS)


def test_ln_linear_stream_under_graph_replay(dev):
    # the decode step of generate replays K1 from a CUDA graph: two replays
    # give the eager call's bits, and the graph records one launch
    x = _t(dev, 8, 768, dtype=torch.bfloat16, seed=59)
    w, b, g, beta = _ln_f32_params(dev, 768, 2304)
    eager = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    torch.cuda.synchronize()
    graph, holder = torch.cuda.CUDAGraph(), {}
    recorded = _kernels.capture(graph, lambda: holder.update(
        out=fb.ln_linear_cuda(x, w, b, g, beta, EPS)))
    assert recorded == {"ln_linear_stream": 1}
    _kernels.replay(graph, recorded)
    first = holder["out"].clone()
    _kernels.replay(graph, recorded)
    torch.cuda.synchronize()
    assert torch.equal(eager, first) and torch.equal(eager, holder["out"])


# K3's and K2's register-blocked routes (csrc/ffn_tiled.cu,
# csrc/linear_residual_tiled.cu, on the GEMM body of csrc/tiled.cuh):
# float32 weights above the stream bounds.  Rows: the first above the
# bounds, ragged row tiles (100, 300, 1000), serving's buckets (128, 512)
# and generate's prefill (4096); GPT-125M's widths, gpt_tiny's and a ragged
# column tile (96 / 200).  float32 FMA as the plain version's float32
# matmul: within F32_TOL for a float32 output, one bf16 unit for a bf16
# one; with a residual of 2^-40 the addend alone within the same, and its
# dropped elements exactly the hash mask's
TILED_ROWS = (max(fb._FFN_STREAM_MAX_ROWS, fb._RESID_STREAM_MAX_ROWS) + 1,
              65, 100, 128, 300, 512, 1000, 4096)
TILED_WIDTHS = [(768, 3072), (128, 512), (96, 200)]


def _launched(before, names, name):
    """Launches of each of ``names`` since ``before``: one of ``name``."""
    return {q: _kernels.launches[q] - before[q] for q in names} == {
        q: int(q == name) for q in names}


@pytest.mark.parametrize("n,h,ffn", [
    (n, h, ffn) for n in TILED_ROWS for h, ffn in TILED_WIDTHS
    if n < 4096 or h == 768])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drops", [(0.0, 0.0), (0.2, 0.1)])
def test_ffn_tiled(dev, n, h, ffn, xdtype, drops):
    x = _t(dev, n, h, dtype=xdtype, seed=60)
    params = _stream_params(dev, h, ffn)
    assert fb.ffn_route(params[0], params[2], n) == "ffn_tiled"
    before = dict(_kernels.launches)
    out = fb.ffn_cuda(x, *params, 5, "gelu", *drops, EPS)
    assert _launched(before, ("ffn", "ffn_mma", "ffn_stream", "ffn_tiled"),
                     "ffn_tiled")
    again = fb.ffn_cuda(x, *params, 5, "gelu", *drops, EPS)
    ref = fb.ffn_reference(x, *params, 5, "gelu", *drops, EPS)
    assert out.dtype == xdtype and out.shape == (n, h)
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)
    assert torch.equal(out, again)           # no atomics: the same bits
    tiny = (x.float() * TINY).to(xdtype)
    got = fb.ffn_tiled_cuda(tiny, *params, 5, "gelu", *drops, TINY_EPS)
    want = fb.ffn_reference(tiny, *params, 5, "gelu", *drops, TINY_EPS)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   xdtype)
    if drops[1] > 0.0:
        keep = fb._keep_mask(5, fb._SALT_FFN2, torch.arange(n)[:, None],
                             torch.arange(h)[None, :], drops[1])
        assert torch.equal(_dropped(got, tiny), ~keep)
        assert torch.equal(_dropped(want, tiny), ~keep)


@pytest.mark.parametrize("n", [65, 300, 4096])
@pytest.mark.parametrize("h,ffn", [(768, 3072), (128, 128), (128, 200)])
def test_ffn_tiled_dropout1_mask(dev, n, h, ffn):
    # W2 = the (ffn, h) identity and b2 = 0: the output is x + the
    # activation of the ffn columns below h, so with a residual of 2^-40 the
    # elements equal to it are exactly drop1's dropped ones
    w1, b1, _, _, g, beta = _stream_params(dev, h, ffn)
    w2 = torch.eye(ffn, h, device=dev)
    b2 = torch.zeros(h, device=dev)
    tiny = (_t(dev, n, h, seed=61) * TINY).to(torch.bfloat16)
    got = fb.ffn_tiled_cuda(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3,
                            0.0, TINY_EPS)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 21, "gelu", 0.3,
                            0.0, TINY_EPS)
    cols = min(h, ffn)
    keep = fb._keep_mask(21, fb._SALT_FFN1, torch.arange(n)[:, None],
                         torch.arange(cols)[None, :], 0.3)
    assert torch.equal(_dropped(got, tiny)[:, :cols], ~keep)
    assert torch.equal(_dropped(want, tiny)[:, :cols], ~keep)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("n", TILED_ROWS)
@pytest.mark.parametrize("k,cols", [(768, 768), (128, 128), (96, 200)])
@pytest.mark.parametrize("xdtype,rdtype", [
    (torch.bfloat16, torch.bfloat16),         # serving and generate
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_linear_residual_tiled(dev, n, k, cols, xdtype, rdtype, p):
    x = _t(dev, n, k, dtype=xdtype, seed=62)
    w, b = _t(dev, k, cols, std=0.02, seed=63), _t(dev, cols, std=0.02,
                                                   seed=64)
    r = _t(dev, n, cols, dtype=rdtype, seed=65)
    assert fb.linear_residual_route(x, w) == "linear_residual_tiled"
    args = (77, p, fb._SALT_RESID)
    before = dict(_kernels.launches)
    out = fb.linear_residual_cuda(x, w, b, r, *args)
    assert _launched(before, ("linear_residual", "linear_residual_mma",
                              "linear_residual_stream",
                              "linear_residual_tiled"),
                     "linear_residual_tiled")
    again = fb.linear_residual_cuda(x, w, b, r, *args)
    ref = fb.linear_residual_reference(x, w, b, r, *args)
    assert out.dtype == rdtype and out.shape == (n, cols)
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)
    assert torch.equal(out, again)
    tiny = (r.float() * TINY).to(rdtype)
    got = fb.linear_residual_tiled_cuda(x, w, b, tiny, *args)
    want = fb.linear_residual_reference(x, w, b, tiny, *args)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want,
                                                                   rdtype)
    if p > 0.0:
        keep = fb._keep_mask(77, fb._SALT_RESID, torch.arange(n)[:, None],
                             torch.arange(cols)[None, :], p)
        assert torch.equal(_dropped(got, tiny), ~keep)
        assert torch.equal(_dropped(want, tiny), ~keep)


def test_linear_residual_tiled_copies_a_misaligned_x(dev):
    # a view of the attention output that starts 2 bytes into its storage
    x = torch.empty(130 * 768 + 1, dtype=torch.bfloat16,
                    device=dev)[1:].view(130, 768).copy_(
                        _t(dev, 130, 768, seed=66))
    w, b = _t(dev, 768, 768, std=0.02, seed=67), _t(dev, 768, std=0.02)
    r = _t(dev, 130, 768, dtype=torch.bfloat16, seed=68)
    assert x.data_ptr() % 16
    out = fb.linear_residual_tiled_cuda(x, w, b, r)
    ref = fb.linear_residual_reference(x, w, b, r)
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_tol(ref)


@pytest.mark.parametrize("n", [128, 512])
def test_tiled_addend_checks_reject_a_bias_left_out(dev, n):
    # the addend checks above see a fault of the bias's size: K3 without b1
    # and K2 without b lie outside one bf16 unit of the addend's range
    h, ffn = 768, 3072
    w1, b1, w2, b2, g, beta = _stream_params(dev, h, ffn)
    tiny = (_t(dev, n, h, seed=69) * TINY).to(torch.bfloat16)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 3, "gelu", 0.0,
                            0.1, TINY_EPS)
    bad = fb.ffn_tiled_cuda(tiny, w1, torch.zeros_like(b1), w2, b2, g, beta,
                            3, "gelu", 0.0, 0.1, TINY_EPS)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)
    x, w = _t(dev, n, h, seed=70), _t(dev, h, h, std=0.02, seed=71)
    b = _t(dev, h, std=0.02, seed=72)
    want = fb.linear_residual_reference(x, w, b, tiny, 3, 0.1)
    bad = fb.linear_residual_tiled_cuda(x, w, torch.zeros_like(b), tiny, 3,
                                        0.1)
    assert float((bad.float() - want.float()).abs().max()) > _bf16_tol(want)


def test_tiled_smem_counts_match_the_libraries(dev):
    import ctypes
    k3 = _kernels.bind("ffn_tiled", "ptt_ffn_tiled_smem",
                       [ctypes.c_int, ctypes.c_int])
    k2 = _kernels.bind("linear_residual_tiled",
                       "ptt_linear_residual_tiled_smem", [])
    for h in (128, 768, 1000):
        assert k3(h, 0) == fb._tiled_smem(h)
        assert k3(h, 1) == k2() == fb._tiled_raw_smem()


def test_tiled_kernels_refuse_what_they_cannot_take(dev):
    w1, b1, w2, b2, g, beta = _stream_params(dev, 768, 3072)
    x = _t(dev, 128, 768, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ffn_tiled: takes float32"):
        fb.ffn_tiled_cuda(x, w1.bfloat16(), b1, w2.bfloat16(), b2, g, beta)
    w = torch.empty(768 * 768 + 1, device=dev)[1:].view(768, 768)
    with pytest.raises(ValueError, match="linear_residual_tiled: takes"):
        fb.linear_residual_tiled_cuda(x, w, b2, x)
    w100 = _t(dev, 100, 768, std=0.02)
    with pytest.raises(ValueError, match="linear_residual_tiled: takes"):
        fb.linear_residual_tiled_cuda(x[:, :100].contiguous(), w100, b2, x)


def test_ln_linear_tiled_bits_unchanged(dev):
    # the K1 kernel rebuilt on tiled.cuh gives the bits of the kernel
    # before its body moved there (chip_smoke.LN_TILED_DIGESTS)
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.ln_tiled_bits(torch, np, dev)
    assert got == {k: smoke.LN_TILED_DIGESTS[k] for k in got}


def test_o1_fused_training_step_takes_ffn_mma(dev):
    # gpt_tiny (h = 128, ffn = 512) fused, under O1: K1, K2 and K3 run on
    # the tensor cores once per layer; the float32 step above keeps the
    # SIMT kernels
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.training import train_step
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True, use_fused_block=True)
    m, opt, ids, labels = training_workload(dev, cfg, batch=2, seq_len=128)
    _kernels.reset_launches()
    losses = [float(train_step(m, opt, ids, labels)) for _ in range(3)]
    for name in ("ffn_mma", "ln_linear_mma", "linear_residual_mma"):
        assert _kernels.launches[name] == 3 * cfg.num_layers, name
    for name in ("ffn", "ln_linear", "linear_residual", "ln_linear_stream",
                 "ln_linear_tiled", "ffn_tiled", "linear_residual_tiled"):
        assert _kernels.launches[name] == 0, name
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _block_params(h, ffn, seed=0, s=64):
    rng = np.random.default_rng(seed)
    a = lambda *s: (0.1 * rng.standard_normal(s)).astype(  # noqa: E731
        np.float32)
    return [a(h, 3 * h), a(3 * h), a(h, h), a(h), 1 + a(h), a(h),
            a(h, ffn), a(ffn), a(ffn, h), a(h), 1 + a(h), a(h)], \
        (2 * rng.standard_normal((2, s, h))).astype(np.float32)


@pytest.mark.parametrize("s", [64, 100])
def test_fused_block_on_card_matches_cpu(dev, s):
    # one training block, forward and backward, dropout 0.1 everywhere: the
    # card (K1, flash, K2, K3 kernels under autograd) against the CPU (the
    # plain versions) at the same seeds, float32.  s = 100 is no multiple
    # of the Pallas kernel's tile: the card still takes the flash kernels
    params, x_np = _block_params(128, 512, s=s)
    results = []
    for device in (dev, torch.device("cpu")):
        ps = [torch.from_numpy(p).to(device).requires_grad_()
              for p in params]
        x = torch.from_numpy(x_np).to(device).requires_grad_()
        _kernels.reset_launches()
        y = fb.fused_attention_block(
            x, *ps[:6], num_heads=4, attn_dropout=0.1, hidden_dropout=0.1,
            seed=11)
        y = fb.fused_ffn_block(y, *ps[6:], dropout2=0.1, seed=12)
        y.backward(torch.ones_like(y))
        launched = {k for k, c in _kernels.launches.items() if c}
        results.append([y.detach().cpu(), x.grad.cpu()]
                       + [p.grad.cpu() for p in ps])
        if device == dev:
            # float32 weights at 128 / 200 rows: the tiled K1-K3
            assert launched == {"ln_linear_tiled", "linear_residual_tiled",
                                "ffn_tiled", "flash_fwd", "flash_dkdv",
                                "flash_dq"}
        else:
            assert not launched
    for i, (a, b) in enumerate(zip(*results)):
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol, i


def test_fused_attention_block_refuses_head_dims_without_a_kernel(dev):
    # d = 40: no flash instantiation; the card raises, nothing runs plain
    params, x_np = _block_params(160, 640, s=16)
    ps = [torch.from_numpy(p).to(dev) for p in params[:6]]
    x = torch.from_numpy(x_np).to(dev)
    with pytest.raises(ValueError, match="head_dim 40"):
        fb.fused_attention_block(x, *ps, num_heads=4)


def test_fused_training_step_on_card_matches_cpu(dev):
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True, use_fused_block=True)
    runs = []
    for device in (dev, "cpu"):
        m, opt, ids, labels = training_workload(device, cfg, batch=2,
                                                seq_len=128)
        _kernels.reset_launches()
        loss, _ = m(ids, labels=labels)
        loss.backward()
        launches = dict(_kernels.launches)
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        opt.step()
        with torch.no_grad():
            loss2, _ = m(ids, labels=labels)
        runs.append((loss.item(), grads, loss2.item(), launches))
    (l_gpu, g_gpu, l2_gpu, n_gpu), (l_cpu, g_cpu, l2_cpu, n_cpu) = runs
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(l2_gpu - l2_cpu) <= 1e-5 * abs(l2_cpu)
    for k, ref in g_cpu.items():
        assert float((g_gpu[k] - ref).abs().max()) <= (
            1e-4 * float(ref.abs().max()) + 1e-6), k
    for name in ("ln_linear_tiled", "linear_residual_tiled", "ffn_tiled",
                 "flash_fwd", "flash_dkdv", "flash_dq"):
        assert n_gpu[name] == cfg.num_layers, name
    assert not any(n_cpu.values())


def test_serving_on_card_matches_cpu(dev):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(use_fused_block=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    m_gpu = GPTForCausalLM(cfg, device=dev)
    rng = np.random.default_rng(0)
    state = {k: (0.1 * rng.standard_normal(tuple(v.shape))).astype(
        np.float32) for k, v in m_gpu.state_dict().items()}
    load_jax_state(m_gpu, state)
    m_cpu = load_jax_state(GPTForCausalLM(cfg, device="cpu"), state)
    prompts = [rng.integers(0, 1024, n).tolist() for n in (5, 12, 3, 9)]
    outs = [ServingEngine(m, max_seqs=4, kv_block_size=4,
                          max_model_len=64).generate(prompts, 6)
            for m in (m_gpu, m_cpu)]
    assert outs[0] == outs[1]


# flash attention: ragged lengths (neither a multiple of the 64-row tile),
# sq < sk and sq > sk (bottom-right causal alignment, rows without keys),
# dropout, every head-dim instantiation
FLASH_CASES = [
    # (bh, sq, sk, d, causal, dropout_p)
    (6, 136, 200, 64, True, 0.0),
    (6, 200, 136, 64, True, 0.0),
    (4, 77, 77, 32, False, 0.0),
    (4, 256, 256, 64, True, 0.1),
    (3, 100, 130, 128, True, 0.2),
    (2, 64, 64, 16, True, 0.0),
    # both sides of the 64-row tile edges, and one query row against a
    # ragged run of keys
    (2, 127, 127, 64, True, 0.0),
    (2, 128, 128, 64, True, 0.0),
    (2, 129, 129, 64, True, 0.0),
    (3, 1, 300, 64, True, 0.0),
    # causal with sq - sk > 64: whole q tiles see no key
    (2, 300, 100, 64, True, 0.0),
    # the smallest and largest head dims under dropout
    (3, 130, 130, 16, True, 0.1),
    (2, 150, 140, 128, True, 0.1),
    # non-causal at BERT-base's shape (B=16 x H=12, S=512, d=64: every tile
    # visible), ragged both ways, across the tile edges, and with dropout
    (192, 512, 512, 64, False, 0.0),
    (6, 136, 200, 64, False, 0.0),
    (6, 200, 136, 64, False, 0.0),
    (4, 511, 513, 64, False, 0.0),
    (4, 256, 256, 64, False, 0.1),
]


def _flash_inputs(dev, bh, sq, sk, d, dtype):
    q = _t(dev, bh, sq, d, dtype=dtype, seed=1)
    k = _t(dev, bh, sk, d, dtype=dtype, seed=2)
    v = _t(dev, bh, sk, d, dtype=dtype, seed=3)
    do = _t(dev, bh, sq, d, dtype=dtype, seed=4)
    return q, k, v, do


def _flash_out_tol(ref, q, k, v, causal, p, dtype):
    """Per element.  float32: summation order only.  bf16: the kernel's
    online softmax rounds p to bf16 against a running max, the plain
    version against the row's max (2^-9 relative each), so an element
    moves by at most 2^-8 times the same attention over |v|; both round
    the result once more (one bf16 unit, 2^-7 relative)."""
    if dtype == torch.float32:
        return 1e-5 * max(1.0, float(ref.abs().max()))
    abs_pv, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float().abs(),
                                       5, None, causal, p)
    return 2.0 ** -8 * abs_pv + 2.0 ** -7 * ref.float().abs() + 1e-6


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels(dev, case, dtype):
    bh, sq, sk, d, causal, p = case
    q, k, v, do = _flash_inputs(dev, bh, sq, sk, d, dtype)
    before = {n: _kernels.launches[n]
              for n in ("flash_fwd", "flash_dkdv", "flash_dq")}
    out, lse = fa.flash_fwd_cuda(q, k, v, 5, None, causal, p)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, 5, None, causal, p)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert bool(((out.float() - ref.float()).abs()
                 <= _flash_out_tol(ref, q, k, v, causal, p, dtype)).all())
    # lse: float32 sums of exact products on both sides
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * max(
        1.0, float(ref_lse.abs().max()))
    delta = (do.float() * ref.float()).sum(-1)
    dk, dv = fa.flash_dkdv_cuda(q, k, v, do, ref_lse, delta, 5, None,
                                causal, p)
    rdk, rdv = fa.flash_dkdv_reference(q, k, v, do, ref_lse, delta, 5, None,
                                       causal, p)
    dq = fa.flash_dq_cuda(q, k, v, do, ref_lse, delta, 5, None, causal, p)
    rdq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, 5, None,
                                causal, p)
    torch.cuda.synchronize()
    # both sides round pd / ds at the same points from float32 values that
    # differ by summation order only: one unit of the output's range (bf16)
    for got, want in ((dk, rdk), (dv, rdv), (dq, rdq)):
        tol = (1e-5 * max(1.0, float(want.abs().max()))
               if dtype == torch.float32 else
               float(want.float().abs().max()) * 2.0 ** -7)
        assert float((got.float() - want.float()).abs().max()) <= tol
    for n in before:
        assert _kernels.launches[n] == before[n] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_repeat_exactly(dev, dtype):
    # no atomics and no order dependence: two launches on the same inputs
    # give the same bits
    q, k, v, do = _flash_inputs(dev, 6, 200, 200, 64, dtype)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd_cuda(q, k, v, 5, None, True, 0.1)
        delta = (do.float() * out.float()).sum(-1)
        dk, dv = fa.flash_dkdv_cuda(q, k, v, do, lse, delta, 5, None, True,
                                    0.1)
        dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, 5, None, True, 0.1)
        runs.append((out, lse, dk, dv, dq))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_autograd_on_card_matches_cpu(dev):
    q, k, v, do = _flash_inputs(dev, 4, 130, 130, 64, torch.float32)
    grads = []
    for device in (dev, torch.device("cpu")):
        qs = [t.detach().to(device).reshape(2, 2, 130, 64).requires_grad_()
              for t in (q, k, v)]
        out = fa.flash_attention(*qs, causal=True, dropout_p=0.1, seed=9)
        out.backward(do.to(device).reshape(2, 2, 130, 64))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in qs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4



# flash decode: ragged lengths (0, inside a block's range, on and around
# the first position of every block of the cluster split of the 256-position
# cache -- 4 blocks of 64, checked below -- the full capacity), q and the
# cache in either dtype, head dims that round the row's 16-byte vectors up
# to a power of two (24, 96)
DECODE_LENS = (0, 1, 31, 32, 33, 63, 64, 65, 77, 127, 128, 129, 191, 192,
               193, 200, 255, 256)


def _split_edges(cap):
    """One before, at and one after the first position of every block but
    the first of the decode kernel's split of a ``cap``-position cache."""
    splits, chunk = fa._flash_decode_split(cap)
    return splits, {b * chunk + o for b in range(1, splits)
                    for o in (-1, 0, 1)}


def test_decode_lens_cover_the_split_edges(dev):
    splits, edges = _split_edges(256)
    assert splits > 1 and edges <= set(DECODE_LENS)
    # the split follows the capacity alone
    assert fa._flash_decode_split(640) == (4, 160)
    assert fa._flash_decode_split(8)[0] == 1


def _decode_inputs(dev, b, h, sq, cap, d, qdtype, kvdtype):
    q = _t(dev, b, h, sq, d, dtype=qdtype, seed=1)
    k = _t(dev, b, h, cap, d, dtype=kvdtype, seed=2)
    v = _t(dev, b, h, cap, d, dtype=kvdtype, seed=3)
    return q, k, v


def _decode_tol(q, k, v, n, ref):
    """Per element: the kernel rounds p to the cache dtype against a running
    max of its chunk, the plain version against the row's max (2^-9
    relative each for bf16), so an element moves by at most 2^-8 times the
    same attention over |v|; a bf16 output is rounded once more (2^-7
    relative); float32 sums in another order, 1e-5."""
    f = 2.0 ** -8 if v.dtype == torch.bfloat16 else 0.0
    bound = fa.flash_decode_reference(q.float(), k, v.float().abs(), n)
    out_round = 2.0 ** -7 * ref.float().abs() if ref.dtype == \
        torch.bfloat16 else 0.0
    return f * bound + out_round + 1e-5


@pytest.mark.parametrize("d", [16, 24, 64, 96, 128, 256])
@pytest.mark.parametrize("qdtype,kvdtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("sq", [1, 2])
def test_flash_decode(dev, d, qdtype, kvdtype, sq):
    q, k, v = _decode_inputs(dev, 2, 3, sq, 256, d, qdtype, kvdtype)
    for n in DECODE_LENS:
        length = torch.tensor(n, dtype=torch.int32, device=dev)
        before = _kernels.launches["flash_decode"]
        out = fa.flash_decode_cuda(q, k, v, length)
        ref = fa.flash_decode_reference(q, k, v, length)
        torch.cuda.synchronize()
        assert _kernels.launches["flash_decode"] == before + 1
        assert out.dtype == qdtype and out.shape == q.shape
        assert bool(((out.float() - ref.float()).abs()
                     <= _decode_tol(q, k, v, length, ref)).all()), n
        if n == 0:
            assert float(out.abs().max()) == 0.0


def test_flash_decode_graph_replay_follows_device_length(dev):
    """One captured call serves every length: the kernel reads it from
    device memory at each replay."""
    q, k, v = _decode_inputs(dev, 2, 3, 1, 128, 64, torch.float32,
                             torch.bfloat16)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    fa.flash_decode_cuda(q, k, v, length)            # load the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    holder = {}
    recorded = _kernels.capture(
        graph, lambda: holder.update(out=fa.flash_decode_cuda(q, k, v,
                                                              length)))
    assert recorded == {"flash_decode": 1}
    splits, edges = _split_edges(128)
    assert splits > 1
    for n in (1, 5, 64, 65, 128, 0, 100, *sorted(edges)):
        length.fill_(n)
        before = _kernels.launches["flash_decode"]
        _kernels.replay(graph, recorded)
        assert _kernels.launches["flash_decode"] == before + 1
        eager = fa.flash_decode_cuda(q, k, v, length)
        torch.cuda.synchronize()
        assert torch.equal(holder["out"], eager), n


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_flash_decode_repeats_exactly(dev, qdtype):
    """No atomics and a fixed combine order: two launches, and two replays
    of one captured launch, give the same bits at every length."""
    q, k, v = _decode_inputs(dev, 2, 3, 2, 256, 64, qdtype, torch.bfloat16)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    fa.flash_decode_cuda(q, k, v, length)            # load the library
    torch.cuda.synchronize()
    graph, holder = torch.cuda.CUDAGraph(), {}
    recorded = _kernels.capture(
        graph, lambda: holder.update(out=fa.flash_decode_cuda(q, k, v,
                                                              length)))
    for n in DECODE_LENS:
        length.fill_(n)
        a = fa.flash_decode_cuda(q, k, v, length)
        b = fa.flash_decode_cuda(q, k, v, length)
        _kernels.replay(graph, recorded)
        first = holder["out"].clone()
        _kernels.replay(graph, recorded)
        torch.cuda.synchronize()
        assert torch.equal(a, b), n
        assert torch.equal(first, holder["out"]), n
        assert torch.equal(first, a), n


def test_paged_cache_defaults_to_cuda(dev):
    from paddle_tpu_torch.inference import PagedKVCache
    cache = PagedKVCache(num_layers=1, num_heads=2, head_dim=4, num_blocks=3,
                         block_size=4)
    assert cache.device.type == "cuda"
    assert all(t.is_cuda for pair in cache.pages for t in pair)


@pytest.mark.parametrize("variant", [dict(use_pallas_attention=True),
                                     dict(use_fused_block=True)])
def test_generate_on_card_matches_cpu(dev, variant):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, **variant)
    m_gpu = GPTForCausalLM(cfg, device=dev)
    rng = np.random.default_rng(0)
    state = {k: (0.1 * rng.standard_normal(tuple(v.shape))).astype(
        np.float32) for k, v in m_gpu.state_dict().items()}
    load_jax_state(m_gpu, state)
    m_cpu = load_jax_state(GPTForCausalLM(cfg, device="cpu"), state)
    prompt = rng.integers(0, 1024, (3, 9)).astype(np.int32)
    want = m_cpu.generate(prompt, max_new_tokens=7)
    m_gpu.generate(prompt, max_new_tokens=7)          # capture
    _kernels.reset_launches()
    got = m_gpu.generate(prompt, max_new_tokens=7)    # replays
    assert torch.equal(got.cpu(), want)
    assert _kernels.launches["flash_decode"] == cfg.num_layers * 6


def _tiny_on_card(dev, **variant):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, **variant)
    m = GPTForCausalLM(cfg, device=dev)
    rng = np.random.default_rng(0)
    state = {k: (0.1 * rng.standard_normal(tuple(v.shape))).astype(
        np.float32) for k, v in m.state_dict().items()}
    return load_jax_state(m, state), rng


@pytest.mark.parametrize("variant", [dict(use_pallas_attention=True),
                                     dict(use_fused_block=True)])
def test_generate_sampling_under_graph_replay(dev, variant):
    """Sampled decoding where the decode step is a graph replay: one seed
    gives the same tokens in the capturing and in a replaying call, and
    they are those of an eager loop with a generator of that seed (so each
    replay draws fresh noise); every token is among its step's top-k
    logits; another seed differs; top_k=1 is greedy."""
    from paddle_tpu_torch.models.gpt import _sample
    m, rng = _tiny_on_card(dev, **variant)
    prompt = torch.from_numpy(
        rng.integers(0, 1024, (3, 9)).astype(np.int32)).to(dev)
    new, temperature, top_k = 7, 0.8, 5
    kw = dict(max_new_tokens=new, temperature=temperature, top_k=top_k)
    first = m.generate(prompt, seed=11, **kw)                 # captures
    again = m.generate(prompt, seed=11, **kw)                 # replays
    assert m._gen_loop.graph is not None
    assert torch.equal(first, again)
    assert not torch.equal(first, m.generate(prompt, seed=12, **kw))

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    caches = m.make_caches(3, 9 + new)
    chunk, eager = prompt, [prompt]
    for t in range(new):
        logits, caches = m.generate_step(chunk, caches, caches[0][2])
        step = logits[:, -1].float()
        chunk = _sample(step, temperature, top_k, gen)[:, None]
        eager.append(chunk)
        kth = torch.topk(step, top_k, dim=-1).values[:, -1]
        chosen = step.gather(1, first[:, 9 + t].long()[:, None])[:, 0]
        assert bool((chosen >= kth).all()), t
    assert torch.equal(first, torch.cat(eager, dim=1))

    greedy = m.generate(prompt, max_new_tokens=new)
    one = m.generate(prompt, seed=11, **{**kw, "top_k": 1})
    assert torch.equal(one, greedy)


def test_dropping_the_model_frees_its_decode_loop(dev):
    """The model owns its decode loop (caches and captured graph) and the
    loop keeps no reference back, so deleting the model frees them at
    once, with no garbage collection."""
    import weakref
    m, rng = _tiny_on_card(dev, use_pallas_attention=True)
    prompt = rng.integers(0, 1024, (3, 9)).astype(np.int32)
    m.generate(prompt, max_new_tokens=7)
    m.generate(prompt, max_new_tokens=7)
    loop = m._gen_loop
    assert loop.graph is not None
    held = sum(t.numel() * t.element_size()
               for c in loop.caches for t in c) + sum(
        p.numel() * p.element_size() for p in m.parameters())
    torch.cuda.synchronize()
    during = torch.cuda.memory_allocated(dev)
    ref = weakref.ref(m)
    del m, loop
    assert ref() is None
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) <= during - held


# ---------------------------------------------------------------------------
# the float32 precision policy, rotary in the fused blocks, padding_idx
# ---------------------------------------------------------------------------
_POLICY_CHECK = """
import torch
from paddle_tpu_torch.nn import functional as F
g = torch.Generator().manual_seed(0)
x = torch.randn(8, 64, 32, 32, generator=g)
w = torch.randn(128, 64, 3, 3, generator=g) * 0.05
a = torch.randn(512, 1024, generator=g)
b = torch.randn(1024, 768, generator=g) * 0.03
out = {}
for name, fn, args in (("conv2d", F.conv2d, (x, w, None, 1, 1)),
                       ("linear", F.linear, (a, b))):
    ref = fn(*(t.double().cuda() if torch.is_tensor(t) else t
               for t in args))
    got = fn(*(t.cuda() if torch.is_tensor(t) else t for t in args))
    assert got.dtype == torch.float32
    # float32 products summed over K terms: a few units of 2^-24 times
    # sqrt(K) of the range; TF32's 10-bit mantissa is ~1e-3 of it
    k = 64 * 9 if name == "conv2d" else 1024
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    assert err <= 8 * 2.0 ** -24 * k ** 0.5 * scale, (name, err, scale)
    out[name] = err / scale
print(out)
"""


def test_float32_products_are_ieee_by_the_package_policy(dev):
    # a fresh process that sets no flag: importing the port turns TF32 off
    # for cuBLAS matmuls and cuDNN convolutions (device.py)
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run([sys.executable, "-c", _POLICY_CHECK],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("s", [64, 100])
def test_rotary_attention_block_on_card_matches_cpu(dev, s):
    # K1 -> rope -> flash -> K2 under autograd on the card against the
    # plain route on the CPU (rope, _attention_ref), float32, dropout 0.1
    params, x_np = _block_params(128, 512, s=s)
    results = []
    for device in (dev, torch.device("cpu")):
        ps = [torch.from_numpy(p).to(device).requires_grad_()
              for p in params[:6]]
        x = torch.from_numpy(x_np).to(device).requires_grad_()
        _kernels.reset_launches()
        y = fb.fused_attention_block(
            x, *ps, num_heads=4, attn_dropout=0.1, hidden_dropout=0.1,
            rotary=True, rope_base=500.0, seed=11)
        y.backward(torch.ones_like(y))
        launched = {k for k, c in _kernels.launches.items() if c}
        results.append([y.detach().cpu(), x.grad.cpu()]
                       + [p.grad.cpu() for p in ps])
        if device == dev:
            assert launched == {"ln_linear_tiled", "linear_residual_tiled",
                                "flash_fwd", "flash_dkdv", "flash_dq"}
    for i, (a, b) in enumerate(zip(*results)):
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol, i


def test_rotary_kvcache_step_on_card_matches_cpu(dev):
    # a prefill of 8 and two decode steps into a cache of 64: the decode
    # steps launch flash_decode on the card
    params, x_np = _block_params(128, 512, s=8)
    steps = [x_np] + [x_np[:, i:i + 1] * 0.5 for i in range(2)]
    results = []
    for device in (dev, torch.device("cpu")):
        ps = [torch.from_numpy(p).to(device) for p in params[:6]]
        kb = torch.zeros(2, 4, 64, 32, device=device)
        vb = torch.zeros_like(kb)
        _kernels.reset_launches()
        used, outs = 0, []
        for x in steps:
            y, kb, vb = fb.fused_attention_block_kvcache(
                torch.from_numpy(x).to(device), *ps, kb, vb, used,
                num_heads=4, rotary=True)
            outs.append(y.cpu())
            used += x.shape[1]
        results.append(outs + [kb.cpu(), vb.cpu()])
        if device == dev:
            assert _kernels.launches["flash_decode"] == 2
    for i, (a, b) in enumerate(zip(*results)):
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol, i


def test_embedding_padding_row_gets_no_gradient_on_card(dev):
    from paddle_tpu_torch import nn as tnn
    emb = tnn.Embedding(50, 16, padding_idx=7, device=dev)
    ids = torch.tensor([[7, 1, 7, 3], [2, 7, 9, 7]], device=dev)
    out = emb(ids)
    assert not bool(out[ids == 7].any())
    out.square().sum().backward()
    assert not bool(emb.weight.grad[7].any())
    assert bool(emb.weight.grad[1].any())


# -- the paddle tensor API on the card (no kernel of the port) ---------------
def _registry():
    from paddle_tpu_torch.ops.spec import registry
    return registry()


@pytest.mark.parametrize("spec", _registry(), ids=lambda s: s.name)
def test_registry_entry_on_card(dev, spec):
    # float32 on the card against the port's float64 CPU run, at the
    # entry's tolerances; gradients likewise at the gradient tolerances
    import numpy as np
    from paddle_tpu_torch.ops.spec import run
    args = spec.sample(np.random.RandomState(0))
    np.testing.assert_allclose(
        run(spec, args, dev, torch.float32),
        run(spec, args, "cpu", torch.float64),
        rtol=spec.rtol, atol=spec.atol)
    gargs = spec.sample(np.random.RandomState(1))
    for i in spec.grad_wrt:
        np.testing.assert_allclose(
            run(spec, gargs, dev, torch.float32, i),
            run(spec, gargs, "cpu", torch.float64, i),
            rtol=spec.grad_rtol, atol=spec.grad_atol)


def test_spectrogram_front_end_on_card(dev):
    # DeepSpeech2's linear spectrogram (n_fft 320, hop 160, Hann) of two
    # 1 s utterances and its gradient, card against the CPU in float64
    import numpy as np
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(0)
    x_np = (0.1 * rng.randn(2, 16000))
    w_np = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(320) / 320)
    outs = []
    for device, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        x = torch.as_tensor(x_np, dtype=dt, device=device).requires_grad_()
        w = torch.as_tensor(w_np, dtype=dt, device=device)
        f = pt.log1p(pt.abs(pt.signal.stft(x, 320, 160, window=w)) ** 2)
        (g,) = torch.autograd.grad(f.sum(), x)
        outs.append((f.detach().double().cpu(), g.double().cpu()))
    assert tuple(outs[0][0].shape) == (2, 161, 101)
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    y = pt.signal.istft(pt.signal.stft(torch.as_tensor(
        x_np, dtype=torch.float32, device=dev), 320, 160, window=torch.as_tensor(
        w_np, dtype=torch.float32, device=dev)), 320, 160,
        window=torch.as_tensor(w_np, dtype=torch.float32, device=dev),
        length=16000)
    assert float((y.cpu().double() - torch.as_tensor(x_np)).abs().max()) \
        < 1e-5


def test_tensor_api_default_device_is_the_card(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import dtype as fw_dtype
    prev = fw_dtype._current
    fw_dtype._current = None
    try:
        assert pt.get_device() == "gpu:0"
        for t in (pt.zeros([2]), pt.to_tensor([1.0]), pt.randn([3]),
                  pt.arange(4), pt.exp([0.0]), pt.fft.fftfreq(4)):
            assert t.device.type == "cuda"
        assert pt.nn.Linear(2, 2).weight.device.type == "cuda"
        assert pt.to_tensor([1.0], place=pt.CPUPlace()).device.type == "cpu"
        pinned = pt.to_tensor([1.0], place=pt.CUDAPinnedPlace())
        assert pinned.is_pinned()
        assert pt.is_compiled_with_cuda() and pt.device_count() >= 1
        assert isinstance(pt.get_cudnn_version(), int)
    finally:
        fw_dtype._current = prev


# -- deployment (jit.save / load): the kernels as registered ops -------------
def test_cpu_exported_artifact_launches_the_kernels_on_the_card(dev,
                                                                 tmp_path):
    """A gpt_tiny (fused block) artifact exported on the CPU, loaded on the
    card: each run launches K1-K3 (stream routes at 16 rows, tiled above
    32) and the flash forward as often as the model on the card does (K1,
    K2 and the flash forward once a layer), and equals it."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.convert import load_jax_state, random_state
    from paddle_tpu_torch.framework.dtype import device_scope
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_fused_block=True, use_pallas_attention=True)
    cpu = GPTForCausalLM(cfg, device="cpu")
    state = random_state(cpu, 0)
    load_jax_state(cpu, state)
    with device_scope("cpu"):
        jit.save(cpu, str(tmp_path / "gpt"),
                 [jit.InputSpec([None, 16], "int32", name="input_ids")])
    card = GPTForCausalLM(cfg, device=dev)
    load_jax_state(card, state)
    card.eval()
    loaded = jit.load(str(tmp_path / "gpt"))      # the current device: cuda
    for b, route in ((1, "stream"), (4, "tiled")):
        ids = torch.from_numpy(np.random.default_rng(b).integers(
            0, 1000, (b, 16)).astype(np.int32)).to(dev)
        _kernels.reset_launches()
        got = loaded(ids)
        launched = {k: v for k, v in _kernels.launches.items() if v}
        _kernels.reset_launches()
        with torch.no_grad():
            want = card(ids)
        assert launched == {k: v for k, v in _kernels.launches.items() if v}
        assert set(launched) == {f"ln_linear_{route}",
                                 f"linear_residual_{route}", f"ffn_{route}",
                                 "flash_fwd"}, launched
        for name in (f"ln_linear_{route}", f"linear_residual_{route}",
                     "flash_fwd"):
            assert launched[name] == 2, launched
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_matmul_is_exact_on_the_card(dev):
    """``torch._int_mm`` with zero-padded operands equals the CPU's int32
    product, for shapes it would refuse unpadded."""
    from paddle_tpu_torch.quantization import int_matmul
    g = np.random.default_rng(0)
    for m, k, n in ((1, 8, 8), (5, 30, 13), (4096, 768, 2304)):
        a = torch.from_numpy(g.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(g.integers(-127, 128, (k, n)).astype(np.int8))
        got = int_matmul(a.to(dev), b.to(dev))
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), int_matmul(a, b))


# -- the long tail (slice 16) on the card ------------------------------------
def _tiny_training(dev):
    from paddle_tpu_torch.convert import training_workload
    from paddle_tpu_torch.models.gpt import gpt_tiny
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   use_pallas_attention=True, dtype="bfloat16")
    return training_workload(dev, cfg, batch=2, seq_len=128)


def test_asp_and_incubate_optimizers_on_card(dev):
    from paddle_tpu_torch.incubate import LookAhead, ModelAverage, sparsity
    from paddle_tpu_torch.incubate.optimizer import DistributedFusedLamb
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.training import train_step
    m, _, ids, labels = _tiny_training(dev)
    sparsity.reset_masks()
    sparsity.set_excluded_layers(["gpt.wte", "gpt.wpe"])
    try:
        masks = sparsity.prune_model(m, 2, 4, "mask_1d")
        opt = sparsity.decorate(AdamW(learning_rate=1e-3,
                                      parameters=m.named_parameters()))
        _kernels.reset_launches()
        for _ in range(2):
            assert np.isfinite(float(train_step(m, opt, ids, labels)))
        assert _kernels.launches["flash_fwd"] == 4     # 2 layers x 2 steps
        params = dict(m.named_parameters())
        for name, mask in masks.items():
            assert sparsity.check_sparsity(params[name])
            assert torch.equal(params[name] == 0,
                               torch.from_numpy(mask == 0).to(dev))
    finally:
        sparsity.reset_masks()
        sparsity.reset_excluded_layers()
    la = LookAhead(AdamW(learning_rate=1e-3,
                         parameters=m.named_parameters()), alpha=0.5, k=2)
    for _ in range(2):
        train_step(m, la, ids, labels)
    for n, p in m.named_parameters():
        assert torch.equal(p.detach(), la.slow[n].to(p.dtype))
    ma = ModelAverage(AdamW(learning_rate=1e-3,
                            parameters=m.named_parameters()))
    for _ in range(2):
        train_step(m, ma, ids, labels)
    trained = {n: p.detach().clone() for n, p in m.named_parameters()}
    with ma.apply():
        pass
    assert all(torch.equal(p.detach(), trained[n])
               for n, p in m.named_parameters())
    lamb = DistributedFusedLamb(parameters=m.named_parameters())
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    assert np.isfinite(float(train_step(m, lamb, ids, labels)))
    assert int(lamb._state["step"]) == 1
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in m.named_parameters())


def test_profiler_trace_names_every_counted_kernel(dev, tmp_path):
    import json
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.training import train_step
    m, opt, ids, labels = _tiny_training(dev)
    train_step(m, opt, ids, labels)                    # warm
    prof = P.Profiler(scheduler=P.make_scheduler(closed=0, ready=1,
                                                 record=1, repeat=1),
                      on_trace_ready=P.export_chrome_tracing(
                          str(tmp_path), "t"))
    prof.start()
    _kernels.reset_launches()
    prof.step()
    with P.RecordEvent("one_step"):
        train_step(m, opt, ids, labels)
    prof.step()
    prof.stop()
    (path,) = list(tmp_path.iterdir())
    trace = P.load_profiler_result(str(path))
    kernels = [e["name"] for e in trace["traceEvents"]
               if str(e.get("cat", "")).lower() == "kernel"]
    for name in ("flash_fwd_", "flash_dkdv_", "flash_dq_"):
        counter = name.rstrip("_")
        assert sum(name in k for k in kernels) == \
            _kernels.launches[counter] == 2
    assert any(e.get("name") == "one_step" for e in trace["traceEvents"])
    assert "one_step" in prof.summary()
    json.dumps(trace)


# a window that opens and closes on counted launches of a port kernel, with
# a READY step before it and with none (the window then sets CUPTI up as it
# opens): every launch is in the trace, the first and the last included
@pytest.mark.parametrize("ready", [1, 0])
def test_profiler_window_edged_by_port_kernels_keeps_them(dev, tmp_path,
                                                          ready):
    from paddle_tpu_torch import profiler as P
    x = _t(dev, 128, 256)
    w, b = _t(dev, 256, 512, std=0.05), _t(dev, 512, std=0.05)
    g, beta = 1 + _t(dev, 256, std=0.1), _t(dev, 256, std=0.1)
    fb.ln_linear_tiled_cuda(x, w, b, g, beta, EPS)       # build and bind
    torch.cuda.synchronize()
    prof = P.Profiler(scheduler=P.make_scheduler(closed=1, ready=ready,
                                                 record=1, repeat=1),
                      on_trace_ready=P.export_chrome_tracing(
                          str(tmp_path), "t"))
    prof.start()
    for _ in range(ready):
        prof.step()
    _kernels.reset_launches()
    prof.step()
    assert prof.current_state == P.ProfilerState.RECORD_AND_RETURN
    for _ in range(3):
        fb.ln_linear_tiled_cuda(x, w, b, g, beta, EPS)
    prof.step()
    prof.stop()
    (path,) = list(tmp_path.iterdir())
    # by the host's launch records: the device clock may place a set-up
    # kernel's record inside the window
    kernels = [rec and rec["name"] for _, rec in P.launch_records(
        P.load_profiler_result(str(path)))]
    assert _kernels.launches["ln_linear_tiled"] == 3
    assert len(kernels) == 3 and all(k and "ln_linear_tiled_kernel" in k
                                     for k in kernels), kernels


def test_native_ring_loader_feeds_the_card(dev):
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.framework.flags import set_flags
    ds = tio.TensorDataset([np.arange(64, dtype=np.int64).reshape(16, 4)])
    set_flags({"dataloader_use_native": True})
    dl = tio.DataLoader(ds, batch_size=4, num_workers=2, places=dev)
    out = [b[0] for b in dl]
    assert dl.ring_batches == 4 and out[0].device.type == "cuda"
    assert torch.equal(torch.cat(out).cpu(),
                       torch.arange(64).reshape(16, 4))


def test_distribution_and_sparse_on_card_match_cpu(dev):
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import sparse as S
    r = np.random.RandomState(0)
    a = r.uniform(0.5, 3, 64).astype(np.float32)
    b = r.uniform(0.5, 3, 64).astype(np.float32)
    x = r.uniform(0.1, 0.9, 64).astype(np.float32)
    card = D.Beta(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    cpu = D.Beta(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    lp = card.log_prob(torch.from_numpy(x).to(dev)).double().cpu()
    assert float((lp - cpu.log_prob(torch.from_numpy(x).double())).abs()
                 .max()) < 1e-4
    assert float((card.entropy().double().cpu() - cpu.entropy()).abs()
                 .max()) < 1e-4
    s = D.Normal(torch.zeros(2, device=dev), torch.ones(2, device=dev))
    draws = s.sample((200000,), generator=torch.Generator(dev).manual_seed(0))
    assert float(draws.mean(0).abs().max()) < 4 / 200000 ** 0.5
    dense = torch.from_numpy(r.randn(64, 48).astype(np.float32)
                             * (r.rand(64, 48) < 0.1))
    rhs = torch.from_numpy(r.randn(48, 8).astype(np.float32))
    for make in (S.to_sparse_coo, S.to_sparse_csr):
        sp = make(dense.to(dev))
        got = S.matmul(sp, rhs.to(dev)).cpu()
        assert float((got - dense @ rhs).abs().max()) < 1e-5
        sm = S.softmax(sp).to_dense().cpu()
        assert torch.allclose(sm, S.softmax(make(dense)).to_dense(),
                              atol=1e-6)


def test_run_check_and_a_host_op_on_card(dev, tmp_path, capsys):
    from paddle_tpu_torch import utils
    from paddle_tpu_torch.utils import cpp_extension
    assert utils.run_check() is True
    assert "on cuda" in capsys.readouterr().out
    src = tmp_path / "neg.cc"
    src.write_text('#include <stdint.h>\nextern "C" void neg(const float* i,'
                   ' float* o, int64_t n) { for (int64_t k = 0; k < n; ++k)'
                   ' o[k] = -i[k]; }\n')
    op = cpp_extension.custom_op(cpp_extension.load("neg_op", [str(src)]),
                                 "neg")
    x = torch.arange(10, dtype=torch.float32, device=dev)
    assert torch.equal(op(x), -x)
