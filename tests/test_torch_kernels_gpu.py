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


# ragged rows (not a multiple of 16) and columns (not a multiple of 64)
@pytest.mark.parametrize("n,h,cols", [(8, 128, 384), (37, 96, 200)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ln_linear(dev, n, h, cols, xdtype):
    x = _t(dev, n, h, dtype=xdtype)
    w, b = _t(dev, h, cols, std=0.05), _t(dev, cols, std=0.05)
    g, beta = 1 + _t(dev, h, std=0.1), _t(dev, h, std=0.1)
    before = _kernels.launches["ln_linear"]
    out = fb.ln_linear_cuda(x, w, b, g, beta, EPS)
    ref = fb.ln_linear_reference(x, w, b, g, beta, EPS)
    assert _kernels.launches["ln_linear"] == before + 1
    assert out.dtype == ref.dtype == torch.float32
    assert float((out - ref).abs().max()) <= F32_TOL


@pytest.mark.parametrize("n,k,cols", [(8, 128, 128), (37, 96, 200)])
@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16])
def test_linear_residual(dev, n, k, cols, rdtype):
    x, w, b = _t(dev, n, k), _t(dev, k, cols, std=0.05), _t(dev, cols)
    r = _t(dev, n, cols, dtype=rdtype, seed=1)
    out = fb.linear_residual_cuda(x, w, b, r)
    ref = fb.linear_residual_reference(x, w, b, r)
    assert out.dtype == rdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)


# one cluster group per row tile (the result stored by the cluster) and, at
# ffn = 2200, two groups (partials summed by the finalize kernel)
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
    out = fb.ffn_cuda(x, w1, b1, w2, b2, g, beta, activation=activation,
                      epsilon=EPS)
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


# K2 / K3 hash dropout: decode rows, a prefill bucket and the generate
# prefill's rows; at h = 768, ffn = 3072 K3 takes several cluster groups
# at N=8 and one from 512.  dropout2 is applied by the finalize kernel, which
# every shape takes when it is on; with dropout2 0 one group stores its
# output at the cluster's exit (dropout1 alone covers that exit)
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
    out = fb.linear_residual_cuda(x, w, b, r, *args)
    ref = fb.linear_residual_reference(x, w, b, r, *args)
    assert out.dtype == rdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, rdtype)
    tiny = (r.float() * TINY).to(rdtype)
    got = fb.linear_residual_cuda(x, w, b, tiny, *args)
    want = fb.linear_residual_reference(x, w, b, tiny, *args)
    keep = fb._keep_mask(77, fb._SALT_RESID, torch.arange(n)[:, None],
                         torch.arange(h)[None, :], 0.1)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)
    # dropout 0 is the kernel of the serving path, unchanged
    assert torch.equal(fb.linear_residual_cuda(x, w, b, r, 77, 0.0),
                       fb.linear_residual_cuda(x, w, b, r))


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
    out = fb.ffn_cuda(x, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2, EPS)
    ref = fb.ffn_reference(x, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                           EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)
    if d2 == 0.0:
        return
    tiny = (x.float() * TINY).to(xdtype)
    got = fb.ffn_cuda(tiny, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                      TINY_EPS)
    want = fb.ffn_reference(tiny, w1, b1, w2, b2, g, beta, 5, "gelu", d1, d2,
                            TINY_EPS)
    keep = fb._keep_mask(5, fb._SALT_FFN2, torch.arange(n)[:, None],
                         torch.arange(h)[None, :], d2)
    assert torch.equal(_dropped(got, tiny), ~keep)
    assert torch.equal(_dropped(want, tiny), ~keep)


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
            assert launched == {"ln_linear", "linear_residual", "ffn",
                                "flash_fwd", "flash_dkdv", "flash_dq"}
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
    for name in ("ln_linear", "linear_residual", "ffn", "flash_fwd",
                 "flash_dkdv", "flash_dq"):
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
