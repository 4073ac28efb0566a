"""The port's CUDA kernels against their plain versions on the card, at small
shapes with ragged edges.  Marked ``gpu``: they skip where no CUDA device is
visible and run on an H100 with

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import UnimplementedError, _kernels
from paddle_tpu_torch.inference.paged_attention import (
    paged_attention_cuda, paged_attention_reference)
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
    out = fb.ffn_cuda(x, w1, b1, w2, b2, g, beta, activation, EPS)
    ref = fb.ffn_reference(x, w1, b1, w2, b2, g, beta,
                           activation=activation, epsilon=EPS)
    assert out.dtype == xdtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(ref, xdtype)


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16])
def test_paged_decode(dev, page_dtype):
    B, H, D, bs, nb, T = 5, 3, 64, 16, 40, 8
    q = _t(dev, B, H, D)
    kp = _t(dev, nb * bs + 1, H, D, dtype=page_dtype, seed=1)
    vp = _t(dev, nb * bs + 1, H, D, dtype=page_dtype, seed=2)
    perm = np.random.default_rng(3).permutation(nb)[:B * T].reshape(B, T)
    tables = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lens = torch.tensor([0, 1, 33, 128, 77], dtype=torch.int32, device=dev)
    out = paged_attention_cuda(q, kp, vp, tables, lens, bs)
    ref = paged_attention_reference(q, kp, vp, tables, lens, bs)
    # the kernel rounds p to the page dtype before PV (2^-9 relative for
    # bf16); float32 pages differ by summation order only
    tol = 1e-5 if page_dtype == torch.float32 else \
        float(vp.float().abs().max()) * 2.0 ** -8
    assert float((out - ref).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


def test_dropout_on_card_is_refused(dev):
    x, w, b = _t(dev, 8, 128), _t(dev, 128, 128), _t(dev, 128)
    with pytest.raises(UnimplementedError, match="slice 2b"):
        fb.fused_linear_residual(x, w, b, x, dropout_p=0.1, training=True)


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

