"""Port parity for flash attention: ``paddle_tpu_torch.ops.flash_attention``
(the plain versions the CPU takes) against the JAX package's
``flash_attention``, whose Pallas kernels run in interpret mode on the CPU,
on the same numpy inputs: the output, the saved ``lse`` (through
``_flash_fwd``) and dq / dk / dv, in float32 and bfloat16, causal and not,
with ``q_len != kv_len`` (bottom-right causal alignment, lengths not a
multiple of any tile) and with hash dropout under a fixed seed."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

pytestmark = pytest.mark.kernels

# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"): the two differ in summation order and in the online (tiled)
# against the one-pass softmax, ~1e-6; 1e-5 relative to the tensor's range
# is the bound, where a masked or dropped column moves an element by 1e-2
# or more
F32_TOL = 1e-5

CASES = {
    # name: (dtype, causal, sq, sk, dropout_p)
    "f32-causal": (np.float32, True, 128, 128, 0.0),
    "f32-full": (np.float32, False, 128, 128, 0.0),
    "f32-causal-ragged": (np.float32, True, 136, 200, 0.0),
    "f32-full-ragged": (np.float32, False, 136, 200, 0.0),
    "f32-causal-dropout": (np.float32, True, 128, 128, 0.2),
    "bf16-causal": (jnp.bfloat16, True, 128, 128, 0.0),
}
SEED = 7


def _inputs(sq, sk, b=2, h=2, d=32, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(b, h, sq, d).astype(np.float32)
    k = r.randn(b, h, sk, d).astype(np.float32)
    v = r.randn(b, h, sk, d).astype(np.float32)
    g = r.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, dtype, causal, p):
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, causal=causal, dropout_p=p, seed=SEED), qj, kj, vj)
    grads = vjp(jnp.asarray(g, dtype))
    # the saved lse, through the forward kernel on the padded inputs
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sqp, skp = jfa._pad_to_legal(sq), jfa._pad_to_legal(sk)
    flat = lambda a, n: jfa._pad_seq(a, n).reshape(b * h, n, d)  # noqa: E731
    seed = jnp.full((1, 1), SEED if p > 0 else 0, jnp.int32)
    _, lse = jfa._flash_fwd(flat(qj, sqp), flat(kj, skp), flat(vj, skp),
                            seed, d ** -0.5, causal, p, sk, sk - sq)
    to_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (to_np(out), to_np(lse)[:, :sq].reshape(b, h, sq),
            [to_np(x) for x in grads])


def _torch(q, k, v, g, dtype, causal, p):
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, dropout_p=p,
                              seed=SEED)
    out.backward(torch.from_numpy(g).to(tdt))
    b, h, sq, d = q.shape
    _, lse = tfa.flash_fwd_reference(
        qt.detach().reshape(b * h, sq, d), kt.detach().reshape(b * h, -1, d),
        vt.detach().reshape(b * h, -1, d), SEED, d ** -0.5, causal, p)
    return (out.detach().float().numpy(), lse.reshape(b, h, sq).numpy(),
            [t.grad.float().numpy() for t in (qt, kt, vt)])


def _bf16_tol(ref, abs_bound):
    """bfloat16 on both sides: each rounds p to bf16 before P.V against its
    own running max (JAX per 128-column tile, the plain version in one
    pass), 2^-9 relative each, so an element moves by at most 2^-8 times
    the same product on |v| (``abs_bound``); both round the float32 result
    once more, at most one unit (2^-7 relative) apart."""
    return 2.0 ** -8 * abs_bound + 2.0 ** -7 * np.abs(ref) + 1e-6


def _check(got, ref, tol, what):
    err = np.abs(got - ref)
    assert got.shape == ref.shape, what
    assert np.all(err <= tol), (
        f"{what}: max |port - jax| {err.max():.3e}, worst err/tol "
        f"{(err / tol).max():.3f}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax(case):
    dtype, causal, sq, sk, p = CASES[case]
    q, k, v, g = _inputs(sq, sk)
    j_out, j_lse, j_grads = _jax(q, k, v, g, dtype, causal, p)
    t_out, t_lse, t_grads = _torch(q, k, v, g, dtype, causal, p)
    # lse is float32 on both sides, from float32 sums of exact products
    _check(t_lse, j_lse, 1e-5 * max(1.0, np.abs(j_lse).max()), "lse")
    if dtype == np.float32:
        for name, got, ref in zip(("out", "dq", "dk", "dv"),
                                  [t_out] + t_grads, [j_out] + j_grads):
            _check(got, ref, F32_TOL * max(1.0, np.abs(ref).max()), name)
        return
    # bf16: the output against the bound above; the gradients round pd and
    # ds to bf16 at the same points on both sides from float32 values that
    # differ by the forward's rounding, so they are held to 2^-6 of their
    # range (a wrong mask or tile is off by far more)
    b, h = q.shape[:2]
    qf, kf, vf = (torch.from_numpy(a).bfloat16().reshape(b * h, -1, 32)
                  for a in (q, k, v))
    abs_pv, _ = tfa.flash_fwd_reference(qf.float(), kf.float(),
                                        vf.float().abs(), 0, None, causal)
    _check(t_out, j_out,
           _bf16_tol(j_out, abs_pv.reshape(j_out.shape).numpy()), "out")
    for name, got, ref in zip(("dq", "dk", "dv"), t_grads, j_grads):
        _check(got, ref, 2.0 ** -6 * np.abs(ref).max(), name)


def test_sq_greater_than_sk_causal_rows_without_keys():
    # rows that see no key (row + sk - sq < 0) give zeros and no gradient
    q, k, v, g = _inputs(96, 40)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=True)
    out.backward(torch.from_numpy(g))
    assert float(out.detach()[:, :, :56].abs().max()) == 0.0
    assert float(qt.grad[:, :, :56].abs().max()) == 0.0
    # every later row matches the JAX package
    j_out = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(out.detach().numpy()[:, :, 56:],
                               j_out[:, :, 56:], rtol=F32_TOL, atol=F32_TOL)


def test_dropout_deterministic_per_seed_and_off_in_eval():
    q, k, v, _ = _inputs(64, 64)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    a = tfa.flash_attention(qt, kt, vt, dropout_p=0.3, seed=42)
    b = tfa.flash_attention(qt, kt, vt, dropout_p=0.3, seed=42)
    c = tfa.flash_attention(qt, kt, vt, dropout_p=0.3, seed=43)
    assert torch.equal(a, b) and not torch.equal(a, c)
    off = tfa.flash_attention(qt, kt, vt, dropout_p=0.3, training=False)
    assert torch.equal(off, tfa.flash_attention(qt, kt, vt))


def test_cuda_wrappers_refuse_cpu_tensors():
    # the kernel wrappers never take the plain version themselves
    q = torch.zeros(2, 64, 64)
    with pytest.raises(Exception, match="one CUDA device"):
        tfa.flash_fwd_cuda(q, q, q)
