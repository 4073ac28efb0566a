"""Port parity: ragged paged-attention decode (paddle_tpu_torch/inference/
paged_attention.py) against the JAX package's reference and its Pallas
kernel in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged_attention import (paged_attention_pallas,
                                                  paged_attention_reference)
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.inference.paged_attention import (
    paged_attention as t_paged_attention,
    paged_attention_cuda as t_paged_attention_cuda,
    paged_attention_reference as t_paged_attention_reference)

# both sides gather the same rows and run the softmax in float32; only the
# summation order differs, so 1e-6 absolute holds for O(1) inputs
ATOL_REF = 1e-6
# the Pallas kernel runs an online softmax block by block: a few float32
# roundings more than the one-shot reference (the JAX suite's own bound)
ATOL_PALLAS = 1e-5


def _inputs(seed=0, B=4, H=2, D=8, bs=4, nb=12, T=5, lens=(7, 0, 20, 1)):
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(B, H, D).astype(np.float32),
                kp=rng.randn(nb * bs + 1, H, D).astype(np.float32),
                vp=rng.randn(nb * bs + 1, H, D).astype(np.float32),
                tbl=rng.randint(0, nb, (B, T)).astype(np.int32),
                lens=np.asarray(lens, np.int32), bs=bs)


def _torch_ref(a, page_dtype=torch.float32):
    return t_paged_attention_reference(
        torch.from_numpy(a["q"]), torch.from_numpy(a["kp"]).to(page_dtype),
        torch.from_numpy(a["vp"]).to(page_dtype), torch.from_numpy(a["tbl"]),
        torch.from_numpy(a["lens"]), a["bs"])


def test_reference_matches_jax_reference_incl_empty_row():
    a = _inputs()
    ref = paged_attention_reference(jnp.asarray(a["q"]), jnp.asarray(a["kp"]),
                                    jnp.asarray(a["vp"]),
                                    jnp.asarray(a["tbl"]),
                                    jnp.asarray(a["lens"]), a["bs"])
    got = _torch_ref(a)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_REF)
    assert float(got[1].abs().max()) == 0.0          # the len-0 row


def test_reference_matches_pallas_kernel_interpret():
    a = _inputs(seed=3)
    pal = paged_attention_pallas(jnp.asarray(a["q"]), jnp.asarray(a["kp"]),
                                 jnp.asarray(a["vp"]), jnp.asarray(a["tbl"]),
                                 jnp.asarray(a["lens"]), a["bs"],
                                 interpret=True)
    np.testing.assert_allclose(_torch_ref(a).numpy(), np.asarray(pal),
                               atol=ATOL_PALLAS)


def test_bf16_pages_match_jax_reference():
    # bf16 pages, f32 query: both sides upcast the pages and compute in f32
    a = _inputs(seed=5, D=16, lens=(3, 11, 0, 19))
    kp16 = jnp.asarray(a["kp"], jnp.bfloat16)
    vp16 = jnp.asarray(a["vp"], jnp.bfloat16)
    ref = paged_attention_reference(jnp.asarray(a["q"]), kp16, vp16,
                                    jnp.asarray(a["tbl"]),
                                    jnp.asarray(a["lens"]), a["bs"])
    got = _torch_ref(a, page_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_REF)


def test_routing_takes_plain_version_on_cpu():
    a = _inputs(seed=7)
    before = dict(_kernels.launches)
    got = t_paged_attention(
        torch.from_numpy(a["q"]), torch.from_numpy(a["kp"]),
        torch.from_numpy(a["vp"]), torch.from_numpy(a["tbl"]),
        torch.from_numpy(a["lens"]), a["bs"])
    np.testing.assert_array_equal(got.numpy(), _torch_ref(a).numpy())
    assert _kernels.launches == before        # no kernel counted on the CPU


def test_kernel_wrapper_refuses_cpu_tensors():
    a = _inputs()
    with pytest.raises(ValueError, match="must be on"):
        t_paged_attention_cuda(
            torch.from_numpy(a["q"]), torch.from_numpy(a["kp"]),
            torch.from_numpy(a["vp"]), torch.from_numpy(a["tbl"]),
            torch.from_numpy(a["lens"]), a["bs"])


def test_shape_checks():
    a = _inputs()
    with pytest.raises(ValueError, match="disagree"):
        t_paged_attention_reference(
            torch.from_numpy(a["q"]), torch.from_numpy(a["kp"][:, :1]),
            torch.from_numpy(a["vp"][:, :1]), torch.from_numpy(a["tbl"]),
            torch.from_numpy(a["lens"]), a["bs"])
