"""The op-registry sweep of the PyTorch port against the JAX package, shared
by ``test_torch_op_registry*.py`` (each file takes a third of the 276
entries, so ``--dist loadfile`` spreads the sweep over the workers).

For an entry, paired with the JAX entry of the same name:

- output: the port's ``fn`` on the CPU, on the sample as float32 / integer
  tensors, against the numpy reference and against the JAX entry's ``fn``
  on the same sample, at the entry's ``rtol`` / ``atol`` (values; the
  dtype difference of the int64 results is pinned once, in
  ``test_torch_tensor_api.py``);
- gradient (entries with ``grad_wrt``): the gradient of ``sum(fn(...))``
  by each argument in ``grad_wrt``, by torch autograd against
  ``jax.grad``, at ``grad_rtol`` / ``grad_atol``;
- bf16 (entries that declare ``bf16`` and whose sample is all float): the
  port's ``fn`` on bfloat16 inputs within 0.1 of the output's scale
  (max(1, max |f32|)) of the JAX entry's float32 result, the JAX
  registry's own bound.  ``linalg.matrix_rank`` has no bfloat16 form in
  either package (a rounding of its input changes the answer): both must
  raise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.spec import registry as jax_registry
from paddle_tpu_torch.framework import dtype as fw_dtype
from paddle_tpu_torch.ops.spec import registry as torch_registry
from paddle_tpu_torch.ops.spec import run

PARTS = 3
SPECS = torch_registry()
JAX_SPECS = {s.name: s for s in jax_registry()}


def part(i: int):
    """The i-th third of the registry, in registry order."""
    n = len(SPECS)
    return SPECS[i * n // PARTS:(i + 1) * n // PARTS]


def ids(specs):
    return [s.name for s in specs]


def grad_specs(specs):
    return [s for s in specs if s.grad_wrt]


def bf16_specs(specs):
    out = []
    for s in specs:
        args = s.sample(np.random.RandomState(2))
        if s.bf16 and all(np.issubdtype(np.asarray(a).dtype, np.floating)
                          for a in args):
            out.append(s)
    return out


@pytest.fixture(autouse=True)
def on_cpu():
    """The sweep's ops create their constants on the CPU; the current
    device is restored afterwards."""
    with fw_dtype.device_scope("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the sweep (the suite's xdist workers
    oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _float32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) \
        else a


def check_output(spec):
    args = spec.sample(np.random.RandomState(0))
    jspec = JAX_SPECS[spec.name]
    got = run(spec, args)
    want = np.asarray(spec.ref(*[np.asarray(a) for a in args]))
    np.testing.assert_allclose(got, want, rtol=spec.rtol, atol=spec.atol,
                               err_msg=f"{spec.name}: against numpy")
    jout = np.asarray(jspec.fn(*args))
    np.testing.assert_allclose(got, jout, rtol=spec.rtol, atol=spec.atol,
                               err_msg=f"{spec.name}: against JAX")


def check_grad(spec):
    args = [_float32(a) for a in spec.sample(np.random.RandomState(1))]
    jspec = JAX_SPECS[spec.name]
    jargs = [jnp.asarray(a) for a in args]
    for i in spec.grad_wrt:
        want = np.asarray(jax.grad(lambda *xs: jnp.sum(jspec.fn(*xs)),
                                   argnums=i)(*jargs))
        np.testing.assert_allclose(
            run(spec, args, grad_at=i), want, rtol=spec.grad_rtol, atol=spec.grad_atol,
            err_msg=f"{spec.name}: gradient by argument {i}")


def check_bf16(spec):
    args = spec.sample(np.random.RandomState(2))
    f32 = np.asarray(JAX_SPECS[spec.name].fn(*args), np.float32)
    if spec.name == "linalg.matrix_rank":
        # no bfloat16 form in either package
        with pytest.raises(RuntimeError):
            run(spec, args, dtype=torch.bfloat16)
        with pytest.raises((NotImplementedError, KeyError)):
            JAX_SPECS[spec.name].fn(*[jnp.asarray(a, jnp.bfloat16)
                                      for a in args])
        return
    out = run(spec, args, dtype=torch.bfloat16).astype(np.float32)
    scale = max(1.0, float(np.max(np.abs(f32))))
    err = float(np.max(np.abs(out - f32))) / scale
    assert err < 0.1, f"{spec.name}: bf16 deviates {err:.4f} from f32"
