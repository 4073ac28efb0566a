"""The port's op registry (``paddle_tpu_torch/ops/spec.py``), part 3 of
3, against the JAX package's registry and the numpy references on the CPU:
outputs, gradients and the bf16 sweep (``torch_registry_sweep.py`` says
how each is held)."""
import pytest

import torch_registry_sweep as sweep
from torch_registry_sweep import on_cpu, one_torch_thread  # noqa: F401

SPECS = sweep.part(2)
GRAD = sweep.grad_specs(SPECS)
BF16 = sweep.bf16_specs(SPECS)


@pytest.mark.parametrize("spec", SPECS, ids=sweep.ids(SPECS))
def test_output_matches_jax_and_numpy(spec):
    sweep.check_output(spec)


@pytest.mark.parametrize("spec", GRAD, ids=sweep.ids(GRAD))
def test_grad_matches_jax(spec):
    sweep.check_grad(spec)


@pytest.mark.parametrize("spec", BF16, ids=sweep.ids(BF16))
def test_bf16_close_to_jax_f32(spec):
    sweep.check_bf16(spec)
