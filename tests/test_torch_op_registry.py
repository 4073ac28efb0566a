"""The port's op registry (``paddle_tpu_torch/ops/spec.py``), part 1 of
3, against the JAX package's registry and the numpy references on the CPU:
outputs, gradients and the bf16 sweep (``torch_registry_sweep.py`` says
how each is held)."""
import pytest

import torch_registry_sweep as sweep
from torch_registry_sweep import on_cpu, one_torch_thread  # noqa: F401

SPECS = sweep.part(0)
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


def test_registry_names_match_jax():
    names = [s.name for s in sweep.SPECS]
    assert len(names) == 276 and len(set(names)) == 276
    assert set(names) == set(sweep.JAX_SPECS)
    assert names == list(sweep.JAX_SPECS)
    assert sum(len(sweep.part(i)) for i in range(sweep.PARTS)) == 276


def test_registry_counts_by_namespace():
    from collections import Counter
    top = ("nn", "linalg", "fft", "signal", "incubate", "ops")
    counts = Counter(s.name.split(".")[0] if s.name.split(".")[0] in top
                     else "top" for s in sweep.SPECS)
    assert counts == {"top": 171, "nn": 73, "linalg": 17, "fft": 7,
                      "signal": 3, "incubate": 4, "ops": 1}


def test_entry_metadata_matches_jax():
    for s in sweep.SPECS:
        j = sweep.JAX_SPECS[s.name]
        assert (s.grad_wrt, s.rtol, s.atol, s.grad_rtol, s.grad_atol,
                s.bf16) == (j.grad_wrt, j.rtol, j.atol, j.grad_rtol,
                            j.grad_atol, j.bf16), s.name


def test_api_table_lists_every_entry():
    from paddle_tpu_torch.ops.spec import api_table
    table = api_table()
    assert table.count("\n") == 276 + 1
    assert "| `paddle_tpu_torch.linalg.det` | yes |" in table
