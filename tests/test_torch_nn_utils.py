"""Port parity of ``nn.utils`` (``paddle_tpu_torch/nn/utils.py``) against
the JAX package's ``paddle_tpu/nn/utils.py`` on the CPU: ``weight_norm``
and ``spectral_norm`` on a Linear and a Conv2D (their state-dict keys
``weight_g`` / ``weight_v`` / ``weight_orig`` and values, the layer's
output and the gradients of ``sum(out * ct)`` with respect to every
parameter and the input, the power-iteration vectors loaded from the JAX
layer and advanced only in training, ``remove_weight_norm``), and
``parameters_to_vector`` / ``vector_to_parameters``.

Tolerances: float32 on both sides; values and gradients within 1e-5 of
each tensor's range (absolute floor 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import utils as jutils
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn import utils as tutils


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5


def _close(got, ref, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    bound = TOL * max(float(np.abs(ref).max()), 1e-1)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _pair(kind):
    pt.seed(21)
    if kind == "linear":
        jl = jnn.Linear(5, 4)
        tl = tnn.Linear(5, 4, device="cpu")
        x = np.random.RandomState(22).randn(3, 5).astype(np.float32)
    else:
        jl = jnn.Conv2D(3, 4, 3, padding=1)
        tl = tnn.Conv2D(3, 4, 3, padding=1, device="cpu")
        x = np.random.RandomState(22).randn(2, 3, 5, 5).astype(np.float32)
    load_jax_state(tl, {k: np.asarray(v) for k, v in jl.state_dict().items()})
    return jl, tl, x


def _forward_and_grads(jl, tl, x):
    """Both layers' outputs and gradients (every parameter, the input),
    the JAX side through ``apply``."""
    params = jl.trainable_variables()
    out, vjp = jax.vjp(lambda p, x: jl.apply(p, x), params, jnp.asarray(x))
    ct = np.random.RandomState(23).randn(*out.shape).astype(np.float32)
    jpg, jxg = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tout = tl(tx)
    _close(tout, out, "output")
    (tout * torch.from_numpy(ct)).sum().backward()
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(jpg)
    for name, p in tl.named_parameters():
        _close(p.grad, jpg[name], f"grad {name}")
    _close(tx.grad, jxg, "grad input")


@pytest.mark.parametrize("kind,dim", [("linear", 0), ("linear", 1),
                                      ("conv", 0)])
def test_weight_norm_matches_jax(kind, dim):
    jl, tl, x = _pair(kind)
    jutils.weight_norm(jl, dim=dim)
    tutils.weight_norm(tl, dim=dim)
    jsd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    tsd = tl.state_dict()
    assert sorted(tsd) == sorted(jsd) == ["bias", "weight_g", "weight_v"]
    for k, v in jsd.items():
        _close(tsd[k], v, k)
    assert "weight" not in dict(tl.named_parameters())
    _close(tl.weight, np.asarray(jl.weight.value), "derived weight")
    _forward_and_grads(jl, tl, x)
    # the factors move, the derived weight follows at the next forward
    with torch.no_grad():
        tl.weight_g.mul_(2.0)
    tl(torch.from_numpy(x))
    before = tl.weight.detach().clone()
    tutils.remove_weight_norm(tl)
    jutils.remove_weight_norm(jl)
    assert sorted(tl.state_dict()) == ["bias", "weight"]
    assert isinstance(tl.weight, torch.nn.Parameter)
    torch.testing.assert_close(tl.weight.detach(), before)
    assert not tl._forward_pre_hooks
    with pytest.raises(Exception):
        tutils.remove_weight_norm(tl)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_spectral_norm_matches_jax(kind):
    jl, tl, x = _pair(kind)
    jutils.spectral_norm(jl, n_power_iterations=2)
    tutils.spectral_norm(tl, n_power_iterations=2)
    jsd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    tsd = tl.state_dict()
    assert sorted(tsd) == sorted(jsd) == ["bias", "weight_orig"]
    # the JAX draws differ: start both from the JAX layer's vectors
    jsn = jl.__dict__["_weight_spectral_norm"]
    tsn = tl.weight_spectral_norm
    with torch.no_grad():
        for k in ("weight_u", "weight_v"):
            getattr(tsn, k).copy_(torch.from_numpy(np.asarray(
                jsn._buffers[k])))
    _forward_and_grads(jl, tl, x)
    # each training forward advances u / v once, on both sides
    for step in range(2):
        for k in ("weight_u", "weight_v"):
            _close(getattr(tsn, k), jsn._buffers[k], f"{k} after {step + 1}")
        jl(jnp.asarray(x))
        tl(torch.from_numpy(x))
    tl.eval()
    frozen = [tsn.weight_u.clone(), tsn.weight_v.clone()]
    tl(torch.from_numpy(x))
    assert torch.equal(tsn.weight_u, frozen[0])
    assert torch.equal(tsn.weight_v, frozen[1])
    # u / v move with the layer but stay out of its state dict
    assert {n for n, _ in tl.named_buffers()} == {
        "weight_spectral_norm.weight_u", "weight_spectral_norm.weight_v"}
    assert tl.to(torch.float64).weight_spectral_norm.weight_u.dtype == \
        torch.float64


def test_parameters_vector_round_trip_matches_jax():
    jl, tl, _ = _pair("conv")
    jvec = np.asarray(jutils.parameters_to_vector(
        list(jl.trainable_variables().values())))
    tvec = tutils.parameters_to_vector(tl.parameters())
    _close(tvec, jvec, "vector")
    new = torch.arange(tvec.numel(), dtype=torch.float32)
    tutils.vector_to_parameters(new, tl.parameters())
    torch.testing.assert_close(tutils.parameters_to_vector(
        tl.parameters()).detach(), new)
    assert tl.weight.shape == (4, 3, 3, 3)
    with pytest.raises(Exception):
        tutils.vector_to_parameters(torch.zeros(5), tl.parameters())
