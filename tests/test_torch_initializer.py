"""Port parity of ``paddle_tpu_torch/nn/initializer.py`` and of the layers'
default parameters on the CPU, against ``paddle_tpu/nn/initializer.py``.

- ``_fans`` and ``calculate_gain`` give the JAX values exactly;
- the deterministic initializers (``Constant``, ``Assign``, ``Dirac``,
  ``Bilinear``) give the JAX arrays exactly; ``Orthogonal`` is orthogonal
  at its gain, as JAX's;
- each random initializer's draw (the port's torch generator, JAX's
  threefry: other bits) has JAX's bounds, and mean and variance within
  ``Z = 6`` standard errors of the distribution's (the JAX draw is held
  to the same bounds);
- ``nn.Linear`` (and so LeNet's and the BERT classifier's) defaults to
  ``XavierUniform`` / ``Constant(0)`` as the JAX ``Linear``; ``ParamAttr``,
  ``bias_attr=False`` and ``set_global_initializer`` pick initializers in
  the JAX ``create_parameter`` order; ``Conv2D`` draws ``Uniform(+-1 /
  sqrt(fan_in))``; a ``Linear`` given ``std`` keeps its ``normal(0,
  std)``;
- the draws come from the framework's streams: one seed, one draw, and
  torch's global generator untouched.
"""
import math

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                          bert_tiny)
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI

Z = 6.0     # standard errors allowed for a sample mean / variance

SHAPES = [(), (5,), (3, 4), (8, 3, 3, 3), (4, 2, 5), (6, 4, 2, 3, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fans_match_jax(shape):
    assert TI._fans(shape) == JI._fans(shape)


def test_calculate_gain_matches_jax():
    names = ["sigmoid", "linear", "conv1d", "conv2d", "conv3d",
             "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
             "tanh", "relu", "selu", "leaky_relu"]
    for name in names:
        assert TI.calculate_gain(name) == JI.calculate_gain(name), name
    assert TI.calculate_gain("leaky_relu", 0.2) == JI.calculate_gain(
        "leaky_relu", 0.2)
    with pytest.raises(ValueError):
        TI.calculate_gain("softsign")


@pytest.mark.parametrize("name,make,shape", [
    ("Constant", lambda M: M.Constant(0.25), (3, 4)),
    ("Assign", lambda M: M.Assign(np.arange(6.0).reshape(2, 3)), (2, 3)),
    ("Dirac", lambda M: M.Dirac(), (4, 3, 3, 3)),
    ("Dirac_groups", lambda M: M.Dirac(groups=2), (6, 2, 3, 1)),
    ("Bilinear", lambda M: M.Bilinear(), (2, 3, 4, 4)),
    ("Bilinear_odd", lambda M: M.Bilinear(), (1, 2, 5, 5))])
def test_deterministic_initializers_match_jax(name, make, shape):
    got = make(TI)(shape)
    ref = np.asarray(make(JI)(jax.random.key(0), shape))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_assign_refuses_another_shape():
    with pytest.raises(ValueError):
        TI.Assign(np.zeros(3))((4,))


@pytest.mark.parametrize("shape,gain", [((64, 16), 1.0), ((8, 4, 3, 3), 2.0)])
def test_orthogonal_is_orthogonal_as_jax(shape, gain):
    for w in (TI.Orthogonal(gain)(shape).numpy(),
              np.asarray(JI.Orthogonal(gain)(jax.random.key(0), shape))):
        m = w.reshape(shape[0], -1)
        m = m.T if m.shape[0] >= m.shape[1] else m
        np.testing.assert_allclose(m @ m.T, gain ** 2 * np.eye(m.shape[0]),
                                   atol=1e-5)


def _moments(low, high):
    return (low + high) / 2, (high - low) ** 2 / 12


def _trunc_var():
    # the variance of a standard normal truncated to [-2, 2]
    phi = math.exp(-2.0) / math.sqrt(2 * math.pi)
    return 1 - 4 * phi / math.erf(2 / math.sqrt(2))


XAVIER_U = math.sqrt(6.0 / (512 + 256))
KAIMING_GAIN = math.sqrt(2.0 / (1 + 0.1 ** 2))
# name: (initializer factory, shape, (low, high) bounds or None, mean, var)
RANDOM = {
    "Uniform": (lambda M: M.Uniform(-2.0, 3.0), (256, 512), (-2.0, 3.0),
                *_moments(-2.0, 3.0)),
    "Normal": (lambda M: M.Normal(1.0, 2.0), (256, 512), None, 1.0, 4.0),
    "TruncatedNormal": (lambda M: M.TruncatedNormal(0.5, 2.0), (256, 512),
                        (0.5 - 4.0, 0.5 + 4.0), 0.5, 4.0 * _trunc_var()),
    "XavierUniform": (lambda M: M.XavierUniform(), (256, 512),
                      (-XAVIER_U, XAVIER_U), 0.0, XAVIER_U ** 2 / 3),
    "XavierNormal": (lambda M: M.XavierNormal(), (64, 32, 3, 3), None, 0.0,
                     2.0 / (32 * 9 + 64 * 9)),
    "KaimingUniform": (lambda M: M.KaimingUniform(0.1), (64, 32, 3, 3),
                       (-KAIMING_GAIN * math.sqrt(3.0 / 288),
                        KAIMING_GAIN * math.sqrt(3.0 / 288)), 0.0,
                       KAIMING_GAIN ** 2 / 288),
    "KaimingNormal": (lambda M: M.KaimingNormal(), (64, 32, 3, 3), None, 0.0,
                      2.0 / 288),
}


def _check_moments(w, bounds, mean, var, what):
    w = np.asarray(w, np.float64).ravel()
    n = w.size
    if bounds is not None:
        assert bounds[0] <= w.min() and w.max() <= bounds[1], what
    assert abs(w.mean() - mean) <= Z * math.sqrt(var / n), (what, w.mean())
    # the sample variance's standard error, with the fourth moment of the
    # sample as the estimate of the distribution's
    m4 = float(((w - w.mean()) ** 4).mean())
    assert abs(w.var() - var) <= Z * math.sqrt((m4 - var ** 2) / n), (
        what, w.var(), var)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializer_distribution_matches_jax(name):
    make, shape, bounds, mean, var = RANDOM[name]
    got = make(TI)(shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _check_moments(got.numpy(), bounds, mean, var, f"port {name}")
    _check_moments(make(JI)(jax.random.key(0), shape), bounds, mean, var,
                   f"jax {name}")


def test_draws_come_from_the_framework_streams():
    state = torch.random.get_rng_state()
    fw_random.seed(7)
    a = TI.XavierUniform()((4, 5))
    fw_random.seed(7)
    b = TI.XavierUniform()((4, 5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(3)
    c = TI.Normal()((4, 5), generator=gen)
    torch.testing.assert_close(c, torch.randn(4, 5, generator=torch.Generator(
        ).manual_seed(3)), rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)


def test_linear_defaults_to_xavier_uniform_as_jax():
    lin = tnn.Linear(512, 256, device="cpu")
    limit = math.sqrt(6.0 / (512 + 256))
    _check_moments(lin.weight.detach().numpy(), (-limit, limit), 0.0,
                   limit ** 2 / 3, "Linear.weight")
    assert torch.equal(lin.bias, torch.zeros(256))
    # the BERT classifier takes the same default (the JAX Linear's)
    clf = BertForSequenceClassification(bert_tiny(), num_classes=256,
                                        device="cpu").classifier
    limit = math.sqrt(6.0 / (128 + 256))
    _check_moments(clf.weight.detach().numpy(), (-limit, limit), 0.0,
                   limit ** 2 / 3, "classifier.weight")


def test_linear_std_keeps_the_normal_rule():
    lin = tnn.Linear(512, 256, std=0.02, device="cpu")
    _check_moments(lin.weight.detach().numpy(), None, 0.0, 0.02 ** 2,
                   "Linear(std=0.02).weight")
    assert torch.equal(lin.bias, torch.zeros(256))


def test_param_attr_and_global_initializer_order():
    lin = tnn.Linear(3, 2, weight_attr=TI.ParamAttr(
        initializer=TI.Constant(0.5)), bias_attr=False, device="cpu")
    assert torch.equal(lin.weight, torch.full((3, 2), 0.5))
    assert lin.bias is None
    TI.set_global_initializer(TI.Constant(2.0), TI.Constant(3.0))
    try:
        lin = tnn.Linear(3, 2, device="cpu")
        assert torch.equal(lin.weight, torch.full((3, 2), 2.0))
        assert torch.equal(lin.bias, torch.full((2,), 3.0))
        # a ParamAttr's initializer comes before the global one
        lin = tnn.Linear(3, 2, bias_attr=TI.ParamAttr(
            initializer=TI.Constant(-1.0)), device="cpu")
        assert torch.equal(lin.bias, torch.full((2,), -1.0))
        # a layer's own default comes first (BatchNorm's weight is ones)
        bn = tnn.BatchNorm2D(4, device="cpu")
        assert torch.equal(bn.weight, torch.ones(4))
        assert torch.equal(bn.bias, torch.full((4,), 3.0))
    finally:
        TI.set_global_initializer(None, None)
    assert not torch.equal(tnn.Linear(3, 2, device="cpu").weight,
                           torch.full((3, 2), 2.0))


def test_conv2d_draws_uniform_over_fan_in():
    conv = tnn.Conv2D(32, 64, 3, groups=2, device="cpu")
    bound = 1.0 / math.sqrt(32 * 9 // 2)
    assert tuple(conv.weight.shape) == (64, 16, 3, 3)
    _check_moments(conv.weight.detach().numpy(), (-bound, bound), 0.0,
                   bound ** 2 / 3, "Conv2D.weight")
    assert conv.bias.abs().max() <= bound
    assert tnn.Conv2D(3, 4, 3, bias_attr=False, device="cpu").bias is None
