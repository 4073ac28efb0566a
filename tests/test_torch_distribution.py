"""``paddle_tpu_torch.distribution`` against ``paddle_tpu.distribution`` on
the CPU: the same seeded numpy parameters and values into both packages.

Densities, entropies, means, KL divergences and every transform agree
within float32 rounding (``RTOL = ATOL = 2e-5``; lgamma / digamma are
different float32 implementations in XLA and PyTorch).  Samples are drawn
from torch's streams, not JAX's keys (a difference by design, pinned
below): they are held by their moments, within 4 standard errors, and
``rsample``'s gradients by their closed forms.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distribution as jd
import paddle_tpu_torch.distribution as td
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.framework.dtype import device_scope

RTOL = ATOL = 2e-5
rng = np.random.RandomState(0)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    # a hybrid mesh left set by an earlier JAX test file on this xdist
    # worker would shard the JAX side (and refuse its ServingEngine in
    # later files); these tests compare single-device runs
    from paddle_tpu.distributed import topology
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(None)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with device_scope("cpu"):
        yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol)


def _f32(*shape, lo=None, hi=None):
    if lo is None:
        return rng.randn(*shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


# (name, ctor args, a value inside the support)
PROBS = _f32(3, 5, lo=0.05, hi=1.0)
PROBS /= PROBS.sum(-1, keepdims=True)
CASES = {
    "Normal": (("Normal", _f32(4, 3), _f32(4, 3, lo=0.5, hi=2.0)),
               _f32(4, 3)),
    "Uniform": (("Uniform", _f32(4, lo=-2, hi=0), _f32(4, lo=0.5, hi=3)),
                _f32(4, lo=0.0, hi=0.4)),
    "Categorical": (("Categorical", _f32(3, 5)),
                    np.array([0, 4, 2], np.int64)),
    "Bernoulli": (("Bernoulli", _f32(6, lo=0.1, hi=0.9)),
                  np.array([0, 1, 1, 0, 1, 0], np.float32)),
    "Beta": (("Beta", _f32(5, lo=0.5, hi=4), _f32(5, lo=0.5, hi=4)),
             _f32(5, lo=0.1, hi=0.9)),
    "Dirichlet": (("Dirichlet", _f32(3, 4, lo=0.5, hi=3)),
                  np.full((3, 4), 0.25, np.float32)),
    "Multinomial": (("Multinomial", 7, PROBS),
                    np.array([[1, 2, 0, 3, 1], [7, 0, 0, 0, 0],
                              [2, 2, 1, 1, 1]], np.float32)),
}


def _build(mod, spec):
    name, *args = spec
    return getattr(mod, name)(*args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_prob_prob_and_entropy_match_jax(name):
    spec, value = CASES[name]
    jdist, tdist = _build(jd, spec), _build(td, spec)
    close(tdist.log_prob(value), jdist.log_prob(jnp.asarray(value)))
    close(tdist.prob(value), jdist.prob(jnp.asarray(value)))
    close(tdist.entropy(), jdist.entropy())


def test_means_and_variances_match_jax():
    for name in ("Normal", "Beta", "Multinomial"):
        spec, _ = CASES[name]
        close(_build(td, spec).mean, _build(jd, spec).mean)
    for name in ("Normal", "Multinomial"):
        spec, _ = CASES[name]
        close(_build(td, spec).variance, _build(jd, spec).variance)
    logits = _f32(2, 6)
    close(td.Categorical(logits).probs, jd.Categorical(logits).probs)
    close(td.Categorical(probs=PROBS).logits,
          jd.Categorical(probs=PROBS).logits)


def test_uniform_outside_support_is_minus_inf():
    t = td.Uniform(0.0, 1.0).log_prob(np.array([-0.5, 0.5, 1.0], np.float32))
    j = jd.Uniform(0.0, 1.0).log_prob(jnp.array([-0.5, 0.5, 1.0]))
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_independent_sums_the_reinterpreted_dims():
    loc, scale = _f32(2, 3, 4), _f32(2, 3, 4, lo=0.5, hi=2)
    value = _f32(2, 3, 4)
    for ndims in (1, 2):
        t = td.Independent(td.Normal(loc, scale), ndims)
        j = jd.Independent(jd.Normal(loc, scale), ndims)
        close(t.log_prob(value), j.log_prob(jnp.asarray(value)))
        close(t.entropy(), j.entropy())


KL_PAIRS = {
    "Normal": (("Normal", _f32(5), _f32(5, lo=0.5, hi=2)),
               ("Normal", _f32(5), _f32(5, lo=0.5, hi=2))),
    "Categorical": (("Categorical", _f32(4, 6)), ("Categorical", _f32(4, 6))),
    "Bernoulli": (("Bernoulli", _f32(5, lo=0.1, hi=0.9)),
                  ("Bernoulli", _f32(5, lo=0.1, hi=0.9))),
    "Beta": (("Beta", _f32(5, lo=0.5, hi=4), _f32(5, lo=0.5, hi=4)),
             ("Beta", _f32(5, lo=0.5, hi=4), _f32(5, lo=0.5, hi=4))),
    "Dirichlet": (("Dirichlet", _f32(3, 4, lo=0.5, hi=3)),
                  ("Dirichlet", _f32(3, 4, lo=0.5, hi=3))),
    "Uniform": (("Uniform", np.array([0.0, -1.0, 0.2], np.float32),
                 np.array([1.0, 0.5, 2.0], np.float32)),
                ("Uniform", np.array([-1.0, -2.0, 0.5], np.float32),
                 np.array([2.0, 1.0, 3.0], np.float32))),
}


@pytest.mark.parametrize("name", sorted(KL_PAIRS))
def test_registered_kl_pairs_match_jax(name):
    p, q = KL_PAIRS[name]
    t = td.kl_divergence(_build(td, p), _build(td, q))
    j = jd.kl_divergence(_build(jd, p), _build(jd, q))
    # the Uniform pair holds one uncontained support: +inf in both
    np.testing.assert_array_equal(np.isinf(_np(t)), np.isinf(np.asarray(j)))
    fin = np.isfinite(np.asarray(j))
    close(_np(t)[fin], np.asarray(j)[fin])


def test_kl_dispatch_takes_the_most_specific_pair():
    class T(td.Normal):
        pass

    @td.register_kl(T, td.Normal)
    def _special(p, q):
        return torch.full((), 42.0)

    try:
        assert float(td.kl_divergence(T(0.0, 1.0), td.Normal(0.0, 1.0))) \
            == 42.0
        # the base pair still serves a plain Normal
        assert float(td.kl_divergence(td.Normal(0.0, 1.0),
                                      td.Normal(0.0, 1.0))) == 0.0
    finally:
        td._KL_REGISTRY.pop((T, td.Normal))
    with pytest.raises(NotImplementedError):
        td.kl_divergence(td.Normal(0.0, 1.0), td.Beta(1.0, 1.0))


X = _f32(3, 4, lo=-1.5, hi=1.5)
AFFINE = (_f32(4), _f32(4, lo=0.5, hi=2))
TRANSFORMS = {
    "Affine": (lambda m: m.AffineTransform(*AFFINE), X),
    "Exp": (lambda m: m.ExpTransform(), X),
    "Power": (lambda m: m.PowerTransform(np.float32(3.0)),
              _f32(3, 4, lo=0.2, hi=2)),
    "Sigmoid": (lambda m: m.SigmoidTransform(), X),
    "Tanh": (lambda m: m.TanhTransform(), X),
    "Abs": (lambda m: m.AbsTransform(), _f32(3, 4, lo=0.1, hi=2)),
    "Chain": (lambda m: m.ChainTransform([m.AffineTransform(0.5, 2.0),
                                          m.TanhTransform()]), X),
    "Independent": (lambda m: m.IndependentTransform(m.ExpTransform(), 1),
                    X),
    "Reshape": (lambda m: m.ReshapeTransform((4,), (2, 2)), X),
    "Stack": (lambda m: m.StackTransform([m.ExpTransform(),
                                          m.TanhTransform()], axis=1),
              _f32(3, 2, lo=-1, hi=1)),
    "StickBreaking": (lambda m: m.StickBreakingTransform(), X),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    make, x = TRANSFORMS[name]
    jt, tt = make(jd), make(td)
    y_j = jt.forward(jnp.asarray(x))
    y_t = tt.forward(x)
    close(y_t, y_j)
    close(tt.inverse(_np(y_t)), jt.inverse(y_j), rtol=1e-4, atol=1e-4)
    close(tt.forward_log_det_jacobian(x),
          jt.forward_log_det_jacobian(jnp.asarray(x)), rtol=1e-4, atol=1e-4)
    close(tt(x), jt(jnp.asarray(x)))


def test_softmax_transform_and_inverse_log_det_match_jax():
    x = _f32(3, 5)
    close(td.SoftmaxTransform().forward(x),
          jd.SoftmaxTransform().forward(jnp.asarray(x)))
    y = np.abs(x) + 0.1
    close(td.SoftmaxTransform().inverse(y),
          jd.SoftmaxTransform().inverse(jnp.asarray(y)))
    t = td.AffineTransform(1.0, 3.0)
    close(t.inverse_log_det_jacobian(x),
          jd.AffineTransform(1.0, 3.0).inverse_log_det_jacobian(
              jnp.asarray(x)))


def test_transformed_distribution_log_prob_matches_jax():
    loc, scale = _f32(4), _f32(4, lo=0.5, hi=1.5)
    y = _f32(4, lo=0.2, hi=3.0)
    t = td.TransformedDistribution(td.Normal(loc, scale),
                                   [td.ExpTransform(),
                                    td.AffineTransform(0.0, 2.0)])
    j = jd.TransformedDistribution(jd.Normal(loc, scale),
                                   [jd.ExpTransform(),
                                    jd.AffineTransform(0.0, 2.0)])
    close(t.log_prob(y), j.log_prob(jnp.asarray(y)))


def test_exponential_family_entropy_is_the_jax_bregman_identity():
    # an exponential distribution: eta = -rate, A(eta) = -log(-eta)
    def make(mod, backend):
        class Exponential(mod.ExponentialFamily):
            def __init__(self, rate):
                self.rate = rate

            @property
            def _natural_parameters(self):
                return (-self.rate,)

            def _log_normalizer(self, eta):
                return -backend.log(-eta)
        return Exponential

    rate = _f32(5, lo=0.5, hi=3)
    t = make(td, torch)(torch.from_numpy(rate)).entropy()
    j = make(jd, jnp)(jnp.asarray(rate)).entropy()
    close(t, j)
    close(t, 1.0 - np.log(rate))          # the closed form


# -- sampling: torch's streams, held by moments ---------------------------
N = 20000


def _z(samples, mean, var):
    """|sample mean - mean| in standard errors, per element."""
    s = _np(samples).astype(np.float64)
    return np.abs(s.mean(0) - np.asarray(mean)) / np.sqrt(
        np.asarray(var) / s.shape[0])


def _moments_case(name):
    gen = torch.Generator().manual_seed(7)
    if name == "Normal":
        d = td.Normal(np.float32([0.5, -1.0]), np.float32([1.0, 2.0]))
        return d.sample((N,), generator=gen), [0.5, -1.0], [1.0, 4.0]
    if name == "Uniform":
        d = td.Uniform(np.float32([0.0, -2.0]), np.float32([1.0, 4.0]))
        return (d.sample((N,), generator=gen), [0.5, 1.0],
                [1 / 12, 36 / 12])
    if name == "Bernoulli":
        p = np.float32([0.2, 0.7])
        return (td.Bernoulli(p).sample((N,), generator=gen), p,
                p * (1 - p))
    if name == "Categorical":
        p = np.float32([0.1, 0.2, 0.3, 0.4])
        s = td.Categorical(probs=p).sample((N,), generator=gen)
        onehot = torch.nn.functional.one_hot(s, 4).float()
        return onehot, p, p * (1 - p)
    if name == "Beta":
        a, b = np.float32([2.0, 0.5]), np.float32([3.0, 0.5])
        var = a * b / ((a + b) ** 2 * (a + b + 1))
        return (td.Beta(a, b).sample((N,), generator=gen), a / (a + b),
                var)
    if name == "Dirichlet":
        c = np.float32([1.0, 2.0, 3.0])
        c0 = c.sum()
        var = c * (c0 - c) / (c0 ** 2 * (c0 + 1))
        return td.Dirichlet(c).sample((N,), generator=gen), c / c0, var
    if name == "Multinomial":
        p = np.float32([0.2, 0.3, 0.5])
        s = td.Multinomial(10, p).sample((N,), generator=gen)
        assert torch.all(s.sum(-1) == 10)
        return s, 10 * p, 10 * p * (1 - p)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["Normal", "Uniform", "Bernoulli",
                                  "Categorical", "Beta", "Dirichlet",
                                  "Multinomial"])
def test_sample_moments_within_four_standard_errors(name):
    samples, mean, var = _moments_case(name)
    assert np.all(_z(samples, mean, var) < 4.0), name


def test_samples_differ_from_jax_by_design_but_repeat_per_generator():
    # torch's Philox and JAX's threefry give other numbers from one seed;
    # the port repeats itself for one generator seed and for one
    # framework seed
    d = td.Normal(np.zeros(8, np.float32), np.ones(8, np.float32))
    a = d.sample((3,), generator=torch.Generator().manual_seed(3))
    b = d.sample((3,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    fw_random.seed(11)
    c = d.sample((3,))
    fw_random.seed(11)
    assert torch.equal(c, d.sample((3,)))
    import jax
    j = jd.Normal(np.zeros(8, np.float32),
                  np.ones(8, np.float32)).sample((3,), key=jax.random.key(3))
    assert not np.allclose(_np(a), np.asarray(j))


def test_rsample_gradients_are_the_reparameterization_formulas():
    gen = torch.Generator().manual_seed(5)
    loc = torch.tensor([0.3, -0.2], requires_grad=True)
    scale = torch.tensor([1.5, 0.5], requires_grad=True)
    x = td.Normal(loc, scale).rsample((64,), generator=gen)
    x.sum().backward()
    eps = (x.detach() - loc.detach()) / scale.detach()
    close(loc.grad, [64.0, 64.0])
    close(scale.grad, eps.sum(0), rtol=1e-5, atol=1e-4)

    low = torch.tensor([0.0, -1.0], requires_grad=True)
    high = torch.tensor([2.0, 3.0], requires_grad=True)
    u = td.Uniform(low, high).rsample((64,), generator=gen)
    u.sum().backward()
    frac = (u.detach() - low.detach()) / (high.detach() - low.detach())
    close(low.grad, (1 - frac).sum(0), rtol=1e-5, atol=1e-4)
    close(high.grad, frac.sum(0), rtol=1e-5, atol=1e-4)

    loc2 = torch.tensor([0.1], requires_grad=True)
    y = td.TransformedDistribution(td.Normal(loc2, 0.5),
                                   td.ExpTransform()).rsample(
        (32,), generator=gen)
    y.sum().backward()
    close(loc2.grad, [float(y.detach().sum())], rtol=1e-5, atol=1e-4)
    assert td.Independent(td.Normal(loc2, 0.5), 1).rsample(
        (2,), generator=gen).shape == (2, 1)


def test_parameters_follow_a_given_tensor_device():
    loc = torch.zeros(3, dtype=torch.float64)
    d = td.Normal(loc, np.float32(1.0))
    assert d.scale.device == loc.device and d.loc.dtype == torch.float64
    assert math.isclose(float(d.log_prob(0.0)[0]),
                        -0.5 * math.log(2 * math.pi), rel_tol=1e-12)
