"""``paddle.distribution``: the port of ``paddle_tpu/distribution/
__init__.py`` (reference python/paddle/distribution/: Normal, Uniform,
Categorical, Bernoulli, Beta, Dirichlet, Multinomial, Independent, the
transforms, TransformedDistribution, ``register_kl`` /
``kl_divergence``).

Densities, entropies and divergences are the JAX formulas, op for op, in
PyTorch.  Parameters that are not tensors become float32 tensors on the
device of the first tensor among them, else on the current device
(``cuda`` unless ``set_device("cpu")``).  Sampling takes a
``torch.Generator`` where the JAX methods take ``key=``; without one it
draws from the framework stream of the parameters' device
(``framework/random.py``).  The draws are torch's, not JAX's, so samples
agree with the JAX package in distribution only (a difference by
design): Gumbel-max for ``Categorical``, PyTorch's gamma sampler (with
its implicit reparameterization gradient) for ``Beta`` and
``Dirichlet``.  ``rsample`` is differentiable in the parameters.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import random as fw_random
from ..framework.dtype import as_tensor
from ..framework.errors import enforce

__all__ = ["Distribution", "Normal", "Uniform", "Categorical", "Bernoulli",
           "Beta", "Dirichlet", "Multinomial", "Independent",
           "TransformedDistribution", "kl_divergence", "register_kl",
           "Transform", "AffineTransform", "ExpTransform", "PowerTransform",
           "SigmoidTransform", "TanhTransform", "AbsTransform",
           "ChainTransform", "ExponentialFamily", "IndependentTransform",
           "ReshapeTransform", "SoftmaxTransform", "StackTransform",
           "StickBreakingTransform"]


def _arr(x, like=None) -> torch.Tensor:
    """A tensor as it is; anything else a float32 tensor on ``like``'s
    device (else the current one)."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(x, like=like, dtype=torch.float32)


def _params(*xs):
    return tuple(_arr(x, like=list(xs)) for x in xs)


def _gen(generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else fw_random.generator(
        device)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _bshape(*ts):
    return torch.broadcast_shapes(*(t.shape for t in ts))


class Distribution:
    def sample(self, shape: Sequence[int] = (), generator=None):
        raise NotImplementedError

    def rsample(self, shape: Sequence[int] = (), generator=None):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError


class Normal(Distribution):
    """Reference distribution/normal.py."""

    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return torch.square(self.scale)

    def sample(self, shape=(), generator=None):
        with torch.no_grad():
            return self.rsample(shape, generator)

    def rsample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.loc, self.scale)
        eps = torch.randn(shape, generator=_gen(generator, self.loc.device),
                          device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        var = torch.square(self.scale)
        return (-torch.square(_arr(value, self.loc) - self.loc) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(
            torch.broadcast_to(self.scale, _bshape(self.loc, self.scale)))

    def kl_divergence(self, other: "Normal"):
        var_ratio = torch.square(self.scale / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Uniform(Distribution):
    """Reference distribution/uniform.py: U[low, high)."""

    def __init__(self, low, high):
        self.low, self.high = _params(low, high)

    def sample(self, shape=(), generator=None):
        with torch.no_grad():
            return self.rsample(shape, generator)

    def rsample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.low, self.high)
        u = torch.rand(shape, generator=_gen(generator, self.low.device),
                       device=self.low.device, dtype=self.low.dtype)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        value = _arr(value, self.low)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


def _gumbel_argmax(logits, shape, generator):
    """Categorical draws of ``shape`` + batch shape by Gumbel-max."""
    full = tuple(shape) + tuple(logits.shape)
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(full, generator=_gen(generator, logits.device),
                   device=logits.device, dtype=logits.dtype)
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + g, dim=-1)


class Categorical(Distribution):
    """Reference distribution/categorical.py (logits parameterization)."""

    def __init__(self, logits=None, probs=None):
        if logits is None:
            logits = torch.log(torch.clamp(_arr(probs), min=1e-30))
        self.logits = _arr(logits)

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=(), generator=None):
        with torch.no_grad():
            return _gumbel_argmax(self.logits, shape, generator)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        idx = _arr(value, self.logits).long()
        logp = torch.broadcast_to(logp, idx.shape + logp.shape[-1:])
        return torch.gather(logp, -1, idx[..., None])[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl_divergence(self, other: "Categorical"):
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


class Bernoulli(Distribution):
    def __init__(self, probs):
        self.probs_ = torch.clamp(_arr(probs), 1e-7, 1 - 1e-7)

    def sample(self, shape=(), generator=None):
        p = self.probs_
        u = torch.rand(tuple(shape) + tuple(p.shape),
                       generator=_gen(generator, p.device), device=p.device,
                       dtype=p.dtype)
        return (u < p).to(torch.float32)

    def log_prob(self, value):
        v = _arr(value, self.probs_)
        return v * torch.log(self.probs_) + (1 - v) * torch.log1p(-self.probs_)

    def entropy(self):
        p = self.probs_
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))


def _gamma(conc, generator):
    return torch._standard_gamma(conc, generator=_gen(generator,
                                                      conc.device))


class Beta(Distribution):
    """Reference distribution/beta.py."""

    def __init__(self, alpha, beta):
        self.alpha, self.beta = _params(alpha, beta)

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    def sample(self, shape=(), generator=None):
        full = tuple(shape) + _bshape(self.alpha, self.beta)
        a = torch.broadcast_to(self.alpha, full)
        b = torch.broadcast_to(self.beta, full)
        ga = _gamma(a, generator)
        gb = _gamma(b, generator)
        return ga / (ga + gb)

    def log_prob(self, value):
        v = _arr(value, self.alpha)
        return ((self.alpha - 1) * torch.log(v)
                + (self.beta - 1) * torch.log1p(-v)
                - _betaln(self.alpha, self.beta))

    def entropy(self):
        a, b = self.alpha, self.beta
        return (_betaln(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(Distribution):
    """Reference distribution/dirichlet.py."""

    def __init__(self, concentration):
        self.concentration = _arr(concentration)

    def sample(self, shape=(), generator=None):
        c = self.concentration
        g = _gamma(torch.broadcast_to(c, tuple(shape) + tuple(c.shape)),
                   generator)
        return g / torch.sum(g, -1, keepdim=True)

    def log_prob(self, value):
        c = self.concentration
        v = _arr(value, c)
        norm = torch.sum(torch.lgamma(c), -1) - torch.lgamma(torch.sum(c, -1))
        return torch.sum((c - 1) * torch.log(v), -1) - norm

    def entropy(self):
        c = self.concentration
        c0 = torch.sum(c, -1)
        k = c.shape[-1]
        norm = torch.sum(torch.lgamma(c), -1) - torch.lgamma(c0)
        return (norm + (c0 - k) * torch.digamma(c0)
                - torch.sum((c - 1) * torch.digamma(c), -1))


class Multinomial(Distribution):
    """Reference distribution/multinomial.py: counts over k categories
    from ``total_count`` draws."""

    def __init__(self, total_count: int, probs):
        self.total_count = int(total_count)
        p = _arr(probs)
        self.probs = p / torch.sum(p, dim=-1, keepdim=True)

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def sample(self, shape=(), generator=None):
        """Counts of ``total_count`` categorical draws (Gumbel-max), summed
        by a scatter-add rather than the JAX one-hot."""
        logits = torch.log(torch.clamp(self.probs, min=1e-30))
        k = self.probs.shape[-1]
        with torch.no_grad():
            draws = _gumbel_argmax(logits, (self.total_count, *shape),
                                   generator)
        counts = torch.zeros(tuple(draws.shape[1:]) + (k,),
                             dtype=self.probs.dtype, device=draws.device)
        counts.scatter_add_(-1, draws.movedim(0, -1),
                            torch.ones(draws.movedim(0, -1).shape,
                                       dtype=counts.dtype,
                                       device=counts.device))
        return counts

    def log_prob(self, value):
        v = _arr(value, self.probs)
        n = torch.tensor(self.total_count + 1.0, dtype=v.dtype,
                         device=v.device)
        return (torch.lgamma(n) - torch.sum(torch.lgamma(v + 1.0), -1)
                + torch.sum(v * torch.log(torch.clamp(self.probs,
                                                      min=1e-30)), -1))

    def entropy(self):
        # the exact series: H = -log n! - n sum p_i log p_i
        #                        + sum_i sum_{x=0}^{n} Binom(n, x, p_i) log x!
        n = self.total_count
        p = self.probs
        x = torch.arange(n + 1, dtype=p.dtype, device=p.device)
        n1 = torch.tensor(n + 1.0, dtype=p.dtype, device=p.device)
        log_binom = (torch.lgamma(n1) - torch.lgamma(x + 1.0)
                     - torch.lgamma(n - x + 1.0))
        logp = torch.log(torch.clamp(p, min=1e-30))
        log1mp = torch.log(torch.clamp(1.0 - p, min=1e-30))
        pmf = torch.exp(log_binom + x * logp[..., None]
                        + (n - x) * log1mp[..., None])
        e_logfact = torch.sum(pmf * torch.lgamma(x + 1.0), dim=-1)
        return (-torch.lgamma(n1) - n * torch.sum(p * logp, -1)
                + torch.sum(e_logfact, -1))


class Independent(Distribution):
    """Reinterpret the rightmost batch dims as event dims (reference
    distribution/independent.py): log_prob and entropy sum over them."""

    def __init__(self, base: Distribution,
                 reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

    def sample(self, shape=(), generator=None):
        return self.base.sample(shape, generator)

    def rsample(self, shape=(), generator=None):
        return self.base.rsample(shape, generator)

    def _sum(self, v):
        return torch.sum(v, dim=tuple(range(-self.reinterpreted_batch_ndims,
                                            0)))

    def log_prob(self, value):
        return self._sum(self.base.log_prob(value))

    def entropy(self):
        return self._sum(self.base.entropy())


# ---------------------------------------------------------------------------
# Transforms (reference distribution/transform.py): bijectors with
# forward / inverse / log-det for TransformedDistribution
# ---------------------------------------------------------------------------
class Transform:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def __call__(self, x):
        return self.forward(x)


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def forward(self, x):
        return self.loc + self.scale * _arr(x, self.loc)

    def inverse(self, y):
        return (_arr(y, self.loc) - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        return torch.broadcast_to(torch.log(torch.abs(self.scale)),
                                  _arr(x, self.loc).shape)


class ExpTransform(Transform):
    def forward(self, x):
        return torch.exp(_arr(x))

    def inverse(self, y):
        return torch.log(_arr(y))

    def forward_log_det_jacobian(self, x):
        return _arr(x)


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _arr(power)

    def forward(self, x):
        return torch.pow(_arr(x, self.power), self.power)

    def inverse(self, y):
        return torch.pow(_arr(y, self.power), 1.0 / self.power)

    def forward_log_det_jacobian(self, x):
        x = _arr(x, self.power)
        return torch.log(torch.abs(self.power
                                   * torch.pow(x, self.power - 1)))


class SigmoidTransform(Transform):
    def forward(self, x):
        return torch.sigmoid(_arr(x))

    def inverse(self, y):
        y = _arr(y)
        return torch.log(y) - torch.log1p(-y)

    def forward_log_det_jacobian(self, x):
        x = _arr(x)
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def forward(self, x):
        return torch.tanh(_arr(x))

    def inverse(self, y):
        return torch.atanh(_arr(y))

    def forward_log_det_jacobian(self, x):
        x = _arr(x)
        # log(1 - tanh^2 x) in a numerically stable form
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class AbsTransform(Transform):
    def forward(self, x):
        return torch.abs(_arr(x))

    def inverse(self, y):   # principal branch
        return _arr(y)

    def forward_log_det_jacobian(self, x):
        return torch.zeros_like(_arr(x))


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t.forward_log_det_jacobian(x)
            x = t.forward(x)
        return total


class TransformedDistribution(Distribution):
    """A base distribution pushed through transforms (reference
    distribution/transformed_distribution.py): sample = T(base.sample());
    log_prob(y) = base.log_prob(T^-1(y)) - log|det J_T(T^-1(y))|."""

    def __init__(self, base: Distribution, transforms):
        self.base = base
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transform = ChainTransform(list(transforms))

    def sample(self, shape=(), generator=None):
        return self.transform.forward(self.base.sample(shape, generator))

    def rsample(self, shape=(), generator=None):
        return self.transform.forward(self.base.rsample(shape, generator))

    def log_prob(self, value):
        x = self.transform.inverse(value)
        return (self.base.log_prob(x)
                - self.transform.forward_log_det_jacobian(x))


# ---------------------------------------------------------------------------
# The kl registry (reference distribution/kl.py: register_kl and the
# most-specific dispatch)
# ---------------------------------------------------------------------------
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    """Decorator registering a pairwise kl rule (reference kl.py:40)."""
    def wrap(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return wrap


def kl_divergence(p: Distribution, q: Distribution):
    """Dispatch to the most specific registered pair (reference kl.py:26);
    else a same-type ``kl_divergence`` method."""
    matches = [(pc, qc) for (pc, qc) in _KL_REGISTRY
               if isinstance(p, pc) and isinstance(q, qc)]
    if matches:
        def depth(pair):
            return (len(type(p).__mro__) - type(p).__mro__.index(pair[0]),
                    len(type(q).__mro__) - type(q).__mro__.index(pair[1]))
        return _KL_REGISTRY[max(matches, key=depth)](p, q)
    if hasattr(p, "kl_divergence") and type(p) is type(q):
        return p.kl_divergence(q)
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    return p.kl_divergence(q)


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    return p.kl_divergence(q)


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    a, b = p.probs_, q.probs_
    return (a * (torch.log(a) - torch.log(b))
            + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)))


@register_kl(Beta, Beta)
def _kl_beta(p, q):
    a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
    return (_betaln(a2, b2) - _betaln(a1, b1)
            + (a1 - a2) * torch.digamma(a1) + (b1 - b2) * torch.digamma(b1)
            + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(p, q):
    c1, c2 = p.concentration, q.concentration
    s1 = torch.sum(c1, -1)
    return (torch.lgamma(s1) - torch.sum(torch.lgamma(c1), -1)
            - torch.lgamma(torch.sum(c2, -1))
            + torch.sum(torch.lgamma(c2), -1)
            + torch.sum((c1 - c2) * (torch.digamma(c1)
                                     - torch.digamma(s1)[..., None]), -1))


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    kl = torch.log(q.high - q.low) - torch.log(p.high - p.low)
    contained = (q.low <= p.low) & (p.high <= q.high)
    return torch.where(contained, kl, torch.full_like(kl, math.inf))


class ExponentialFamily(Distribution):
    """Base of exponential-family distributions (reference
    distribution/exponential_family.py): subclasses give the natural
    parameters and the log-normalizer, and the entropy follows from the
    Bregman identity, H = A(eta) - eta . grad A(eta) - E[carrier], the
    gradient by autograd, elementwise over batched parameters."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        nat = [torch.as_tensor(p) for p in self._natural_parameters]
        leaves = [p if p.requires_grad else p.detach().requires_grad_(True)
                  for p in nat]
        with torch.enable_grad():
            log_a = self._log_normalizer(*leaves)
            grads = torch.autograd.grad(
                log_a.sum(), leaves,
                create_graph=any(p.requires_grad for p in nat))
        ent = log_a - self._mean_carrier_measure
        for p, g in zip(leaves, grads):
            ent = ent - p * g
        return ent if any(p.requires_grad for p in nat) else ent.detach()


class IndependentTransform(Transform):
    """Reinterpret the rightmost ``reinterpreted_batch_rank`` dims as
    event dims: log-dets sum over them."""

    def __init__(self, base: Transform, reinterpreted_batch_rank: int):
        self._base = base
        self._rank = int(reinterpreted_batch_rank)

    def forward(self, x):
        return self._base.forward(x)

    def inverse(self, y):
        return self._base.inverse(y)

    def _sum_rightmost(self, v):
        for _ in range(self._rank):
            v = torch.sum(v, dim=-1)
        return v

    def forward_log_det_jacobian(self, x):
        return self._sum_rightmost(self._base.forward_log_det_jacobian(x))


class ReshapeTransform(Transform):
    """Event reshape; volume preserving, log-det 0."""

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        enforce(int(np.prod(self.in_event_shape))
                == int(np.prod(self.out_event_shape)),
                "reshape must preserve the event volume")

    def forward(self, x):
        x = _arr(x)
        batch = tuple(x.shape[: x.ndim - len(self.in_event_shape)])
        return x.reshape(batch + self.out_event_shape)

    def inverse(self, y):
        y = _arr(y)
        batch = tuple(y.shape[: y.ndim - len(self.out_event_shape)])
        return y.reshape(batch + self.in_event_shape)

    def forward_log_det_jacobian(self, x):
        x = _arr(x)
        batch = tuple(x.shape[: x.ndim - len(self.in_event_shape)])
        return torch.zeros(batch, dtype=torch.float32, device=x.device)


class SoftmaxTransform(Transform):
    """x -> softmax over the last dim (not bijective on R^n: the inverse
    is log, up to an additive constant)."""

    def forward(self, x):
        return torch.softmax(_arr(x), dim=-1)

    def inverse(self, y):
        return torch.log(_arr(y))


class StackTransform(Transform):
    """A list of transforms, one per slice along ``axis``."""

    def __init__(self, transforms, axis: int = 0):
        self._transforms = list(transforms)
        self._axis = axis

    def _map(self, fn_name, v):
        v = _arr(v)
        slices = torch.tensor_split(v, len(self._transforms), dim=self._axis)
        parts = [getattr(t, fn_name)(s.squeeze(self._axis))
                 for t, s in zip(self._transforms, slices)]
        return torch.stack(parts, dim=self._axis)

    def forward(self, x):
        return self._map("forward", x)

    def inverse(self, y):
        return self._map("inverse", y)

    def forward_log_det_jacobian(self, x):
        return self._map("forward_log_det_jacobian", x)


def _stick_offset(k, like):
    return torch.log(torch.tensor(float(k), dtype=torch.float32,
                                  device=like.device)
                     - torch.arange(k, dtype=torch.float32,
                                    device=like.device))


class StickBreakingTransform(Transform):
    """R^k -> the interior of the (k+1)-simplex by stick breaking."""

    def forward(self, x):
        x = _arr(x).to(torch.float32)
        z = torch.sigmoid(x - _stick_offset(x.shape[-1], x))
        one_minus = torch.cumprod(1 - z, dim=-1)
        lead = torch.cat([torch.ones_like(one_minus[..., :1]),
                          one_minus[..., :-1]], dim=-1)
        return torch.cat([z * lead, one_minus[..., -1:]], dim=-1)

    def inverse(self, y):
        y = _arr(y).to(torch.float32)
        k = y.shape[-1] - 1
        cum = torch.cat([torch.zeros_like(y[..., :1]),
                         torch.cumsum(y[..., :-1], -1)], dim=-1)[..., :-1]
        z = y[..., :-1] / torch.clamp(1 - cum, min=1e-30)
        return (torch.log(z / torch.clamp(1 - z, min=1e-30))
                + _stick_offset(k, y))

    def forward_log_det_jacobian(self, x):
        x = _arr(x).to(torch.float32)
        z = torch.sigmoid(x - _stick_offset(x.shape[-1], x))
        one_minus = torch.cumprod(1 - z, dim=-1)
        lead = torch.cat([torch.ones_like(one_minus[..., :1]),
                          one_minus[..., :-1]], dim=-1)
        return torch.sum(torch.log(z) + torch.log1p(-z) + torch.log(lead),
                         dim=-1)
