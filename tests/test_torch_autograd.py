"""The port's ``autograd`` (``paddle_tpu_torch/autograd``) against the JAX
package's on the CPU, on the same numpy inputs: ``grad``,
``value_and_grad`` (its ``(value, grad)`` order, with and without aux),
``jacobian``, ``hessian``, ``vjp``, ``jvp``, a user ``PyLayer``,
``no_grad`` and ``backward``'s refusal.  float32 on both sides: 1e-5
relative, 1e-6 absolute."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.autograd as jag
import paddle_tpu_torch as tpt
import paddle_tpu_torch.autograd as tag

RTOL, ATOL = 1e-5, 1e-6


def _x(seed=0, *shape):
    return np.random.RandomState(seed).randn(*(shape or (5,))).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _f_t(x, w):
    return torch.sum(torch.tanh(x * w) ** 2)


def _f_j(x, w):
    return jnp.sum(jnp.tanh(x * w) ** 2)


@pytest.mark.parametrize("argnums", [0, 1, (0, 1), [0, 1]])
def test_grad(argnums):
    x, w = _x(0), _x(1)
    got = tag.grad(_f_t, argnums=argnums)(torch.as_tensor(x),
                                          torch.as_tensor(w))
    want = jag.grad(_f_j, argnums=argnums)(jnp.asarray(x), jnp.asarray(w))
    if isinstance(argnums, int):
        got, want = (got,), (want,)
    for g, j in zip(got, want):
        _close(g, j)
    assert tpt.grad is tag.grad


def test_value_and_grad_order_is_value_first():
    x, w = _x(0), _x(1)
    value, g = tag.value_and_grad(_f_t)(torch.as_tensor(x),
                                        torch.as_tensor(w))
    jvalue, jg = jag.value_and_grad(_f_j)(jnp.asarray(x), jnp.asarray(w))
    assert value.dim() == 0 and g.shape == (5,)
    _close(value, jvalue)
    _close(g, jg)


def test_value_and_grad_with_aux():
    x = _x(2)

    def ft(a):
        return torch.sum(a ** 3), a.mean()

    def fj(a):
        return jnp.sum(a ** 3), a.mean()
    (value, aux), g = tag.value_and_grad(ft, has_aux=True)(torch.as_tensor(x))
    (jvalue, jaux), jg = jag.value_and_grad(fj, has_aux=True)(jnp.asarray(x))
    for got, want in ((value, jvalue), (aux, jaux), (g, jg)):
        _close(got, want)
    g2, aux2 = tag.grad(ft, has_aux=True)(torch.as_tensor(x))
    _close(g2, jg)
    _close(aux2, jaux)


def test_jacobian_and_hessian():
    x = _x(3, 4)
    m = np.random.RandomState(4).randn(3, 4).astype(np.float32)

    def vt(a):
        return torch.sin(torch.as_tensor(m) @ a)

    def vj(a):
        return jnp.sin(jnp.asarray(m) @ a)
    _close(tag.jacobian(vt)(torch.as_tensor(x)), jag.jacobian(vj)(
        jnp.asarray(x)))
    _close(tag.hessian(lambda a: torch.sum(vt(a) ** 2))(torch.as_tensor(x)),
           jag.hessian(lambda a: jnp.sum(vj(a) ** 2))(jnp.asarray(x)))
    with pytest.raises(tpt.UnimplementedError):
        tag.jacobian(vt, holomorphic=True)


def test_vjp_and_jvp():
    x, w = _x(5), _x(6)
    ct, tan = _x(7), _x(8)

    def ft(a):
        return torch.exp(a) * torch.as_tensor(w)

    def fj(a):
        return jnp.exp(a) * jnp.asarray(w)
    out, fn = tag.vjp(ft, torch.as_tensor(x))
    jout, jfn = jag.vjp(fj, jnp.asarray(x))
    _close(out, jout)
    _close(fn(torch.as_tensor(ct))[0], jfn(jnp.asarray(ct))[0])
    out, t = tag.jvp(ft, (torch.as_tensor(x),), (torch.as_tensor(tan),))
    jout, jt = jag.jvp(fj, (jnp.asarray(x),), (jnp.asarray(tan),))
    _close(out, jout)
    _close(t, jt)
    out, fn, aux = tag.vjp(lambda a: (ft(a), a.sum()), torch.as_tensor(x),
                           has_aux=True)
    _close(aux, x.sum())


class _TCube(tag.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        ctx.attrs["k"] = k
        return x ** 3 * k

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor
        # a deliberately different gradient than the forward's, so the
        # test sees that the user's backward ran
        return 2 * x ** 2 * g * ctx.attrs["k"]


class _JCube(jag.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        return x ** 3 * k

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor
        return 2 * x ** 2 * g * 1.5, None


def test_pylayer_against_jax():
    x = _x(9)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = _TCube.apply(xt, 1.5)
    y.sum().backward()
    jy = _JCube.apply(jnp.asarray(x), 1.5)
    jg = jag.grad(lambda a: jnp.sum(_JCube.apply(a, 1.5)))(jnp.asarray(x))
    _close(y, jy)
    _close(xt.grad, jg)


def test_pylayer_context():
    ctx = tag.PyLayerContext()
    ctx.save_for_backward(1, 2)
    assert ctx.saved_tensor == (1, 2) == ctx.saved_tensors
    assert ctx.attrs == {}


def test_no_grad_is_torchs():
    assert tag.no_grad is torch.no_grad is tpt.no_grad
    x = torch.ones(3, requires_grad=True)
    with tag.no_grad():
        assert not (x * 2).requires_grad

    @tag.no_grad()
    def f(a):
        return a * 2
    assert not f(x).requires_grad
    assert (x * 2).requires_grad


def test_backward_raises_and_names_the_ports_way():
    with pytest.raises(RuntimeError, match=r"Tensor\.backward\(\)"):
        tag.backward([torch.ones(1)])
    with pytest.raises(RuntimeError):
        jag.backward([jnp.ones(1)])
