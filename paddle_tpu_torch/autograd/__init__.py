"""Autograd: the port of ``paddle_tpu/autograd`` (reference
python/paddle/autograd/: PyLayer py_layer.py:202, the functional vjp / jvp /
jacobian / hessian of functional.py).

The functional transforms run on ``torch.func`` with the JAX package's
signatures and return conventions: ``value_and_grad`` returns
``(value, grad)`` (``torch.func.grad_and_value`` returns them the other
way round), ``jacobian`` is reverse mode, ``hessian`` forward over reverse.
``no_grad`` is ``torch.no_grad`` (a context and a decorator); ``PyLayer``
runs a user's forward and backward as a ``torch.autograd.Function``.

``backward`` keeps the JAX package's contract and raises: in the port a
gradient comes from ``Tensor.backward()`` (or ``grad`` over a function).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.func

from ..framework.errors import UnimplementedError

__all__ = ["grad", "value_and_grad", "vjp", "jvp", "jacobian", "hessian",
           "PyLayer", "PyLayerContext", "no_grad", "backward"]


def _argnums(argnums):
    return tuple(argnums) if isinstance(argnums, list) else argnums


def _real_only(holomorphic: bool, name: str) -> None:
    if holomorphic:
        raise UnimplementedError(
            f"{name}(holomorphic=True) is not supported by the PyTorch port")


def grad(fn: Callable, argnums=0, has_aux: bool = False):
    return torch.func.grad(fn, argnums=_argnums(argnums), has_aux=has_aux)


def value_and_grad(fn: Callable, argnums=0, has_aux: bool = False):
    """``(value, grad)``, and ``((value, aux), grad)`` with ``has_aux``, as
    ``jax.value_and_grad`` returns them."""
    inner = torch.func.grad_and_value(fn, argnums=_argnums(argnums),
                                      has_aux=has_aux)

    def wrapped(*args, **kwargs):
        g, value = inner(*args, **kwargs)
        return value, g
    return wrapped


def vjp(fun: Callable, *primals, has_aux: bool = False, reduce_axes=()):
    """``(out, vjp_fn)`` (and ``aux`` with ``has_aux``); ``vjp_fn(ct)``
    returns one cotangent per primal."""
    if reduce_axes:
        raise UnimplementedError("vjp: reduce_axes names JAX mesh axes; "
                                 "the PyTorch port has none")
    return torch.func.vjp(fun, *primals, has_aux=has_aux)


def jvp(fun: Callable, primals, tangents, has_aux: bool = False):
    return torch.func.jvp(fun, tuple(primals), tuple(tangents),
                          has_aux=has_aux)


def jacobian(fun: Callable, argnums=0, has_aux: bool = False,
             holomorphic: bool = False, allow_int: bool = False):
    """Reverse-mode Jacobian (``jax.jacrev``)."""
    _real_only(holomorphic, "jacobian")
    return torch.func.jacrev(fun, argnums=_argnums(argnums), has_aux=has_aux)


def hessian(fun: Callable, argnums=0, has_aux: bool = False,
            holomorphic: bool = False):
    """Forward over reverse, as ``jax.hessian``."""
    _real_only(holomorphic, "hessian")
    argnums = _argnums(argnums)
    return torch.func.jacfwd(
        torch.func.jacrev(fun, argnums=argnums, has_aux=has_aux),
        argnums=argnums, has_aux=has_aux)


no_grad = torch.no_grad


class PyLayerContext:
    """Reference autograd/py_layer.py:23 PyLayerContext."""

    def __init__(self):
        self._saved = ()
        self.attrs: Dict[str, Any] = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    saved_tensors = saved_tensor


class _PyLayerMeta(type):
    """Builds each subclass's ``torch.autograd.Function``: its forward runs
    the user's ``forward(ctx, *args)``, its backward the user's
    ``backward(ctx, *grads)`` with the same context (saved tensors and
    ``attrs``); a backward that returns fewer gradients than there are
    inputs gives the rest none."""

    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)
        if name == "PyLayer":
            return

        class _Function(torch.autograd.Function):
            @staticmethod
            def forward(fctx, *args):
                fctx.n_inputs = len(args)
                ctx = PyLayerContext()
                out = cls.forward(ctx, *args)
                saved = ctx._saved
                if all(isinstance(t, torch.Tensor) for t in saved):
                    fctx.save_for_backward(*saved)
                    ctx._saved = None
                fctx.pylayer_ctx = ctx
                return out

            @staticmethod
            def backward(fctx, *grads):
                ctx = fctx.pylayer_ctx
                if ctx._saved is None:
                    ctx._saved = fctx.saved_tensors
                out = cls.backward(ctx, *grads)
                if not isinstance(out, tuple):
                    out = (out,)
                return out + (None,) * (fctx.n_inputs - len(out))

        _Function.__name__ = f"{name}Function"
        cls._impl = _Function


class PyLayer(metaclass=_PyLayerMeta):
    """A user-defined forward / backward (reference
    autograd/py_layer.py:202)::

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x ** 3

            @staticmethod
            def backward(ctx, grad):
                (x,) = ctx.saved_tensor
                return 3 * x ** 2 * grad

        y = Cube.apply(x)
    """

    @classmethod
    def apply(cls, *args):
        return cls._impl.apply(*args)

    @staticmethod
    def forward(ctx, *args):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Reference paddle.autograd.backward.  The port keeps the JAX
    package's contract: this entry point raises.  Gradients come from
    ``Tensor.backward()`` on the loss (torch's tape), or from ``grad`` /
    ``value_and_grad`` over a function."""
    raise RuntimeError(
        "paddle_tpu_torch.autograd.backward is not provided: call "
        "Tensor.backward() on the loss (loss.backward(grad_tensor)), or use "
        "paddle_tpu_torch.autograd.grad(fn) / value_and_grad(fn) over a "
        "function")
