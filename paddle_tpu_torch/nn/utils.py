"""Weight reparameterizations and parameter vectors: the port of
``paddle_tpu/nn/utils.py``.

``weight_norm`` and ``spectral_norm`` keep the JAX parameter names, not
``torch.nn.utils.parametrizations``' (``parametrizations.weight.original0``):
the layer holds ``<name>_g`` (the norm over every dim but ``dim``, kept as
size-1 dims) and ``<name>_v`` (the direction), or ``<name>_orig``, as
parameters, and a forward-pre hook recomputes ``layer.<name>`` from them
before every call.  The derived weight is a plain attribute, not a
parameter, so ``state_dict`` holds only the factors.  ``spectral_norm``'s
power-iteration vectors live in a ``SpectralNorm`` submodule as
non-persistent buffers: they move with the layer but are not in its
state dict (the JAX layer keeps them outside its state too), and they
advance only in training.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.errors import enforce

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v, dim: int):
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _weight_from(g, v, dim: int):
    return g * v / torch.clamp(_norm_except(v, dim), min=1e-12)


def weight_norm(layer: nn.Module, name: str = "weight",
                dim: int = 0) -> nn.Module:
    """Reparameterize ``layer.<name>`` as ``g v / ||v||``: parameters
    ``<name>_v`` (the weight) and ``<name>_g`` (its norm over every dim
    but ``dim``), the weight recomputed before every forward."""
    enforce(name in layer._parameters and layer._parameters[name] is not None,
            f"layer has no parameter {name!r}")
    w = layer._parameters.pop(name)
    dim = dim % w.dim()
    with torch.no_grad():
        layer.register_parameter(f"{name}_v", nn.Parameter(w.detach().clone()))
        layer.register_parameter(f"{name}_g",
                                 nn.Parameter(_norm_except(w.detach(), dim)))

    def recompute(lyr, args):
        setattr(lyr, name, _weight_from(getattr(lyr, f"{name}_g"),
                                        getattr(lyr, f"{name}_v"), dim))

    handle = layer.register_forward_pre_hook(recompute)
    layer.__dict__[f"_{name}_weight_norm_hook"] = (handle, dim)
    with torch.no_grad():     # a leaf until the first forward
        recompute(layer, ())
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight") -> nn.Module:
    """Fold ``g v / ||v||`` back into one parameter ``<name>``."""
    key = f"_{name}_weight_norm_hook"
    enforce(key in layer.__dict__, f"{name} is not weight-normed")
    handle, dim = layer.__dict__.pop(key)
    handle.remove()
    layer.__dict__.pop(name, None)
    v = layer._parameters.pop(f"{name}_v")
    g = layer._parameters.pop(f"{name}_g")
    with torch.no_grad():
        layer.register_parameter(name, nn.Parameter(_weight_from(g, v, dim)))
    return layer


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0) -> nn.Module:
    """Divide ``layer.<name>`` by its largest singular value before every
    forward: the parameter becomes ``<name>_orig``, and a
    :class:`~.layers.SpectralNorm` submodule ``<name>_spectral_norm``
    (the layer's mode, non-persistent ``weight_u`` / ``weight_v``) does
    the power iteration."""
    from .layers import SpectralNorm
    enforce(name in layer._parameters and layer._parameters[name] is not None,
            f"layer has no parameter {name!r}")
    w = layer._parameters.pop(name)
    sn = SpectralNorm(tuple(w.shape), dim=dim, power_iters=n_power_iterations,
                      epsilon=eps, device=w.device)
    sn._non_persistent_buffers_set.update(("weight_u", "weight_v"))
    layer.register_parameter(f"{name}_orig", w)
    layer.add_module(f"{name}_spectral_norm", sn)

    def recompute(lyr, args):
        setattr(lyr, name, getattr(lyr, f"{name}_spectral_norm")(
            getattr(lyr, f"{name}_orig")))

    layer.register_forward_pre_hook(recompute)
    with torch.no_grad():     # a leaf until the first forward
        recompute(layer, ())
    return layer


def parameters_to_vector(parameters) -> torch.Tensor:
    """Every parameter flattened into one vector, in order."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters) -> None:
    """Write the flat ``vec`` back into the parameters, in place."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n
    enforce(offset == vec.numel(), "vector size mismatch")
