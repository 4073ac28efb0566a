"""``Layer`` and ``Parameter``: the port of ``paddle_tpu/nn/layer.py``.

``Layer`` is a ``torch.nn.Module`` with the paddle surface on top
(``create_parameter``, ``add_sublayer``, ``full_name``, ``set_state_dict``,
the forward pre / post hooks, ``state_dict`` hooks over the whole dict)
and the JAX package's functional path: ``layer.apply(variables, *args,
mutable=...)`` runs the forward with the named tensors of a flat dict in
place of the layer's parameters and buffers, and ``bind(variables)`` is
the context manager under it.  torch's own protocol keeps working: the
names torch also defines take both callers (``apply(fn)`` is torch's
recursive ``Module.apply``, ``state_dict(destination=, prefix=,
keep_vars=)`` its recursion, ``register_buffer(..., persistent=)`` its
keyword), and the hook handles are torch's ``RemovableHandle``\\ s where
the JAX package returns ints.

``Parameter`` is a ``torch.nn.Parameter``, so modules register it and the
optimizers and checkpoints take it as any other parameter; it adds the
paddle names (``name``, ``trainable`` / ``stop_gradient`` as views of
``requires_grad``, ``set_value``, ``numpy``, ``astype``).

``apply`` never changes the layer or the caller's tensors: it runs on
copies of the buffers (the port's BatchNorm and ``spectral_norm`` update
theirs in place) and, with ``mutable=True``, returns the copies that the
forward updated in a new dict.  Gradients through ``apply`` are taken
with ``torch.autograd.grad`` over the values of the variables dict."""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils.hooks import RemovableHandle

from ..device import resolve_device
from ..framework.errors import enforce
from . import initializer as I

__all__ = ["Parameter", "Layer", "Sequential", "LayerList", "ParameterList"]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name if not isinstance(dtype, str)
                   else dtype)


class Parameter(torch.nn.Parameter):
    """A named, trainable tensor: ``torch.nn.Parameter`` with the paddle
    surface.  ``trainable`` and ``stop_gradient`` read and set
    ``requires_grad``."""

    def __new__(cls, value=None, trainable: bool = True, name: str = "",
                is_bias: bool = False):
        if value is None:
            value = torch.empty(0)
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        self = super().__new__(cls, value.detach(), bool(trainable))
        self.name = name
        self.is_bias = is_bias
        return self

    def __init__(self, *args, **kwargs):  # state is set in __new__
        pass

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad, self.name, self.is_bias)
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, self.name, self.is_bias))

    @property
    def name(self) -> str:   # the tensor's own ``name`` is read-only
        return self.__dict__.get("_param_name", "")

    @name.setter
    def name(self, v: str) -> None:
        self.__dict__["_param_name"] = v

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, v: bool) -> None:
        self.requires_grad_(bool(v))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v: bool) -> None:
        self.requires_grad_(not v)

    def set_value(self, value) -> None:
        """Copy ``value`` in, in place, cast to this parameter's dtype."""
        value = torch.as_tensor(value.detach() if isinstance(
            value, torch.Tensor) else np.asarray(value))
        enforce(tuple(value.shape) == tuple(self.shape),
                f"set_value shape mismatch: {tuple(value.shape)} vs "
                f"{tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(value)

    def numpy(self) -> np.ndarray:
        return self.detach().cpu().numpy()

    def astype(self, dtype) -> torch.Tensor:
        return self.to(_torch_dtype(dtype))

    @property
    def T(self) -> torch.Tensor:  # noqa: N802
        return self.permute(*reversed(range(self.dim())))

    def __repr__(self) -> str:
        return (f"Parameter(name={self.name!r}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, trainable={self.trainable})")


def _rebuild_parameter(data, requires_grad, name, is_bias):
    return Parameter(data, requires_grad, name, is_bias)


# full_name() uniquifier per lowercased class name (the JAX counter)
_full_name_counts: Dict[str, int] = {}


class Layer(torch.nn.Module):
    """Base class of the port's layers and models (the JAX ``Layer``)."""

    def __init__(self, name_scope: Optional[str] = None):
        super().__init__()
        self._paddle_state_dict_hooks: Dict[int, Any] = OrderedDict()

    # -- construction helpers --------------------------------------------
    def _own_device(self) -> Optional[torch.device]:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return None

    def create_parameter(self, shape, dtype="float32",
                         default_initializer=None, is_bias: bool = False,
                         trainable: bool = True, attr=None,
                         device=None) -> Parameter:
        """A parameter drawn as the JAX ``Layer.create_parameter`` picks
        its initializer (``initializer.create_parameter``), on ``device``:
        when None, where this layer's tensors already are, else ``cuda``
        (raising without a card)."""
        dev = resolve_device(device if device is not None
                             else self._own_device())
        p = I.create_parameter(tuple(shape), default_initializer, is_bias,
                               attr, dev, _torch_dtype(dtype))
        return Parameter(p.data, trainable=trainable, is_bias=is_bias)

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None) -> None:
        """torch's ``register_buffer``; ``persistable`` is the paddle name
        of ``persistent`` (a non-persistable buffer stays out of
        ``state_dict``)."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(
            name, tensor, persistent=persistable if persistent is None
            else persistent)

    def add_sublayer(self, name: str, sublayer: torch.nn.Module):
        self.add_module(name, sublayer)
        return sublayer

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def create_variable(self, name: Optional[str] = None, persistable=None,
                        dtype="float32", device=None) -> torch.Tensor:
        """A zero scalar buffer attached to the layer (the JAX
        ``create_variable``)."""
        key = name or f"_var_{len(self._buffers)}"
        dev = resolve_device(device if device is not None
                             else self._own_device())
        self.register_buffer(key, torch.zeros((), dtype=_torch_dtype(dtype),
                                              device=dev),
                             persistable=bool(persistable))
        return self._buffers[key]

    create_tensor = create_variable

    # -- traversal --------------------------------------------------------
    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, torch.nn.Module]]:
        """Every sublayer, depth first, as the JAX traversal (a layer
        shared under two names is listed under both)."""
        if include_self:
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            p = f"{prefix}.{name}" if prefix else name
            yield p, sub
            yield from _named_sublayers(sub, p)

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """torch's ``named_parameters``; a ``Parameter`` without a name
        takes its dotted path, as in the JAX package (the names that
        ``apply_decay_param_fun`` sees)."""
        for full, p in super().named_parameters(
                prefix=prefix, recurse=recurse,
                remove_duplicate=remove_duplicate):
            if isinstance(p, Parameter) and not p.name:
                p.name = full
            yield full, p

    def full_name(self) -> str:
        """A unique class-derived name: ``linear_0``, ``linear_1``, ..."""
        if "_full_name" not in self.__dict__:
            cls = type(self).__name__.lower()
            n = _full_name_counts.get(cls, 0)
            _full_name_counts[cls] = n + 1
            self.__dict__["_full_name"] = f"{cls}_{n}"
        return self.__dict__["_full_name"]

    def clear_gradients(self) -> None:
        """Drop every parameter's ``.grad``."""
        self.zero_grad(set_to_none=True)

    # -- state dict -------------------------------------------------------
    def register_state_dict_hook(self, hook) -> RemovableHandle:
        """``hook(state_dict) -> state_dict or None``, run on the whole
        dict at every ``state_dict()`` of this layer or of an ancestor
        (a sublayer's hooks fire during its parent's call)."""
        handle = RemovableHandle(self._paddle_state_dict_hooks)
        self._paddle_state_dict_hooks[handle.id] = hook
        return handle

    def state_dict(self, *args, destination=None, prefix: str = "",
                   keep_vars: bool = False, include_buffers: bool = True):
        """torch's ``state_dict`` (keys, values, its recursion); at the top
        call, ``include_buffers=False`` drops the buffers and the paddle
        ``state_dict`` hooks of this layer and every sublayer run."""
        top = destination is None and not args
        out = super().state_dict(*args, destination=destination,
                                 prefix=prefix, keep_vars=keep_vars)
        if not top:
            return out
        if not include_buffers:
            for name, _ in self.named_buffers(prefix=prefix,
                                              remove_duplicate=False):
                out.pop(name, None)
        for _, sub in self.named_sublayers(include_self=True):
            for hook in list(getattr(sub, "_paddle_state_dict_hooks",
                                     {}).values()):
                result = hook(out)
                if result is not None:
                    out = result
        return out

    def to_static_state_dict(self, include_buffers: bool = True):
        return self.state_dict(include_buffers=include_buffers)

    def trainable_variables(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters by name: the variables that
        ``apply`` takes gradients for."""
        return OrderedDict((n, p) for n, p in self.named_parameters()
                           if p.requires_grad)

    def _owners(self):
        """Full name -> (owning module, local name), for parameters and
        for buffers, every alias of a shared tensor included."""
        params, bufs = {}, {}
        for path, sub in self.named_sublayers(include_self=True):
            for store, out in ((sub._parameters, params),
                               (sub._buffers, bufs)):
                for local, t in store.items():
                    if t is not None:
                        out[f"{path}.{local}" if path else local] = (sub,
                                                                    local)
        return params, bufs

    def set_state_dict(self, state: Mapping, strict: bool = True):
        """Load ``state`` by name: parameters in place (shape-checked, cast
        to their dtype), buffers replaced.  ``strict`` raises ``KeyError``
        naming the unexpected and missing keys; a non-persistable buffer
        is never demanded."""
        params, bufs = self._owners()
        persistable = set(super().state_dict(keep_vars=True))
        unexpected = []
        for name, value in state.items():
            if name in params:
                sub, local = params[name]
                p = sub._parameters[local]
                enforce(tuple(value.shape) == tuple(p.shape),
                        f"shape mismatch for {name}: {tuple(value.shape)} vs "
                        f"{tuple(p.shape)}")
                with torch.no_grad():
                    p.copy_(_as_tensor(value))
            elif name in bufs:
                sub, local = bufs[name]
                sub._buffers[local] = _as_tensor(value).to(
                    sub._buffers[local].device)
            else:
                unexpected.append(name)
        if strict:
            missing = [k for k in list(params)
                       + [b for b in bufs if b in persistable]
                       if k not in state]
            if unexpected or missing:
                raise KeyError(f"state_dict mismatch: unexpected="
                               f"{unexpected}, missing={missing}")
        return self

    load_dict = set_state_dict

    # -- in place / whole-layer -------------------------------------------
    def apply_fn(self, fn):
        """``fn`` on every sublayer, then on this layer (paddle's
        ``Layer.apply``; torch's ``Module.apply``)."""
        return torch.nn.Module.apply(self, fn)

    def astype(self, dtype):
        """Cast the floating parameters and buffers in place."""
        return self.to(_torch_dtype(dtype))

    def register_forward_post_hook(self, hook) -> RemovableHandle:
        """``hook(layer, args, out)``; a result that is not None replaces
        the output.  torch's ``register_forward_hook``; pre-hooks are
        torch's ``register_forward_pre_hook`` (``hook(layer, args)``, a
        result that is not None replaces the args)."""
        return self.register_forward_hook(hook)

    # -- functional path --------------------------------------------------
    @contextlib.contextmanager
    def bind(self, variables: Mapping):
        """Put the named tensors of ``variables`` in place of the layer's
        parameters and buffers for the duration, then restore them.  Names
        the layer does not have are ignored (optimizer slots, say); a
        shared parameter given under one of its names is replaced under
        all of them."""
        params, bufs = self._owners()
        saved = []   # (store, local, old)
        try:
            given = {}
            for name, value in variables.items():
                if name in params:
                    sub, local = params[name]
                    given.setdefault(id(sub._parameters[local]), value)
            for name, (sub, local) in params.items():
                old = sub._parameters[local]
                value = variables.get(name, given.get(id(old)))
                if value is not None and value is not old:
                    saved.append((sub._parameters, local, old))
                    sub._parameters[local] = value
            for name, value in variables.items():
                if name in bufs:
                    sub, local = bufs[name]
                    saved.append((sub._buffers, local, sub._buffers[local]))
                    sub._buffers[local] = value
            yield self
        finally:
            for store, local, old in reversed(saved):
                store[local] = old

    def apply(self, variables, *args, mutable: bool = False,
              method: Optional[str] = None, **kwargs):
        """``apply(fn)``: torch's ``Module.apply``.  ``apply(variables,
        *args)``: the forward (or the method named ``method``) with
        ``variables`` bound, on copies of every buffer, so neither the
        layer nor ``variables`` changes.  With ``mutable=True`` the result
        is ``(out, new_variables)``: ``variables`` with the buffers the
        forward updated at their new values."""
        if callable(variables) and not isinstance(variables, Mapping):
            enforce(not args and not kwargs and not mutable
                    and method is None,
                    "apply(fn) takes the function alone")
            return torch.nn.Module.apply(self, variables)
        _, bufs = self._owners()
        copies = {}
        for name, (sub, local) in bufs.items():
            src = variables.get(name, sub._buffers[local])
            copies[name] = src.clone() if isinstance(src, torch.Tensor) \
                else _as_tensor(src)
        versions = {n: t._version for n, t in copies.items()}
        with self.bind({**variables, **copies}):
            fn = self if method is None else getattr(self, method)
            out = fn(*args, **kwargs)
            updated = {}
            for name, (sub, local) in bufs.items():
                now = sub._buffers[local]
                if now is not copies[name] or \
                        now._version != versions[name]:
                    updated[name] = now
        if not mutable:
            return out
        return out, {**variables, **updated}


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.as_tensor(np.asarray(value))


def _named_sublayers(module: torch.nn.Module, prefix: str):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        p = f"{prefix}.{name}"
        yield p, sub
        yield from _named_sublayers(sub, p)


class Sequential(torch.nn.Sequential, Layer):
    """torch's ``nn.Sequential`` as a ``Layer``; also takes one list of
    ``(name, layer)`` pairs, as the JAX ``Sequential``."""

    def __init__(self, *layers):
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = (OrderedDict(layers[0]),)
        super().__init__(*layers)


class LayerList(torch.nn.ModuleList, Layer):
    """torch's ``nn.ModuleList`` as a ``Layer`` (keys ``"0"``, ``"1"``,
    ...)."""


class ParameterList(torch.nn.ParameterList, Layer):
    """torch's ``nn.ParameterList`` as a ``Layer`` (keys ``"0"``, ``"1"``,
    ...)."""
