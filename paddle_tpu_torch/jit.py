"""``paddle.jit``: save a trained layer for inference and load it back,
the port of ``paddle_tpu/jit.py``.

The JAX package exports a layer's forward as serialized StableHLO
(``jax.export``).  The port exports it with ``torch.export``: the
artifact is a directory

- ``model.pt2`` — the ``torch.export`` program of
  ``forward(params, *inputs)``, the layer's ``state_dict`` passed in as a
  dict the way the JAX program takes its parameters, so the file holds no
  weights (constants the forward makes itself, such as the rope tables,
  are in it);
- ``params/`` — the ``state_dict`` as a sharded checkpoint
  (``distributed.checkpoint.save_sharded``: the JAX format and keys);
- ``meta.json`` — the input specs, byte for byte the JAX file for the
  same specs.

Every ``None`` / ``-1`` dim of an :class:`InputSpec` is a dynamic dim of
its own (``torch.export.Dim.DYNAMIC``), as the JAX package gives each its
own symbol.  The port's kernels are in the program as registered ops
(``ops/registered.py``) that pick their kernel when they run, so a
program exported on the CPU launches them when it is loaded on the card.
:func:`load` places the program on the current device (``set_device``).

``to_static`` keeps the decorator's calling conventions and
``ProgramTranslator.enable(False)``, and runs the function as it is:
PyTorch executes eagerly and needs no trace, and ``torch.compile`` is not
the counterpart of the JAX ``jit`` here (it would recompile what the
port's kernels already are).
"""
from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from .device import resolve_device
from .distributed.checkpoint import load_sharded, save_sharded
from .framework.dtype import convert_dtype
from .framework.errors import enforce
from .utils import fsio

__all__ = ["to_static", "save", "load", "InputSpec", "TranslatedLayer",
           "TracedLayer", "ProgramTranslator", "set_code_level",
           "set_verbosity", "not_to_static"]

ARTIFACT = "model.pt2"
# the smallest example size of a dynamic dim: torch.export specializes
# dims traced at 0 or 1
_EXAMPLE_DIM = 2


class InputSpec:
    """≙ paddle.static.InputSpec(shape, dtype, name)."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        if isinstance(dtype, torch.dtype):
            dtype = str(dtype).replace("torch.", "")
        self.dtype = dtype
        self.name = name

    def dynamic(self) -> List[int]:
        """The axes whose size is free (``None`` or negative)."""
        return [i for i, d in enumerate(self.shape)
                if d is None or (isinstance(d, int) and d < 0)]

    def example(self, device=None) -> torch.Tensor:
        """Zeros of this spec, every dynamic dim at the example size."""
        dims = [_EXAMPLE_DIM if i in self.dynamic() else int(d)
                for i, d in enumerate(self.shape)]
        return torch.zeros(dims, dtype=convert_dtype(self.dtype),
                           device=device)

    def to_json(self):
        return {"shape": list(self.shape), "dtype": str(self.dtype),
                "name": self.name}

    @staticmethod
    def from_json(d):
        return InputSpec(d["shape"], d["dtype"], d.get("name"))


_translator_state = {"enabled": True, "code_level": 0, "verbosity": 0}


def to_static(function=None, input_spec=None, **kw):
    """≙ @paddle.jit.to_static, with the decorator's calling conventions.
    The function runs as it is (PyTorch executes eagerly: there is no
    program to trace); ``ProgramTranslator.enable(False)`` and
    :func:`not_to_static` keep their meaning, which here changes nothing
    of what runs."""
    def deco(fn):
        @functools.wraps(fn)
        def dispatch(*args, **kwargs):
            return fn(*args, **kwargs)
        dispatch.__wrapped_jit__ = fn
        return dispatch
    if function is None:
        return deco
    return deco(function)


class _Forward(torch.nn.Module):
    """``forward(params, *inputs)`` of ``layer`` with ``params`` (its
    ``state_dict``) passed in.  The layer is kept off the module's
    attributes, so the exported program lifts no weight of its own."""

    def __init__(self, layer: torch.nn.Module):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, params: Dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(self._layer, params, inputs,
                                          strict=False)


def _export(layer, params: Dict[str, torch.Tensor],
            input_spec: Sequence[InputSpec]):
    """The ``torch.export`` program of ``layer``'s forward at the specs;
    each dynamic dim is a symbol of its own (``Dim.DYNAMIC``: the range
    the forward implies, such as cuDNN's batch limit, is accepted, and a
    dim that the trace would fix raises)."""
    examples = tuple(s.example(next(iter(params.values())).device
                               if params else None) for s in input_spec)
    dims = tuple({a: torch.export.Dim.DYNAMIC for a in s.dynamic()}
                 or None for s in input_spec)
    with torch.no_grad():
        return torch.export.export(
            _Forward(layer), (params, *examples),
            dynamic_shapes=({k: None for k in params}, dims))


def save(layer, path: str, input_spec: List[InputSpec]) -> None:
    """Export ``layer`` for inference: eval mode, its forward traced at the
    specs by ``torch.export``; the directory layout is in the module
    docstring.  One export is one ``compile`` record of the compile
    tracker (function ``jit.save``, its signature the specs)."""
    from .observability.compilation import get_tracker
    os.makedirs(path, exist_ok=True)
    layer.eval()
    params = {k: v.detach() for k, v in layer.state_dict().items()}
    t0 = time.perf_counter()
    program = _export(layer, params, input_spec)
    # the example inputs would carry a copy of every weight into the file
    program.example_inputs = None
    torch.export.save(program, os.path.join(path, ARTIFACT))
    get_tracker().observe(
        "jit.save", [[s.to_json() for s in input_spec]],
        arg_names=["input_spec"], wall_ms=(time.perf_counter() - t0) * 1e3)
    save_sharded(params, os.path.join(path, "params"))
    fsio.write_bytes(
        os.path.join(path, "meta.json"),
        json.dumps({"input_spec": [s.to_json() for s in input_spec]}
                   ).encode("utf-8"))


def _param_names(program) -> List[str]:
    """The keys of the ``params`` dict argument, in the program's order."""
    def kids(spec):
        return (spec.children() if hasattr(spec, "children")
                else spec.children_specs)
    return list(kids(kids(program.call_spec.in_spec)[0])[0].context)


class TranslatedLayer:
    """A loaded artifact (≙ paddle.jit.TranslatedLayer): calling it runs
    the program on the current device with the weights of ``params/``."""

    def __init__(self, path: str):
        from .ops import registered  # noqa: F401  (the ops, before the load)
        device = resolve_device(None)
        program = torch.export.load(os.path.join(path, ARTIFACT))
        self.program = move_to_device_pass(program, device)
        self._module = self.program.module()
        params = load_sharded(os.path.join(path, "params"))
        # in the order the program's input spec lists them
        self._params = {k: params[k].to(device)
                        for k in _param_names(self.program)}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.input_spec = [InputSpec.from_json(d)
                           for d in meta["input_spec"]]
        self.device = device

    def __call__(self, *inputs):
        args = [x.to(self.device) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=self.device)
                for x in inputs]
        with torch.no_grad():
            return self._module(self._params, *args)

    def run(self, feed: Dict[str, Any]):
        """The inputs by spec name (``input_<i>`` for an unnamed spec):
        ``Executor.run``'s call on a loaded inference program."""
        return self(*[feed[s.name or f"input_{i}"]
                      for i, s in enumerate(self.input_spec)])


def load(path: str) -> TranslatedLayer:
    enforce(os.path.isdir(path), f"no exported model at {path!r}")
    if not os.path.exists(os.path.join(path, ARTIFACT)):
        held = sorted(os.listdir(path))
        what = ("a JAX StableHLO artifact (model.stablehlo): the port loads "
                "its own torch.export artifact" if "model.stablehlo" in held
                else "no program")
        enforce(False, f"{path!r} holds {held}: {what}; re-export the layer "
                f"with paddle_tpu_torch.jit.save (it writes {ARTIFACT})")
    return TranslatedLayer(path)


def not_to_static(fn=None):
    """Mark a function to be excluded from to_static conversion; the
    marker is metadata (the function runs as plain Python either way)."""
    if fn is None:
        return not_to_static
    fn.__not_to_static__ = True
    return fn


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Records the dy2static code-logging level (there is no source
    transform to log)."""
    _translator_state["code_level"] = level


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    _translator_state["verbosity"] = level


class ProgramTranslator:
    """The dy2static ProgramTranslator singleton: ``enable()`` records
    whether ``@to_static`` functions would be translated."""

    _instance = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool = True):
        _translator_state["enabled"] = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return _translator_state["enabled"]


class TracedLayer:
    """≙ jit.TracedLayer: ``trace(layer, inputs)`` runs the layer and
    keeps the example inputs; ``save_inference_model`` is :func:`save` at
    their shapes."""

    def __init__(self, layer, inputs):
        self._layer = layer
        self._inputs = inputs

    def __call__(self, *inputs):
        with torch.no_grad():
            return self._layer(*inputs)

    @staticmethod
    def trace(layer, inputs):
        tl = TracedLayer(layer, inputs)
        return tl(*inputs), tl

    def save_inference_model(self, path: str, feed=None, fetch=None):
        specs = [InputSpec(tuple(torch.as_tensor(i).shape),
                           torch.as_tensor(i).dtype) for i in self._inputs]
        save(self._layer, path, specs)
