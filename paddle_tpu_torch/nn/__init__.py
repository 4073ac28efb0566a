"""Layers, functional ops, initializers, recurrent layers, weight
reparameterizations and beam-search decoding of the port: every public
name of the JAX ``paddle_tpu.nn``.  ``Layer`` is a ``torch.nn.Module``
and ``Parameter`` a ``torch.nn.Parameter`` with the paddle surface
(``nn/layer.py``); ``Sequential``, ``LayerList`` and ``ParameterList``
are torch's containers as ``Layer``\\ s, whose ``"0"``, ``"1"``, ...
keys are the JAX containers' keys."""

from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                         ClipGradByValue)
from . import functional, initializer, utils  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import (Layer, LayerList, Parameter,  # noqa: F401
                    ParameterList, Sequential)
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all
from .layers_ext import *  # noqa: F401,F403
from .layers_ext import __all__ as _ext_all
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all

__all__ = (["functional", "initializer", "utils", "ParamAttr", "Layer",
            "Parameter", "Sequential", "LayerList", "ParameterList",
            "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
           + _layers_all + _ext_all + _rnn_all)
