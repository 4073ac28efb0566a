"""Layers, functional ops, initializers, recurrent layers, weight
reparameterizations and beam-search decoding of the port: every public
name of the JAX ``paddle_tpu.nn`` but ``Layer`` and ``Parameter`` (the
port's layers are ``torch.nn.Module``\\ s and their parameters
``torch.nn.Parameter``\\ s).  ``Sequential``, ``LayerList`` and
``ParameterList`` are torch's ``nn.Sequential``, ``nn.ModuleList`` and
``nn.ParameterList``, whose ``"0"``, ``"1"``, ... keys are the JAX
containers' keys."""
from torch.nn import ModuleList as LayerList  # noqa: F401
from torch.nn import ParameterList, Sequential  # noqa: F401

from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                         ClipGradByValue)
from . import functional, initializer, utils  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all
from .layers_ext import *  # noqa: F401,F403
from .layers_ext import __all__ as _ext_all
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all

__all__ = (["functional", "initializer", "utils", "ParamAttr", "Sequential",
            "LayerList", "ParameterList", "ClipGradByGlobalNorm",
            "ClipGradByNorm", "ClipGradByValue"]
           + _layers_all + _ext_all + _rnn_all)
