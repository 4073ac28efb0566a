"""Layers, functional ops, initializers and beam-search decoding of the
port.  ``Sequential``
and ``LayerList`` are torch's ``nn.Sequential`` and ``nn.ModuleList``,
whose ``"0"``, ``"1"``, ... keys are the JAX containers' keys."""
from torch.nn import ModuleList as LayerList  # noqa: F401
from torch.nn import Sequential  # noqa: F401

from . import functional, initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layers import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa: F401
                     AvgPool2D, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                     Conv2D, CrossEntropyLoss, Dropout, Embedding, Flatten,
                     GELU, Hardsigmoid, Hardswish, Identity, LayerNorm,
                     LeakyReLU, Linear, LogSoftmax, MaxPool2D,
                     MultiHeadAttention, ReLU, ReLU6, RMSNorm, Sigmoid, SiLU,
                     Softmax, Tanh, Transformer, TransformerDecoder,
                     TransformerDecoderLayer, TransformerEncoder,
                     TransformerEncoderLayer)
from .layers_ext import BeamSearchDecoder, dynamic_decode  # noqa: F401

__all__ = ["functional", "initializer", "ParamAttr", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "AvgPool2D", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "CrossEntropyLoss", "Dropout",
           "Embedding", "Flatten", "GELU", "Hardsigmoid", "Hardswish",
           "Identity", "LayerNorm", "LeakyReLU", "Linear", "LogSoftmax",
           "MaxPool2D", "ReLU", "ReLU6", "Sigmoid", "SiLU", "Softmax", "Tanh",
           "Sequential", "LayerList", "RMSNorm", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "BeamSearchDecoder", "dynamic_decode"]
