"""Layers and functional ops of the port."""
from . import functional  # noqa: F401
from .layers import Dropout, Embedding, LayerNorm, Linear  # noqa: F401

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear"]
