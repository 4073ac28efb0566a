"""Fused ops of the port, each a CUDA kernel beside its plain version."""
from .fused_block import (fused_ffn_block, fused_linear_residual,  # noqa: F401
                          fused_ln_linear)

__all__ = ["fused_ln_linear", "fused_linear_residual", "fused_ffn_block"]
