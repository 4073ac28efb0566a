"""Fused ops of the port: the CUDA kernels (K1-K3 in ``fused_block``, the
flash kernels in the ``flash_attention`` module) beside their plain
versions, and the compositions that XLA fuses in the JAX package
(``ops/fused.py``), here in plain PyTorch.  ``flash_attention`` is not
re-exported here: the name is its module's."""
from .fused import (fused_bias_dropout_residual,  # noqa: F401
                    fused_bias_dropout_residual_layer_norm,
                    fused_feedforward, rotary_position_embedding)
from .fused_block import (fused_attention_block,  # noqa: F401
                          fused_attention_block_kvcache, fused_ffn_block,
                          fused_linear_residual, fused_ln_linear)

__all__ = ["fused_bias_dropout_residual",
           "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "rotary_position_embedding", "fused_attention_block",
           "fused_attention_block_kvcache", "fused_ffn_block",
           "fused_ln_linear", "fused_linear_residual"]
from . import registered  # noqa: F401,E402
