"""Models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_125m,  # noqa: F401
                  gpt_1p3b, gpt_350m, gpt_6p7b, gpt_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt_125m",
           "gpt_350m", "gpt_1p3b", "gpt_6p7b"]
