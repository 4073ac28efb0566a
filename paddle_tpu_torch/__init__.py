"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's layout and names (``models/gpt.py``,
``inference/engine.py``, ``ops/fused_block.py``, ...) so each module's
counterpart is found by path.  It imports ``torch``, numpy and the standard
library only.  Its kernels are CUDA C++ for Hopper (``csrc/*.cu``), built
with ``nvcc`` at first use and bound through ``ctypes`` (``_kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.  On a CPU tensor every
kernel wrapper takes its plain PyTorch version, which is also the numerics
oracle the kernels are held against.

Ported so far: serving — ``GPTForCausalLM.serving_step`` over a paged KV
cache, driven by ``inference.ServingEngine``, with the paged-decode and
fused-block (K1 ln_linear, K2 linear_residual, K3 ffn) kernels, and the
engine's request lifecycle (deadlines and cancel, quarantine, the
watchdog, drain / spill / resume, defrag, ``serve.*`` metrics, request
tracing, the status server — ``observability/``, ``supervisor/``,
``testing/faults.py``) under the ``inference.Config`` /
``create_predictor`` facade; training —
``training.train_step`` (bf16 O1 ``amp.auto_cast``, ``GPTForCausalLM``
with labels, backward, ``optimizer.AdamW``) with the flash-attention
forward, dK/dV and dQ kernels and the chunked LM loss (``ops/fused.py``).
"""
__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
from .framework.errors import (  # noqa: F401
    EnforceNotMet, InvalidArgumentError, UnavailableError, UnimplementedError,
    enforce)

__all__ = ["resolve_device", "enforce", "EnforceNotMet",
           "InvalidArgumentError", "UnavailableError", "UnimplementedError"]
