"""Device resolution for the port's entry points.

The port is written for one NVIDIA H100: an entry point given no device runs
on ``cuda`` and raises when there is no card.  It never falls back to the
CPU by itself; the CPU runs only when the caller asks for it (the tests pass
``device="cpu"``), and there every kernel wrapper takes its plain version.

**Float32 precision policy.**  Float32 operands get IEEE float32 products
on the card: importing the port turns TF32 off for cuBLAS matmuls and for
cuDNN convolutions (:func:`apply_precision_policy`), as the JAX package's
tests run at "highest" precision and K1-K3 multiply float32 weights in
float32.  bfloat16 and float16 operands are not affected: under
``amp.auto_cast`` they run on the tensor cores as before.  A caller who
wants TF32 sets the two torch flags after importing the port.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .framework.errors import UnavailableError, enforce

__all__ = ["resolve_device", "apply_precision_policy"]


def apply_precision_policy() -> None:
    """IEEE float32 products for float32 operands: no TF32 in cuBLAS
    matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


apply_precision_policy()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raise when the resolved device is a CUDA device
    and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    enforce(dev.type in ("cuda", "cpu"),
            f"unsupported device {dev}: the port runs on cuda (or on the "
            "cpu when asked)")
    if dev.type == "cuda":
        enforce(torch.cuda.is_available(),
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU", exc=UnavailableError)
    return dev
