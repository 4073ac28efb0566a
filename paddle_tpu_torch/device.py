"""Device resolution for the port's entry points.

The port is written for one NVIDIA H100: an entry point given no device runs
on ``cuda`` and raises when there is no card.  It never falls back to the
CPU by itself; the CPU runs only when the caller asks for it (the tests pass
``device="cpu"``), and there every kernel wrapper takes its plain version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .framework.errors import UnavailableError, enforce

__all__ = ["resolve_device"]


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
