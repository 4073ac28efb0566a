"""MFU accounting: the port of ``paddle_tpu/observability/mfu.py``, with
an H100 row in place of the JAX package's TPU table.

Two halves:

- the **denominator**: :func:`peak_flops_per_sec`, the dense bf16 peak of
  the first visible card from :data:`DEVICE_SPECS` (public datasheet
  figures), with a nominal H100 row, marked ``known=False``, for a CPU or
  an unlisted card so the math always produces a number;
- the **numerator**: :func:`flops_per_token`, the standard 6N
  forward + backward matmul estimate plus the attention term
  ``12 L h S`` per token (halved when causal), the formula the JAX
  package's bench and live telemetry use.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["DEVICE_SPECS", "device_spec", "peak_flops_per_sec",
           "param_count", "flops_per_token", "mfu", "PEAK_TFLOPS",
           "readback_sync"]

# per-card roofline specs (public datasheet figures, dense): bf16 tensor
# core TFLOP/s, int8 tensor core TOP/s, HBM GB/s; matched by substring of
# ``torch.cuda.get_device_name()`` in lower case
DEVICE_SPECS = {
    "h100": {"bf16_tflops": 989.0, "int8_tops": 1979.0,
             "hbm_gbps": 3350.0},
}

PEAK_TFLOPS = {gen: spec["bf16_tflops"] for gen, spec in DEVICE_SPECS.items()}

# the row an unlisted card (or the CPU) is given: MFU still produces a
# number, labelled by ``known=False``
_NOMINAL_GEN = "h100"


def _current_device_kind() -> str:
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


def device_spec(device_kind: Optional[str] = None) -> dict:
    """``device_kind`` (default: the first visible card's name) -> its
    spec: ``device_kind``, ``gen``, ``known`` and the ``bf16_tflops`` /
    ``int8_tops`` / ``hbm_gbps`` columns; an unlisted kind comes back with
    ``known=False``, ``gen=None`` and the nominal row."""
    if device_kind is None:
        device_kind = _current_device_kind()
    kind = (device_kind or "").lower()
    for gen, spec in DEVICE_SPECS.items():
        if gen in kind:
            return {"device_kind": device_kind, "gen": gen, "known": True,
                    **spec}
    return {"device_kind": device_kind, "gen": None, "known": False,
            **DEVICE_SPECS[_NOMINAL_GEN]}


def peak_flops_per_sec() -> float:
    """Peak dense bf16 FLOP/s of the first visible card."""
    return device_spec()["bf16_tflops"] * 1e12


def param_count(params: Any) -> int:
    """Total element count of a state dict (name -> tensor) or of an
    iterable of tensors."""
    values = params.values() if isinstance(params, dict) else params
    total = 0
    for v in values:
        n = 1
        for d in v.shape:
            n *= int(d)
        total += n
    return total


def flops_per_token(n_params: int, num_layers: Optional[int] = None,
                    hidden_size: Optional[int] = None,
                    seq_len: Optional[int] = None,
                    causal: bool = True) -> float:
    """Train-step (forward + backward) FLOPs per token: 6N for the
    matmuls, plus ``12 L h S`` when the transformer shape is known (halved
    for causal masking); without the shape the plain 6N."""
    total = 6.0 * float(n_params)
    if num_layers and hidden_size and seq_len:
        attn = 12.0 * num_layers * hidden_size * seq_len
        total += attn / 2.0 if causal else attn
    return total


def mfu(tokens_per_sec: float, flops_token: float,
        peak: Optional[float] = None) -> float:
    """Achieved / peak FLOP throughput."""
    return tokens_per_sec * flops_token / (peak or peak_flops_per_sec())


def readback_sync(x) -> float:
    """Host readback of a scalar: waits for the work that produces it."""
    return float(x.item() if hasattr(x, "item") else x)
