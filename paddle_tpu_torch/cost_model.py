"""``paddle.cost_model``, the port of ``paddle_tpu/cost_model.py``.

``CostModel.profile_measure`` returns a function's cost.  The JAX package
reads XLA's cost analysis of the compiled program (flops, bytes accessed,
transcendentals).  The port has no compiled program to ask: ``flops``
comes from ``torch.utils.flop_counter.FlopCounterMode`` over one run (the
matrix products and convolutions it counts, 2 per multiply-add, as XLA
counts a dot), and ``time`` is measured with a device sync.
``bytes_accessed`` and ``transcendentals`` are counts only XLA's analysis
gives; the port reports them as None.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["CostModel"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CostModel:
    def profile_measure(self, fn: Callable, example_args: Sequence,
                        device: str = None,
                        fetch_cost_list=("time", "flops"),
                        measure_iters: int = 3
                        ) -> Dict[str, Optional[float]]:
        """Run ``fn(*example_args)`` and return its cost dict: ``flops``
        (one run under the flop counter), ``bytes_accessed`` and
        ``transcendentals`` (None: XLA-only counts) and, when asked,
        ``time`` (seconds a call, measured after a warm call).
        ``device`` ('cpu' / 'cuda' / 'gpu') moves the tensor arguments
        there; None leaves them where they are."""
        from torch.utils.flop_counter import FlopCounterMode
        from .device import resolve_device
        dev = None
        if device is not None:
            dev = resolve_device("cuda" if device in ("gpu", "tpu")
                                 else device)
            example_args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                            for a in example_args]
        if dev is None:
            dev = next((a.device for a in example_args
                        if isinstance(a, torch.Tensor)), torch.device("cpu"))
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn(*example_args)
        out: Dict[str, Optional[float]] = {
            "flops": float(counter.get_total_flops()),
            "bytes_accessed": None,
            "transcendentals": None,
        }
        if "time" in fetch_cost_list:
            with torch.no_grad():
                fn(*example_args)
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(measure_iters):
                    fn(*example_args)
                _sync(dev)
            out["time"] = (time.perf_counter() - t0) / measure_iters
        return out
