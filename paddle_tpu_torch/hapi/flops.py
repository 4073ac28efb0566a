"""Model FLOPs / summary utilities: the port of ``paddle_tpu/hapi/
flops.py`` (reference: hapi/dynamic_flops.py ``paddle.flops`` and
hapi/model_summary.py ``paddle.summary``).

The JAX package asks XLA's cost analysis of the compiled forward; the
port counts the forward's operations with PyTorch's
``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
attention, each counted at 2 operations a multiply-add).  The two counts
agree on matmul-dominated networks; XLA also counts elementwise work.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["flops", "summary"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64}


def _example_input(net, input_size, dtype):
    dt = _DTYPES.get(str(dtype), torch.float32) if dtype else torch.float32
    param = next(net.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    if not dt.is_floating_point:
        return torch.zeros(tuple(input_size), dtype=dt, device=device)
    return torch.ones(tuple(input_size), dtype=dt, device=device)


def flops(net, input_size: Sequence[int], custom_ops=None,
          print_detail: bool = False, dtype=None) -> int:
    """Total forward FLOPs of ``net`` on ``input_size`` (paddle.flops),
    counted in eval mode without gradients; ``custom_ops`` is accepted
    for API parity."""
    from torch.utils.flop_counter import FlopCounterMode
    # save per-module modes: a blanket train() afterwards would unfreeze
    # submodules deliberately left in eval (e.g. a frozen BN backbone)
    modes = [(m, m.training) for m in net.modules()]
    net.eval()
    try:
        x = _example_input(net, input_size, dtype)
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            net(x)
        total = int(counter.get_total_flops())
        if print_detail:
            print(f"FLOPs: {total}")  # noqa: print
            for op, n in sorted(counter.get_flop_counts().get(
                    "Global", {}).items(), key=lambda kv: str(kv[0])):
                print(f"  {op}: {int(n)}")  # noqa: print
        return total
    finally:
        for module, mode in modes:
            module.training = mode


def summary(net, input_size=None, dtypes=None) -> dict:
    """Layer-wise parameter summary (paddle.summary shape).

    Returns {'total_params': N, 'trainable_params': N}; prints a table."""
    total, trainable = 0, 0
    lines = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape))
        total += n
        if p.requires_grad:
            trainable += n
        lines.append(f"  {name:48s} {str(tuple(p.shape)):24s} {n:>12,}")
    header = f"{'Layer (param)':50s} {'Shape':24s} {'Param #':>12s}"
    print(header)  # noqa: print
    print("-" * len(header))  # noqa: print
    print("\n".join(lines))  # noqa: print
    print("-" * len(header))  # noqa: print
    print(f"Total params: {total:,}")  # noqa: print
    print(f"Trainable params: {trainable:,}")  # noqa: print
    if input_size is not None:
        try:
            f = flops(net, input_size,
                      dtype=dtypes[0] if dtypes else None)
            print(f"Forward FLOPs @ {tuple(input_size)}: {f:,}")  # noqa: print
        except Exception as e:  # a forward the counter cannot trace
            print(f"(FLOPs unavailable: {e})")  # noqa: print
    return {"total_params": total, "trainable_params": trainable}
