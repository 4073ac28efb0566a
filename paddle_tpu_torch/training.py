"""The training step of the port: one step of ``GPTForCausalLM`` as the JAX
package's benches and ``hapi.Model.prepare(amp_configs=)`` take it
(``bench.py`` ``_build`` / ``train_step``): ``auto_cast`` at the given
level, forward with labels, backward, optimizer step; with a
``GradScaler`` the loss is scaled, and the scaler unscales, checks and
steps the optimizer (skipping the update on the card when a gradient is
not finite); with a scheduler, ``scheduler.step()`` after the update.

    model, optimizer, ids, labels = convert.training_workload("cuda")
    loss = train_step(model, optimizer, ids, labels)   # a device tensor
    print(float(loss))                                 # the caller reads it

The loss comes back as a tensor on the model's device; reading it back is
the caller's choice (a readback waits for the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import amp
from .optimizer.lr import LRScheduler

__all__ = ["train_step"]


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               input_ids: torch.Tensor, labels: torch.Tensor, *,
               level: str = "O1", scaler: Optional[amp.GradScaler] = None,
               scheduler: Optional[LRScheduler] = None) -> torch.Tensor:
    """One training step in place: zero the grads, forward under
    ``auto_cast(level=level, dtype="bfloat16")`` with ``labels``,
    backward (of the scaled loss with ``scaler``), ``optimizer.step()``
    (``scaler.step(optimizer)`` with one), then ``scheduler.step()``.
    Returns the detached, unscaled loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss, _ = model(input_ids, labels=labels)
    if scaler is None:
        loss.backward()
        optimizer.step()
    else:
        scaler.scale(loss).backward()
        scaler.step(optimizer)
    if scheduler is not None:
        scheduler.step()
    return loss.detach()
