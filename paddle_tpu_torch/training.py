"""The training step of the port: one step of ``GPTForCausalLM`` as the JAX
package's headline bench takes it (``bench.py`` ``_build`` /
``train_step``): bf16 O1 ``auto_cast``, forward with labels, backward,
optimizer step.

    model, optimizer, ids, labels = convert.training_workload("cuda")
    loss = train_step(model, optimizer, ids, labels)   # a device tensor
    print(float(loss))                                 # the caller reads it

The loss comes back as a tensor on the model's device; reading it back is
the caller's choice (a readback waits for the card).
"""
from __future__ import annotations

import torch

from . import amp

__all__ = ["train_step"]


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               input_ids: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
    """One training step in place: zero the grads, forward under
    ``auto_cast(level="O1", dtype="bfloat16")`` with ``labels``, backward,
    ``optimizer.step()``.  Returns the detached loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = model(input_ids, labels=labels)
    loss.backward()
    optimizer.step()
    return loss.detach()
