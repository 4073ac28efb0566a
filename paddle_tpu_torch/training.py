"""The training step of the port: one step of a model that returns ``(loss,
...)`` (``GPTForCausalLM``, ``BertForPretraining``) as the JAX package's
benches and ``hapi.Model.prepare(amp_configs=)`` take it (``bench.py``
``_build`` / ``_bench_bert_base``): ``auto_cast`` at the given level,
forward with the labels, backward, optimizer step; with a ``GradScaler``
the loss is scaled, and the scaler unscales, checks and steps the
optimizer (skipping the update on the card when a gradient is not
finite); with a scheduler, ``scheduler.step()`` after the update.

    model, optimizer, ids, labels = convert.training_workload("cuda")
    loss = train_step(model, optimizer, ids, labels)   # a device tensor
    print(float(loss))                                 # the caller reads it

    model, optimizer, ids, inputs = convert.bert_pretraining_workload("cuda")
    loss = train_step(model, optimizer, ids, **inputs)  # mlm / nsp labels

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
               input_ids: torch.Tensor,
               labels: Optional[torch.Tensor] = None, *,
               level: str = "O1", scaler: Optional[amp.GradScaler] = None,
               scheduler: Optional[LRScheduler] = None,
               **inputs: torch.Tensor) -> torch.Tensor:
    """One training step in place: zero the grads, forward under
    ``auto_cast(level=level, dtype="bfloat16")`` as ``model(input_ids,
    labels=labels, **inputs)`` (``labels`` left out when None: BERT takes
    ``mlm_labels``, ``nsp_labels``, ``token_type_ids`` and
    ``attention_mask`` as ``inputs``), backward (of the scaled loss with
    ``scaler``), ``optimizer.step()`` (``scaler.step(optimizer)`` with
    one), then ``scheduler.step()``.  Returns the detached, unscaled
    loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if labels is not None:
        inputs["labels"] = labels
    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss, _ = model(input_ids, **inputs)
    if scaler is None:
        loss.backward()
        optimizer.step()
    else:
        scaler.scale(loss).backward()
        scaler.step(optimizer)
    if scheduler is not None:
        scheduler.step()
    return loss.detach()
