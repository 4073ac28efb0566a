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

:func:`classification_step` is the step of an image classifier that
returns logits (the vision rows' ``_vision_train_payload`` /
``_bench_resnet50`` steps): the loss is the float32 cross-entropy of the
logits, computed outside ``auto_cast``.

    model, optimizer, images, labels, kw = \
        convert.resnet_training_workload("cuda")
    loss = classification_step(model, optimizer, images, labels, **kw)

:func:`seq2seq_step` is the step of an encoder-decoder translation model
(``models.translation.TranslationModel``): the float32 cross-entropy of
its logits against the next target tokens, optionally with label
smoothing and a scheduler step; it reads the loss back once.

    model, optimizer, (src, tgt_in, tgt_next), kw = \
        convert.transformer_training_workload("cuda")
    loss = seq2seq_step(model, optimizer, src, tgt_in, tgt_next, **kw)
"""
from __future__ import annotations

from typing import Optional

import torch

from . import amp
from .nn import functional as F
from .optimizer.lr import LRScheduler

__all__ = ["train_step", "classification_step", "seq2seq_step"]


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


def classification_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        images: torch.Tensor, labels: torch.Tensor, *,
                        level: str = "O1") -> torch.Tensor:
    """One step in place: zero the grads, ``logits = model(images)`` under
    ``auto_cast(level=level, dtype="bfloat16")`` (no autocast for
    ``level="O0"``), the mean ``F.cross_entropy(logits.float(), labels)``,
    backward, ``optimizer.step()``.  BatchNorm buffers take their running
    update in place (the JAX bench steps discard theirs; outputs in
    training mode do not read them).  Returns the detached loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if level == "O0":
        logits = model(images)
    else:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            logits = model(images)
    loss = F.cross_entropy(logits.float(), labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def seq2seq_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 src: torch.Tensor, tgt_in: torch.Tensor,
                 tgt_next: torch.Tensor, *, level: str = "O1",
                 scheduler: Optional[LRScheduler] = None,
                 label_smoothing: float = 0.0) -> float:
    """One step in place: zero the grads, ``logits = model(src, tgt_in)``
    under ``auto_cast(level=level, dtype="bfloat16")`` (none for
    ``level="O0"``), the mean ``F.cross_entropy`` of the float32 logits
    against ``tgt_next`` (labels of -100, the padding, count zero;
    ``label_smoothing`` mixes in the mean log-probability), backward,
    ``optimizer.step()``, then ``scheduler.step()``.  Returns the loss as
    a float: the step's one readback."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if level == "O0":
        logits = model(src, tgt_in)
    else:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            logits = model(src, tgt_in)
    loss = F.cross_entropy(logits.float(), tgt_next,
                           label_smoothing=label_smoothing)
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return float(loss.detach())
