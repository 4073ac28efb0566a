"""Optimizers: the port of ``paddle_tpu/optimizer/__init__.py`` as far as
the training slice needs it (``Optimizer``'s update loop, ``Adam`` and
``AdamW``), as ``torch.optim.Optimizer`` subclasses.

The arithmetic is the JAX package's, op for op, in float32: moments in
float32, bias correction ``mhat / (sqrt(vhat) + eps)`` with ``beta ** t``
taken in float32, and AdamW's decoupled decay ``p - lr * wd * p`` on the
*old* parameter, applied to every parameter.  The scalar factors (lr,
``1 - beta ** t``, ``lr * wd``) are float32 values computed on the host,
so a step copies nothing to the card.  ``torch.optim.AdamW`` rounds
at other places (it folds the decay into the parameter first), so its
trajectory is not the JAX one.  Parameters are updated in place.

Not ported yet (ROADMAP Queue 1): grad clipping, ``apply_decay_param_fun``,
L1 / L2Decay objects, lr schedules and O2 master weights (parameters must
be float32).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..framework.errors import UnimplementedError, enforce

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer(torch.optim.Optimizer):
    """Base class: the stateful ``step()`` over the bound parameters.
    Subclasses implement ``_init_slots(p)`` and ``_update(g, p, slots, lr,
    step, wd)`` on float32 tensors (``lr`` and ``wd`` float32 values as
    Python floats), returning the new parameter."""

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Iterable[torch.Tensor] = None,
                 weight_decay: float = None):
        enforce(parameters is not None,
                "the optimizer needs parameters= (e.g. model.parameters())")
        enforce(weight_decay is None or isinstance(weight_decay,
                                                   (int, float)),
                "weight_decay takes a float (L1/L2Decay objects are not "
                "ported yet)", exc=UnimplementedError)
        enforce(isinstance(learning_rate, (int, float)),
                "learning_rate takes a float (lr schedules are not ported "
                "yet)", exc=UnimplementedError)
        super().__init__(list(parameters),
                         {"lr": float(learning_rate),
                          "weight_decay": float(weight_decay or 0.0)})
        for group in self.param_groups:
            for p in group["params"]:
                enforce(p.dtype == torch.float32,
                        f"parameters must be float32 (O2 master weights are "
                        f"not ported yet), got {p.dtype}",
                        exc=UnimplementedError)

    @torch.no_grad()
    def step(self, closure=None):
        enforce(closure is None, "step(closure) is not supported")
        for group in self.param_groups:
            lr = float(np.float32(group["lr"]))
            wd = float(np.float32(group["weight_decay"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state.update(self._init_slots(p))
                state["step"] += 1
                p.copy_(self._update(p.grad.float(), p, state, lr,
                                     state["step"], wd))
        return None

    def _init_slots(self, p):
        raise NotImplementedError

    def _update(self, g, p, slots, lr, step: int, wd: float):
        raise NotImplementedError


class Adam(Optimizer):
    """Adam with L2-coupled weight decay (``g + wd * p``)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = None):
        super().__init__(learning_rate, parameters, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._decoupled = False

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, g, p, slots, lr, step, wd):
        if wd and not self._decoupled:
            g = g + wd * p
        one, t = np.float32(1.0), np.float32(step)
        bc1 = float(one - np.float32(self.beta1) ** t)
        bc2 = float(one - np.float32(self.beta2) ** t)
        m = slots["moment1"].mul_(self.beta1).add_((1 - self.beta1) * g)
        v = slots["moment2"].mul_(self.beta2).add_(
            (1 - self.beta2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        new_p = p - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        if wd and self._decoupled:
            new_p = new_p - float(np.float32(lr) * np.float32(wd)) * p
        return new_p


class AdamW(Adam):
    """Adam with decoupled weight decay, applied to every parameter."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay)
        self._decoupled = True
