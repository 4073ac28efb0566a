"""Optimizers: the port of ``paddle_tpu/optimizer/__init__.py``: gradient
clipping, L1 / L2 decay, ``apply_decay_param_fun``, lr schedules
(:mod:`.lr`), float32 master weights for low-precision parameters and
every update rule of the JAX package, as ``torch.optim.Optimizer``
subclasses with the paddle stateful ``step()``.

The arithmetic is the JAX package's, op for op, in float32 on the card:
slots and masters in float32, bias corrections ``1 - beta ** t`` from the
step count, decoupled AdamW decay on the old parameter.  The state is the
JAX state's: one int32 ``step`` for the whole optimizer (a device scalar),
and per parameter its ``slots`` and its float32 ``master`` (None for a
float32 parameter), keyed by the parameter's name, so :meth:`state_dict`
maps onto a JAX ``opt.init`` / ``apply_gradients`` state name for name.
Names come from ``parameters=model.named_parameters()`` (the
``state_dict`` names, which the JAX package shares); plain tensors are
named ``param_<i>``, as the JAX package names unnamed parameters.

The lr of a step is a float32 host value (a float, or the
:class:`~.lr.LRScheduler`'s ``get_lr()``: the user drives the scheduler,
as in the JAX stateful path), and so are the decay factors.  Clipping and
its norm run on the card; nothing in a step reads the card back.  A step
given ``found_inf`` (the GradScaler's device flag) computes the update and
keeps the old parameters, slots, masters and step count where the flag is
set, on the card, so a skipped step costs no readback either.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.errors import enforce
from ..regularizer import L1Decay, L2Decay
from . import lr as lr  # noqa: F401  (paddle.optimizer.lr namespace)
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp", "Adam", "AdamW",
    "Lamb", "AdamMax", "Adamax", "Lars", "Adadelta", "lr",
    "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
    "global_norm",
]


# ---------------------------------------------------------------------------
# Gradient clipping: each takes and returns a list of gradient tensors
# ---------------------------------------------------------------------------
def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, a float32 device
    scalar (each tensor's norm accumulated in float32, then combined)."""
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads])
    return torch.sqrt(torch.sum(torch.square(norms)))


class ClipGradByValue:
    def __init__(self, max: float, min: Optional[float] = None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm:
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / global_norm)``.
    ``last_norm`` keeps the last call's norm before clipping, a device
    scalar (reading it waits for the card)."""

    def __init__(self, clip_norm: float = 1.0):
        self.clip_norm = clip_norm
        self.last_norm: Optional[torch.Tensor] = None

    def __call__(self, grads):
        norm = global_norm(grads)
        self.last_norm = norm
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]


# ---------------------------------------------------------------------------
# Base optimizer
# ---------------------------------------------------------------------------
def _named(parameters) -> Tuple[List[torch.Tensor], List[str]]:
    """Tensors and their names: ``(name, tensor)`` pairs keep their names,
    bare tensors are ``param_<i>``; a repeated name gets ``#<i>``, as the
    JAX package's ``_param_keys``."""
    enforce(parameters is not None,
            "the optimizer needs parameters= (e.g. model.named_parameters())")
    params, names, seen = [], [], set()
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            name, p = item
        else:
            name, p = f"param_{i}", item
        if name in seen:
            name = f"{name}#{i}"
        seen.add(name)
        params.append(p)
        names.append(name)
    enforce(params, "the optimizer got an empty parameter list")
    return params, names


class Optimizer(torch.optim.Optimizer):
    """Base class: the stateful ``step()`` over the bound parameters.
    Subclasses implement ``_init_slot(p)`` (a dict of float32 slots, empty
    when the rule has none) and ``_update(g, p, slots, lr, t, wd)`` on
    float32 tensors, returning ``(new_p, new_slots)``; ``lr`` and ``wd``
    are float32 values as Python floats, ``t`` the step count in float32:
    a host value while the host knows the count, which keeps every
    per-parameter op a tensor-scalar op, and a device scalar once a step
    was given ``found_inf`` (whether it advanced is then known only on the
    card)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = True,
                 apply_decay_param_fun: Optional[Callable[[str], bool]]
                 = None):
        params, names = _named(parameters)
        super().__init__(params, {})
        self._params, self._names = params, names
        enforce(isinstance(learning_rate, (int, float, LRScheduler)),
                f"learning_rate takes a float or an LRScheduler, got "
                f"{type(learning_rate).__name__}")
        self._lr = learning_rate
        self._grad_clip = grad_clip
        # weight_decay: a float (L2) or a regularizer object
        self._l1 = 0.0
        if isinstance(weight_decay, L1Decay):
            self._wd, self._l1 = 0.0, weight_decay.coeff
        elif isinstance(weight_decay, L2Decay):
            self._wd = weight_decay.coeff
        else:
            self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun
        self.multi_precision = multi_precision
        self._step: Optional[torch.Tensor] = None
        self._host_step: Optional[int] = None
        self.last_lr: Optional[float] = None

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr.get_lr()
        return self._lr

    def set_lr(self, value: float) -> None:
        enforce(not isinstance(self._lr, LRScheduler),
                "can't set_lr when using an LRScheduler")
        self._lr = value

    # -- per-parameter decay -----------------------------------------------
    def _decay(self, name: str, coeff: float) -> float:
        fn = self._apply_decay_param_fun
        return coeff if coeff and (fn is None or fn(name)) else 0.0

    # -- state ---------------------------------------------------------------
    def _ensure_state(self) -> None:
        """Slots, masters and the step count, built at first use (after
        ``amp.decorate``: a master is the float32 copy of the parameter as
        it is then, as the JAX ``init`` of the decorated parameters)."""
        if self._step is not None:
            return
        for p in self._params:
            st = self.state[p]
            st["slots"] = self._init_slot(p)
            low = (p.is_floating_point() and p.dtype != torch.float32)
            st["master"] = (p.detach().float().clone()
                            if self.multi_precision and low else None)
        self._step = torch.zeros((), dtype=torch.int32,
                                 device=self._params[0].device)
        self._host_step = 0

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        """Apply each parameter's ``.grad`` (parameters without one stay).
        ``found_inf``: a bool device scalar; where it is set the step
        leaves parameters, slots, masters and the step count as they
        were.  A ``"lr"`` key in ``param_groups[0]`` replaces the
        schedule's learning rate for the step."""
        enforce(closure is None, "step(closure) is not supported")
        live = [i for i, p in enumerate(self._params) if p.grad is not None]
        if not live:
            return None
        self._ensure_state()
        # a "lr" in the parameter group overrides the schedule for this
        # step (hapi.Model sets it for one step, as the JAX
        # apply_gradients(lr=) override)
        override = self.param_groups[0].get("lr")
        lr_v = float(np.float32(self.get_lr() if override is None
                                else override))
        self.last_lr = lr_v
        grads = [self._params[i].grad for i in live]
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        step = self._step + 1
        if found_inf is None and self._host_step is not None:
            self._host_step += 1
            t = np.float32(self._host_step)
        else:
            self._host_step = None
            t = step.float()
        for i, g in zip(live, grads):
            p, name = self._params[i], self._names[i]
            st = self.state[p]
            master = st["master"]
            compute_p = (master if master is not None else p).float()
            g32 = g.float()
            l1 = self._decay(name, self._l1)
            if self._l1:   # L1Decay: lasso penalty as a gradient addition
                g32 = g32 + l1 * torch.sign(compute_p)
            new_p, new_slots = self._update(g32, compute_p, st["slots"], lr_v,
                                            t, self._decay(name, self._wd))
            if found_inf is not None:
                new_p = torch.where(found_inf, compute_p, new_p)
                new_slots = {k: torch.where(found_inf, st["slots"][k], v)
                             for k, v in new_slots.items()}
            st["slots"] = new_slots
            if master is not None:
                st["master"] = new_p
            p.copy_(new_p.to(p.dtype))
        self._step = (step if found_inf is None
                      else torch.where(found_inf, self._step, step))
        return None

    def clear_grad(self) -> None:
        self.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, object]:
        """``{"state": {"step", "slots", "master"}}``, plus ``"lr"`` (the
        scheduler's state) with a scheduler: the JAX optimizer's
        ``state_dict``, keyed by parameter name.  The tensors are the live
        state (copy them to keep a snapshot)."""
        self._ensure_state()
        sd: Dict[str, object] = {"state": {
            "step": self._step,
            "slots": {n: dict(self.state[p]["slots"])
                      for n, p in zip(self._names, self._params)},
            "master": {n: self.state[p]["master"]
                       for n, p in zip(self._names, self._params)}}}
        if isinstance(self._lr, LRScheduler):
            sd["lr"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, sd) -> None:
        """Load a :meth:`state_dict` (tensors or numpy arrays; a JAX state
        goes through ``convert.optimizer_state_from_jax``).  Every
        parameter's slots must be given; a master is taken where the state
        has one."""
        self._ensure_state()
        state = sd["state"]
        dev = self._params[0].device
        step = state["step"]
        step = step if torch.is_tensor(step) else torch.from_numpy(
            np.asarray(step))
        self._step = step.to(device=dev, dtype=torch.int32).reshape(())
        self._host_step = int(self._step)
        for n, p in zip(self._names, self._params):
            slots = state["slots"][n] or {}
            st = self.state[p]
            enforce(set(slots) == set(st["slots"]),
                    f"{n}: slots {sorted(slots)} != {sorted(st['slots'])}")
            st["slots"] = {k: _as_f32(v, p.device) for k, v in slots.items()}
            master = state.get("master", {}).get(n)
            st["master"] = None if master is None else _as_f32(master,
                                                                p.device)
        if isinstance(self._lr, LRScheduler) and "lr" in sd:
            self._lr.set_state_dict(sd["lr"])

    load_state_dict = set_state_dict

    def append_regularization_ops(self, params_grads, regularization=None):
        """Add the regularizer's gradient term to each ``(param, grad)``:
        ``coeff * sign(p)`` for an ``L1Decay``, ``coeff * p`` otherwise
        (the step folds the optimizer's own decay in at apply time)."""
        coeff = getattr(regularization, "coeff", None)
        if coeff is None:
            return params_grads
        if isinstance(regularization, L1Decay):
            return [(p, g + coeff * torch.sign(p)) for p, g in params_grads]
        return [(p, g + coeff * p) for p, g in params_grads]

    def get_opti_var_name_list(self):
        """The slot names, ``"<param>.<slot>"`` as the JAX state's."""
        self._ensure_state()
        return [f"{n}.{s}" for n, p in zip(self._names, self._params)
                for s in self.state[p]["slots"]]

    # -- subclass hooks ----------------------------------------------------
    def _init_slot(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, g, p, slots, lr, t, wd):
        raise NotImplementedError


def _as_f32(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device=device, dtype=torch.float32).clone()


def _zeros(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _wd_product(lr: float, wd: float) -> float:
    """``lr * wd`` in float32, as the JAX ``lr_t * wd``."""
    return float(np.float32(lr) * np.float32(wd))


# ---------------------------------------------------------------------------
# Update rules (float32; the JAX package's order of operations)
# ---------------------------------------------------------------------------
class SGD(Optimizer):
    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        return p - lr * g, slots


class Momentum(Optimizer):
    """velocity = mu * velocity + grad; param -= lr * (grad + mu *
    velocity) with Nesterov, else lr * velocity."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        v = self.momentum * slots["velocity"] + g
        if self.use_nesterov:
            new_p = p - lr * (g + self.momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon = epsilon

    def _init_slot(self, p):
        return {"moment": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        m = slots["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.rho, self.epsilon, self.momentum = rho, epsilon, momentum

    def _init_slot(self, p):
        return {"mean_square": _zeros(p), "momentum": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        ms = (self.rho * slots["mean_square"]
              + (1 - self.rho) * torch.square(g))
        mom = (self.momentum * slots["momentum"]
               + lr * g / torch.sqrt(ms + self.epsilon))
        return p - mom, {"mean_square": ms, "momentum": mom}


class Adam(Optimizer):
    """Adam with L2-coupled weight decay (``g + wd * p``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, lazy_mode=False,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, apply_decay_param_fun)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._decoupled = False

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd and not self._decoupled:
            g = g + wd * p
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * g
        v = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(g)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        new_p = p - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        if wd and self._decoupled:
            new_p = new_p - _wd_product(lr, wd) * p
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         apply_decay_param_fun=apply_decay_param_fun)
        self._decoupled = True


class AdamMax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        m = self.beta1 * slots["moment"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * slots["inf_norm"], torch.abs(g))
        new_p = p - lr / (1 - self.beta1 ** t) * m / (u + self.epsilon)
        return new_p, {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    """The Adam direction scaled by the trust ratio ||p|| / ||update||."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True):
        # exclude_from_weight_decay_fn(name) -> True means no decay: the
        # inverse polarity of apply_decay_param_fun
        apply_fn = None
        if exclude_from_weight_decay_fn is not None:
            def apply_fn(name):
                return not exclude_from_weight_decay_fn(name)
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision,
                         apply_decay_param_fun=apply_fn)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * g
        v = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(g)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        update = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * p
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        u_norm = torch.sqrt(torch.sum(torch.square(update)))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * update, {"moment1": m, "moment2": v}


class Lars(Optimizer):
    """Momentum SGD with the layerwise lr ``lars_coeff * ||p|| / (||g|| +
    wd * ||p|| + eps)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=1e-9, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True):
        apply_fn = None
        if exclude_from_weight_decay_fn is not None:
            def apply_fn(name):
                return not exclude_from_weight_decay_fn(name)
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, multi_precision,
                         apply_decay_param_fun=apply_fn)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.epsilon = epsilon

    def _init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.lars_coeff * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        v = (self.momentum * slots["velocity"]
             + lr * local_lr * (g + wd * p))
        return p - v, {"velocity": v}


class Adadelta(Optimizer):
    """Accumulated-gradient / accumulated-update adaptive steps."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon, self.rho = epsilon, rho

    def _init_slot(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update(self, g, p, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        eg = (self.rho * slots["avg_squared_grad"]
              + (1 - self.rho) * torch.square(g))
        upd = (torch.sqrt(slots["avg_squared_update"] + self.epsilon)
               / torch.sqrt(eg + self.epsilon)) * g
        eu = (self.rho * slots["avg_squared_update"]
              + (1 - self.rho) * torch.square(upd))
        return p - lr * upd, {"avg_squared_grad": eg,
                              "avg_squared_update": eu}


Adamax = AdamMax      # the reference spells the public class "Adamax"
