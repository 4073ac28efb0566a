"""LR schedulers: the port of ``paddle_tpu/optimizer/lr.py``.

Each scheduler is stateful (``step()`` / ``get_lr()``, the paddle dygraph
form that the stateful optimizer reads) and functional (``sched(step)``).
The values are computed on the host in float32 numpy, op for op in the
JAX package's order and precision (its schedules are float32 ``jnp``
arithmetic), so an optimizer takes them as float32 host scalars and a step
copies nothing to the card for its lr.  Python-float constants (``base_lr *
d_model ** -0.5``, ``base_lr - eta_min``) are folded in double first and
rounded once, as JAX's weak typing does.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LRScheduler", "NoamDecay", "StepDecay", "MultiStepDecay",
           "ExponentialDecay", "PolynomialDecay", "CosineAnnealingDecay",
           "LinearWarmup", "PiecewiseDecay", "LambdaDecay",
           "ReduceOnPlateau", "NaturalExpDecay", "InverseTimeDecay",
           "MultiplicativeDecay"]

_f32 = np.float32


def _step_f32(step) -> np.float32:
    """``jnp.maximum(step, 0).astype(float32)``."""
    return _f32(max(step, 0))


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()  # advance to epoch 0, paddle semantics

    def __call__(self, step) -> np.float32:
        """Functional form: the lr at ``step``, float32."""
        return self._compute(step)

    def _compute(self, step) -> np.float32:
        raise NotImplementedError

    def get_lr(self) -> float:
        return float(self._compute(self.last_epoch))

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, state):
        self.last_epoch = int(state["last_epoch"])


class NoamDecay(LRScheduler):
    """Transformer schedule: ``lr * d_model^-0.5 * min(t^-0.5, t *
    warmup^-1.5)``."""

    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1,
                 verbose: bool = False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        step = _f32(max(step, 1))
        a = step ** _f32(-0.5)
        b = step * _f32(self.warmup_steps ** -1.5)
        return _f32(self.base_lr * (self.d_model ** -0.5)) * min(a, b)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        n = max(int(step), 0) // self.step_size
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(n)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones, gamma: float = 0.1,
                 last_epoch: int = -1, verbose: bool = False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        n = sum(max(int(step), 0) >= m for m in self.milestones)
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(n)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        return (_f32(self.base_lr)
                * _f32(self.gamma) ** _f32(max(int(step), 0)))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False, last_epoch: int = -1,
                 verbose: bool = False):
        self.decay_steps, self.end_lr, self.power = decay_steps, end_lr, power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        t = min(_step_f32(step), _f32(self.decay_steps)) / _f32(
            self.decay_steps)
        return (_f32(self.base_lr - self.end_lr)
                * (_f32(1) - t) ** _f32(self.power) + _f32(self.end_lr))


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int,
                 eta_min: float = 0.0, last_epoch: int = -1,
                 verbose: bool = False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        frac = (_f32(math.pi) * min(_step_f32(step), _f32(self.T_max))
                / _f32(self.T_max))
        cos = np.cos(frac)
        return (_f32(self.eta_min) + _f32(self.base_lr - self.eta_min)
                * (_f32(1) + cos) / _f32(2))


class LinearWarmup(LRScheduler):
    """Linear warmup from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate``: a float or another scheduler, which sees the
    step less the warmup."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1, verbose: bool = False):
        self.inner = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        base = (learning_rate if isinstance(learning_rate, float)
                else learning_rate.base_lr)
        super().__init__(base, last_epoch, verbose)

    def _compute(self, step):
        step = _step_f32(step)
        if step < _f32(self.warmup_steps):
            return (_f32(self.start_lr)
                    + _f32(self.end_lr - self.start_lr)
                    * min(step, _f32(self.warmup_steps))
                    / _f32(max(self.warmup_steps, 1)))
        if isinstance(self.inner, LRScheduler):
            return self.inner._compute(step - _f32(self.warmup_steps))
        return _f32(self.inner)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch: int = -1,
                 verbose: bool = False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def _compute(self, step):
        idx = sum(max(int(step), 0) >= b for b in self.boundaries)
        return _f32(self.values[idx])


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda, last_epoch: int = -1,
                 verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        return _f32(self.base_lr * self.lr_lambda(step))


class ReduceOnPlateau(LRScheduler):
    """Stateful only: the lr drops by ``factor`` after ``patience`` steps
    whose metric did not improve by ``threshold``."""

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0, verbose: bool = False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.cooldown, self.min_lr = (threshold, cooldown,
                                                      min_lr)
        self._lr = learning_rate
        self._best = None
        self._bad = 0
        self._cool = 0
        super().__init__(learning_rate, -1, verbose)

    def _compute(self, step):
        return _f32(self._lr)

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics)
        better = (self._best is None or
                  (m < self._best - self.threshold if self.mode == "min"
                   else m > self._best + self.threshold))
        if better:
            self._best, self._bad = m, 0
        elif self._cool > 0:
            self._cool -= 1
        else:
            self._bad += 1
            if self._bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self._bad, self._cool = 0, self.cooldown


class NaturalExpDecay(LRScheduler):
    """``lr * e^(-gamma * epoch)``."""

    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        return _f32(self.base_lr) * np.exp(_f32(-self.gamma) * _f32(step))


class InverseTimeDecay(LRScheduler):
    """``lr / (1 + gamma * epoch)``."""

    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        return _f32(self.base_lr) / (_f32(1.0)
                                     + _f32(self.gamma) * _f32(step))


class MultiplicativeDecay(LRScheduler):
    """``lr * prod_{e <= epoch} lr_lambda(e)``, the product in double."""

    def __init__(self, learning_rate: float, lr_lambda,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute(self, step):
        factor = 1.0
        for e in range(1, int(step) + 1):
            factor *= self.lr_lambda(e)
        return _f32(self.base_lr * factor)
