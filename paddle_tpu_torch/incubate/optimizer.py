"""Incubate optimizers: the port of ``paddle_tpu/incubate/optimizer.py``
(reference incubate/optimizer/lookahead.py ``LookAhead``,
modelaverage.py ``ModelAverage``, distributed_fused_lamb.py
``DistributedFusedLamb``).

The JAX classes are functional (``init`` / ``apply_gradients``); these
are stateful, as the port's optimizers are: ``step()`` applies the bound
parameters' ``.grad``.  ``LookAhead`` and ``ModelAverage`` wrap a port
optimizer (anything with ``step()`` over ``_params``) and keep their
extra float32 state beside it, with the JAX arithmetic: the slow weights
and the ``k``-step blend, the growing-window streaming sum.
``DistributedFusedLamb`` keeps every parameter in one flat float32 master
buffer with its two moments, and takes one LAMB step over the whole
buffer with a trust ratio per parameter segment.  On one card its state
is not sharded (that waits on the port's multi-GPU data parallelism).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..framework.errors import enforce

__all__ = ["LookAhead", "ModelAverage", "DistributedFusedLamb"]


def _inner_params(inner):
    enforce(hasattr(inner, "_params") and hasattr(inner, "_names"),
            "the inner optimizer must be a port optimizer built with "
            "parameters=")
    return inner._params, inner._names


class LookAhead:
    """k steps forward, one step back (Zhang et al. 2019): every ``k``
    inner steps, slow += alpha * (fast - slow) in float32 and the fast
    weights take the slow ones (cast to their dtype).  The slow weights
    are the parameters as they are at the first ``step()``."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        enforce(0.0 <= alpha <= 1.0, "alpha must be in [0, 1]")
        enforce(k >= 1, "k must be >= 1")
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self.slow: Optional[Dict[str, torch.Tensor]] = None
        self.step_count = 0

    def __getattr__(self, item):
        return getattr(self.inner, item)

    @torch.no_grad()
    def step(self, *args, **kwargs):
        params, names = _inner_params(self.inner)
        if self.slow is None:
            self.slow = {n: p.detach().float().clone()
                         for n, p in zip(names, params)}
        self.inner.step(*args, **kwargs)
        self.step_count += 1
        if self.step_count % self.k:
            return
        for n, p in zip(names, params):
            slow = self.slow[n]
            slow.add_(self.alpha * (p.float() - slow))
            p.copy_(slow.to(p.dtype))

    def clear_grad(self):
        self.inner.clear_grad()

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "slow": self.slow,
                "step": self.step_count}

    def set_state_dict(self, sd):
        self.inner.set_state_dict(sd["inner"])
        self.slow = None if sd["slow"] is None else {
            n: torch.as_tensor(v).float().clone()
            for n, v in sd["slow"].items()}
        self.step_count = int(sd["step"])


class ModelAverage:
    """A windowed average of the parameters for evaluation (reference
    ModelAverage).  The window at update ``t`` is ``clip(ceil(rate * t),
    min_average_window, max_average_window)``, the reference's growing
    window, kept as a float32 streaming sum whose old mass decays by
    ``1 - 1 / window`` once ``t`` exceeds the window.  :meth:`average`
    gives the averaged parameters; :meth:`apply` swaps them into the
    model (and :meth:`restore` puts the trained ones back, exactly)."""

    def __init__(self, inner_optimizer, average_window_rate: float = 0.15,
                 min_average_window: int = 1,
                 max_average_window: Optional[int] = None):
        self.inner = inner_optimizer
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window or 10000
        self.sum: Optional[Dict[str, torch.Tensor]] = None
        self.count = 0
        self._backup: Optional[Dict[str, torch.Tensor]] = None

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def _window(self, count: int) -> np.float32:
        w = np.ceil(np.float32(self.rate) * np.float32(count))
        return np.float32(np.clip(w, self.min_window, self.max_window))

    @torch.no_grad()
    def step(self, *args, **kwargs):
        params, names = _inner_params(self.inner)
        if self.sum is None:
            self.sum = {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in zip(names, params)}
        self.inner.step(*args, **kwargs)
        self.count += 1
        window = self._window(self.count)
        keep = (np.float32(1.0) - np.float32(1.0) / window
                if np.float32(self.count) > window else np.float32(1.0))
        for n, p in zip(names, params):
            s = self.sum[n]
            s.mul_(float(keep)).add_(p.float())

    def average(self) -> Dict[str, torch.Tensor]:
        """The averaged parameters by name, in each parameter's dtype."""
        params, names = _inner_params(self.inner)
        enforce(self.sum is not None, "average() before the first step()")
        eff = float(max(min(np.float32(self.count),
                            self._window(self.count)), np.float32(1.0)))
        return {n: (self.sum[n] / eff).to(p.dtype)
                for n, p in zip(names, params)}

    @torch.no_grad()
    def apply(self, executor=None, need_restore: bool = True):
        """Swap the averaged parameters in.  Used as a context manager it
        puts the trained parameters back on exit when ``need_restore``."""
        params, names = _inner_params(self.inner)
        avg = self.average()
        self._backup = {n: p.detach().clone() for n, p in zip(names, params)}
        for n, p in zip(names, params):
            p.copy_(avg[n])
        return self._restoring(need_restore)

    @contextlib.contextmanager
    def _restoring(self, need_restore):
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        """Put back the parameters :meth:`apply` replaced."""
        if self._backup is None:
            return
        params, names = _inner_params(self.inner)
        for n, p in zip(names, params):
            p.copy_(self._backup[n])
        self._backup = None

    def clear_grad(self):
        self.inner.clear_grad()

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "sum": self.sum,
                "count": self.count}

    def set_state_dict(self, sd):
        self.inner.set_state_dict(sd["inner"])
        self.sum = None if sd["sum"] is None else {
            n: torch.as_tensor(v).float().clone()
            for n, v in sd["sum"].items()}
        self.count = int(sd["count"])


class DistributedFusedLamb:
    """Fused LAMB over one flat float32 master buffer (reference
    incubate/optimizer/distributed_fused_lamb.py and its fused CUDA op).

    Every parameter is a segment of the buffer (padded to ``alignment``),
    so one chain of vector ops updates them all; segment sums give each
    parameter its trust ratio ``|w| / |update|``.  ``grad_clip`` takes a
    ``ClipGradByGlobalNorm`` (``max_global_grad_norm``);
    ``exclude_from_weight_decay_fn(name)`` turns decay off by parameter
    name; :meth:`set_scale` divides the gradients by a loss scale, and a
    step whose gradients hold a nonfinite value leaves the buffers, the
    parameters and the step count as they were, decided on the card.
    A float ``learning_rate`` needs no readback; an ``LRScheduler`` is
    asked for the lr at the step count, which reads the count back.
    """

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None,
                 clip_after_allreduce: bool = True,
                 is_grad_scaled_by_nranks: bool = True,
                 alignment: int = 128,
                 use_master_param_norm: bool = True):
        from ..optimizer import ClipGradByGlobalNorm, _named
        self._lr = learning_rate
        self._wd = float(lamb_weight_decay or 0.0)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._exclude = exclude_from_weight_decay_fn
        enforce(clip_after_allreduce,
                "clip_after_allreduce=False is not supported: the gradient "
                "is reduced before any optimizer math runs")
        enforce(use_master_param_norm,
                "use_master_param_norm=False is not supported: trust "
                "ratios are computed on the float32 master buffer")
        self._grad_scaled_by_nranks = bool(is_grad_scaled_by_nranks)
        self._params, self._names = _named(parameters)
        if grad_clip is not None:
            enforce(isinstance(grad_clip, ClipGradByGlobalNorm),
                    "Only ClipGradByGlobalNorm is supported in "
                    "DistributedFusedLamb")
            self._max_gnorm = float(grad_clip.clip_norm)
        else:
            self._max_gnorm = -1.0
        self._alignment = int(alignment)
        self._scale = None
        self._state: Optional[Dict[str, torch.Tensor]] = None

    def set_scale(self, scale):
        """AMP hook: gradients are divided by ``scale``."""
        self._scale = scale

    # -- flat layout --------------------------------------------------------
    def _layout(self):
        sizes = [p.numel() for p in self._params]
        total = sum(sizes)
        pad = (-total) % max(self._alignment, 1)
        return sizes, total, pad

    def _flatten(self, tensors, pad):
        vec = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        return torch.nn.functional.pad(vec, (0, pad))

    def _ensure_state(self):
        if self._state is not None:
            return
        sizes, total, pad = self._layout()
        master = self._flatten(self._params, pad)
        dev = master.device
        wd = torch.tensor(
            [0.0 if self._exclude is not None and self._exclude(n) else 1.0
             for n in self._names] + [0.0], dtype=torch.float32, device=dev)
        self._lengths = torch.tensor(sizes + [pad], dtype=torch.int64,
                                     device=dev)
        self._wd_mask = wd.repeat_interleave(self._lengths,
                                             output_size=total + pad)
        self._state = {"master": master,
                       "moment1": torch.zeros_like(master),
                       "moment2": torch.zeros_like(master),
                       "step": torch.zeros((), dtype=torch.int32,
                                           device=dev)}

    def _segment_sum(self, x):
        return torch.segment_reduce(x, "sum", lengths=self._lengths)

    @torch.no_grad()
    def step(self, grads=None):
        """One LAMB step with ``grads`` (a list in parameter order), or
        the parameters' ``.grad``."""
        from ..optimizer.lr import LRScheduler
        self._ensure_state()
        sizes, total, pad = self._layout()
        if grads is None:
            grads = [p.grad for p in self._params]
        enforce(all(g is not None for g in grads),
                "DistributedFusedLamb.step needs a gradient for every "
                "parameter")
        st = self._state
        g = self._flatten(grads, pad)
        found_inf = ~torch.all(torch.isfinite(g))
        if self._scale is not None:
            g = g / torch.as_tensor(self._scale, dtype=torch.float32,
                                    device=g.device)
        # one card: the data-parallel degree is 1, so a sum over ranks is
        # already the mean (is_grad_scaled_by_nranks changes nothing)
        if self._max_gnorm > 0:
            gnorm = torch.sqrt(torch.sum(torch.square(g)))
            g = g * torch.clamp(self._max_gnorm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        step = st["step"] + 1
        t = step.float()
        if isinstance(self._lr, LRScheduler):
            lr_t = float(self._lr(int(step) - 1))
        else:
            lr_t = float(np.float32(self._lr))
        b1 = torch.tensor(self._b1, dtype=torch.float32, device=g.device)
        b2 = torch.tensor(self._b2, dtype=torch.float32, device=g.device)
        m = self._b1 * st["moment1"] + (1 - self._b1) * g
        v = self._b2 * st["moment2"] + (1 - self._b2) * torch.square(g)
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        master = st["master"]
        upd = mhat / (torch.sqrt(vhat) + self._eps)
        upd = upd + self._wd * self._wd_mask * master
        pnorm = torch.sqrt(self._segment_sum(torch.square(master)))
        unorm = torch.sqrt(self._segment_sum(torch.square(upd)))
        ratio = torch.where((pnorm > 0) & (unorm > 0),
                            pnorm / torch.clamp(unorm, min=1e-12),
                            torch.ones_like(pnorm))
        new_master = master - lr_t * ratio.repeat_interleave(
            self._lengths, output_size=total + pad) * upd
        st["master"] = torch.where(found_inf, master, new_master)
        st["moment1"] = torch.where(found_inf, st["moment1"], m)
        st["moment2"] = torch.where(found_inf, st["moment2"], v)
        st["step"] = torch.where(found_inf, st["step"], step)
        for p, seg in zip(self._params,
                          torch.split(st["master"][:total], sizes)):
            p.copy_(seg.view(p.shape).to(p.dtype))

    def state_dict(self):
        self._ensure_state()
        return {"state": self._state}

    def set_state_dict(self, sd):
        self._ensure_state()
        dev = self._state["master"].device
        for k, v in sd["state"].items():
            self._state[k] = torch.as_tensor(v).to(dev).clone()

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    def zero_grad(self, set_to_none: bool = True):
        if set_to_none:
            self.clear_grad()
        else:
            for p in self._params:
                if p.grad is not None:
                    p.grad.zero_()
