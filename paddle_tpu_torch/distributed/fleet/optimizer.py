"""Strategy-driven optimizer composition: the port of
``paddle_tpu/distributed/fleet/optimizer.py`` (``HybridParallelOptimizer``;
reference hybrid_parallel_optimizer.py:45, :216, amp_optimizer.py,
gradient_merge_optimizer.py).

:class:`HybridParallelOptimizer` wraps a port optimizer and applies, in
order, on each ``step()``:

- amp (``strategy.amp`` with fp16, or an ``init_loss_scaling``): the
  gradients are unscaled by the loss scale and checked; a non-finite step
  anywhere in the world skips the update on every rank and decays the
  scale (``scale_loss`` multiplies a loss by the current scale);
- ``gradient_merge``: ``k_steps`` calls accumulate the gradients (their
  mean with ``avg``), and only the k-th updates;
- the global-norm clip over the hybrid group: the inner optimizer's
  ``ClipGradByGlobalNorm`` is replaced by :class:`HybridClipGradByGlobalNorm`,
  which sums the squares across mp and pp.  A shard (``mp_sharded``)
  counts on every mp rank, a parameter the mp ranks hold whole (LN, the
  biases after the row all-reduce, ``wpe``) on mp rank 0 only, and the
  tied ``wte`` of the pipeline's two end stages on the first only.

Everything else is the inner optimizer's (``state_dict``, ``get_lr``,
``zero_grad``, ...).  :class:`HybridParallelGradScaler` is a ``GradScaler``
whose overflow flag is all-reduced over the world, so every rank skips
the same steps and keeps the same scale.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ... import amp
from ...optimizer import ClipGradByGlobalNorm
from .. import collective
from .. import topology as topo

__all__ = ["HybridParallelOptimizer", "HybridClipGradByGlobalNorm",
           "HybridParallelGradScaler", "norm_weight"]


def norm_weight(p: torch.Tensor) -> int:
    """1 when this rank's copy of ``p`` counts in the hybrid global norm,
    else 0 (see the module docstring)."""
    if getattr(p, "pp_tied", False) and topo.axis_rank("pp") != 0:
        return 0
    if getattr(p, "mp_sharded", False):
        return 1
    return 1 if topo.axis_rank("mp") == 0 else 0


def _world_any(flag: torch.Tensor) -> torch.Tensor:
    """A bool device flag set on any rank of the world."""
    total = collective.all_reduce(flag.to(torch.float32),
                                  op=collective.ReduceOp.MAX, group=None)
    return total > 0


class HybridClipGradByGlobalNorm(ClipGradByGlobalNorm):
    """``ClipGradByGlobalNorm`` of the whole model over the hybrid group:
    the clip of ``optimizer`` (whose live parameters are the gradients'
    order)."""

    def __init__(self, clip_norm: float, optimizer):
        super().__init__(clip_norm)
        self._opt = optimizer

    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        params = [p for p in self._opt._params if p.grad is not None]
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for p, g in zip(params, grads):
            if norm_weight(p):
                sq = sq + torch.square(
                    torch.linalg.vector_norm(g, dtype=torch.float32))
        sq = collective.all_reduce(sq, group="mp")
        sq = collective.all_reduce(sq, group="pp")
        norm = torch.sqrt(sq)
        self.last_norm = norm
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]


class HybridParallelOptimizer:
    """The meta-optimizer stack over ``inner`` (see the module
    docstring)."""

    def __init__(self, inner, strategy):
        self._inner = inner
        self._strategy = strategy
        from . import _amp_dtype
        cfg = dict(strategy.amp_configs or {})
        # loss scaling exists for fp16's narrow exponent; bf16 shares the
        # float32 exponent range, so the scaler stays off unless asked for
        scale_on = bool(strategy.amp) and (
            _amp_dtype(cfg) == "float16" or "init_loss_scaling" in cfg)
        self._scaler = amp.GradScaler(
            enable=scale_on,
            init_loss_scaling=float(cfg.get("init_loss_scaling", 2.0 ** 15)),
            incr_ratio=float(cfg.get("incr_ratio", 2.0)),
            decr_ratio=float(cfg.get("decr_ratio", 0.5)),
            incr_every_n_steps=int(cfg.get("incr_every_n_steps", 1000)),
            decr_every_n_nan_or_inf=int(
                cfg.get("decr_every_n_nan_or_inf", 2)))
        gm = dict(strategy.gradient_merge_configs or {})
        self._k = int(gm.get("k_steps", 1)) if strategy.gradient_merge else 1
        self._gm_avg = bool(gm.get("avg", True))
        self._gm_buf: Optional[List[torch.Tensor]] = None
        self.gm_step = 0
        clip = getattr(inner, "_grad_clip", None)
        if (isinstance(clip, ClipGradByGlobalNorm)
                and not isinstance(clip, HybridClipGradByGlobalNorm)):
            inner._grad_clip = HybridClipGradByGlobalNorm(clip.clip_norm,
                                                          inner)

    @property
    def inner(self):
        return self._inner

    @property
    def scaler(self) -> amp.GradScaler:
        return self._scaler

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` times the current loss scale (itself with the scaler
        off)."""
        return self._scaler.scale(loss)

    @torch.no_grad()
    def step(self, closure=None, found_inf: Optional[torch.Tensor] = None):
        """Unscale and check (amp), accumulate (gradient merge), then the
        inner step with the world's overflow flag."""
        params = [p for p in self._inner._params if p.grad is not None]
        if not params:
            return None
        if self._scaler.is_enable():
            self._scaler._on(params[0].device)
            grads, flag = self._scaler.unscale_and_check(
                [p.grad for p in params], self._scaler._st)
            for p, g in zip(params, grads):
                p.grad.copy_(g)
            found_inf = flag if found_inf is None else (found_inf | flag)
        if found_inf is not None:
            found_inf = _world_any(found_inf)
        if self._k > 1:
            if not self._merge(params, found_inf):
                self._update_scale(found_inf)
                return None
        if found_inf is None:
            self._inner.step()
        else:
            self._inner.step(found_inf=found_inf)
        self._update_scale(found_inf)
        return None

    def _merge(self, params, found_inf) -> bool:
        """Add this step's gradients to the buffers (none on an overflow);
        on the k-th good step put the merged gradients in place and return
        True, else clear them and return False."""
        if self._gm_buf is None:
            self._gm_buf = [torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device) for p in params]
        bad = found_inf is not None and bool(found_inf)
        if not bad:
            for b, p in zip(self._gm_buf, params):
                b.add_(p.grad.float())
            self.gm_step += 1
        if self.gm_step < self._k:
            for p in params:
                p.grad = None
            return False
        scale = 1.0 / self._k if self._gm_avg else 1.0
        for b, p in zip(self._gm_buf, params):
            p.grad = (b * scale).to(p.dtype)
            b.zero_()
        self.gm_step = 0
        return True

    def _update_scale(self, found_inf) -> None:
        if self._scaler.is_enable():
            self._scaler._st = self._scaler.update_state(
                self._scaler._st, found_inf)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._inner.zero_grad(set_to_none=set_to_none)

    def clear_grad(self) -> None:
        self._inner.clear_grad()

    def state_dict(self):
        """The inner state_dict plus the loss scale and the merge
        buffers (a resumed run keeps both)."""
        sd = dict(self._inner.state_dict())
        sd["hybrid"] = {"amp": dict(self._scaler._st),
                        "gm_step": self.gm_step, "gm_buf": self._gm_buf}
        return sd

    def set_state_dict(self, sd) -> None:
        sd = dict(sd)
        hybrid = sd.pop("hybrid", None)
        self._inner.set_state_dict(sd)
        if hybrid is not None:
            self._scaler._st = dict(hybrid["amp"])
            self.gm_step = int(hybrid["gm_step"])
            self._gm_buf = hybrid["gm_buf"]


class HybridParallelGradScaler(amp.GradScaler):
    """A ``GradScaler`` (the settings and state of ``scaler``) whose
    overflow flag is the world's."""

    def __init__(self, scaler: amp.GradScaler):
        self.__dict__.update(scaler.__dict__)

    def unscale_(self, optimizer):
        super().unscale_(optimizer)
        if self._found_inf is not None:
            self._found_inf = _world_any(self._found_inf)
        return optimizer
