"""Automatic mixed precision: the port of ``paddle_tpu/amp/__init__.py``:
``auto_cast`` (the O1 / O2 cast policy of :mod:`.state`), ``decorate`` (O2:
low-precision parameters, float32 master weights in the optimizer) and the
dynamic loss scaler ``GradScaler``.

The scaler's state (scale, good and bad step counts) lives on the card, and
so does ``found_inf``: the stateful :meth:`GradScaler.step` hands the flag to
the optimizer, which keeps the old state where it is set, and updates the
scale with device ops, so no step reads the card back.  (The JAX stateful
``step`` reads ``bool(found_inf)`` on the host to choose.)
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from ..framework.errors import enforce
from . import state as _state
from .state import BLACK_OPS, WHITE_OPS  # noqa: F401

__all__ = ["auto_cast", "decorate", "GradScaler", "WHITE_OPS", "BLACK_OPS"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Context under which white-listed ops run in ``dtype`` and
    black-listed ops in float32.  ``custom_white_list`` /
    ``custom_black_list`` add op names to :data:`WHITE_OPS` /
    :data:`BLACK_OPS` for the context; names already on a list stay on it
    after the context, as in the JAX package."""
    enforce(level in ("O1", "O2"), f"level must be O1 or O2, got {level!r}")
    enforce(dtype in _DTYPES, f"unsupported amp dtype {dtype!r}")
    added_w = set(custom_white_list or ()) - WHITE_OPS
    added_b = set(custom_black_list or ()) - BLACK_OPS
    WHITE_OPS.update(added_w)
    BLACK_OPS.update(added_b)
    prev = _state.push(enable, level, _DTYPES[dtype])
    try:
        yield
    finally:
        _state.pop(prev)
        WHITE_OPS.difference_update(added_w)
        BLACK_OPS.difference_update(added_b)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None):
    """O2 decoration: cast every floating parameter and buffer of the
    models to ``dtype`` in place (the parameter objects stay, so an
    optimizer built on them stays bound); the optimizers keep float32
    master weights (``multi_precision``), built at their first step from
    the cast parameters, as the JAX optimizer's ``init`` of the decorated
    parameters.  Returns ``models`` or ``(models, optimizers)``."""
    enforce(level in ("O1", "O2"), f"level must be O1 or O2, got {level!r}")
    enforce(dtype in _DTYPES, f"unsupported amp dtype {dtype!r}")
    if level == "O2":
        low = _DTYPES[dtype]
        for m in (models if isinstance(models, (list, tuple)) else [models]):
            for t in (*m.parameters(), *m.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(low)
    if optimizers is None:
        return models
    for o in (optimizers if isinstance(optimizers, (list, tuple))
              else [optimizers]):
        if master_weight is not False:
            o.multi_precision = True
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling.

    Functional form (device tensors throughout):

        st = scaler.init_state(device)
        scaled = scaler.scale_value(loss, st)
        grads, found_inf = scaler.unscale_and_check(grads, st)
        st = scaler.update_state(st, found_inf)

    Stateful form: ``scaler.scale(loss).backward(); scaler.step(opt)``
    (``minimize`` is the same step; ``update`` is folded into it), with
    ``unscale_(opt)`` first for the grad-clipping idiom.
    """

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.use_dynamic = use_dynamic_loss_scaling
        self._st = self.init_state()
        self._found_inf: Optional[torch.Tensor] = None   # set by unscale_

    def is_enable(self) -> bool:
        return self._enable

    # -- functional -------------------------------------------------------
    def init_state(self, device="cpu") -> Dict[str, torch.Tensor]:
        scale = self.init_loss_scaling if self._enable else 1.0
        return {"scale": torch.tensor(scale, dtype=torch.float32,
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device)}

    def scale_value(self, loss: torch.Tensor, state) -> torch.Tensor:
        if not self._enable:
            return loss
        return loss * state["scale"].to(loss.dtype)

    def unscale_and_check(self, grads: List[torch.Tensor], state
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Every gradient times ``1 / scale`` (in float32, back to its
        dtype), and one bool device flag: some unscaled value is not
        finite."""
        if not self._enable:
            dev = grads[0].device if grads else "cpu"
            return grads, torch.zeros((), dtype=torch.bool, device=dev)
        inv = 1.0 / state["scale"]
        unscaled = [(g.float() * inv).to(g.dtype) for g in grads]
        finite = torch.stack([torch.isfinite(g).all() for g in unscaled])
        return unscaled, ~finite.all()

    def update_state(self, state, found_inf: torch.Tensor):
        """The loss-scaling state machine: ``decr_every_n_nan_or_inf`` bad
        steps in a row scale down by ``decr_ratio`` (not below 1),
        ``incr_every_n_steps`` good ones scale up by ``incr_ratio``."""
        if not self._enable or not self.use_dynamic:
            return state
        scale, good, bad = state["scale"], state["good"], state["bad"]
        zero = torch.zeros_like(bad)
        bad_n = torch.where(found_inf, bad + 1, zero)
        good_n = torch.where(found_inf, zero, good + 1)
        decr = bad_n >= self.decr_every_n_nan_or_inf
        incr = good_n >= self.incr_every_n_steps
        new_scale = torch.where(
            decr, torch.clamp(scale * self.decr_ratio, min=1.0),
            torch.where(incr, scale * self.incr_ratio, scale))
        return {"scale": new_scale,
                "good": torch.where(incr, zero, good_n),
                "bad": torch.where(decr, zero, bad_n)}

    # -- stateful -----------------------------------------------------------
    def _on(self, device: torch.device) -> None:
        if self._st["scale"].device != device:
            self._st = {k: v.to(device) for k, v in self._st.items()}

    def scale(self, value: torch.Tensor) -> torch.Tensor:
        self._on(value.device)
        return self.scale_value(value, self._st)

    @staticmethod
    def _grads(optimizer):
        return [p for p in optimizer._params if p.grad is not None]

    def unscale_(self, optimizer):
        """Unscale the bound parameters' gradients in place and keep the
        finite check for the following :meth:`step`, which then does not
        unscale again (the grad-clipping idiom)."""
        params = self._grads(optimizer)
        if self._enable and params:
            self._on(params[0].device)
            unscaled, self._found_inf = self.unscale_and_check(
                [p.grad for p in params], self._st)
            for p, g in zip(params, unscaled):
                p.grad.copy_(g)
        return optimizer

    def step(self, optimizer) -> None:
        """Unscale and check the gradients (unless :meth:`unscale_` did),
        step the optimizer with ``found_inf`` (the skip happens on the
        card) and update the scale."""
        if not self._enable:
            optimizer.step()
            return
        params = self._grads(optimizer)
        if not params:
            return
        if self._found_inf is None:
            self.unscale_(optimizer)
        found_inf, self._found_inf = self._found_inf, None
        optimizer.step(found_inf=found_inf)
        self._st = self.update_state(self._st, found_inf)

    def minimize(self, optimizer, scaled_loss=None) -> None:
        self.step(optimizer)

    def update(self) -> None:
        pass  # folded into step()

    # -- accessors ---------------------------------------------------------
    def is_use_dynamic_loss_scaling(self) -> bool:
        return self.use_dynamic

    def get_init_loss_scaling(self) -> float:
        return float(self.init_loss_scaling)

    def set_init_loss_scaling(self, v) -> None:
        self.init_loss_scaling = float(v)
        self._st = self.init_state(self._st["scale"].device)

    def get_incr_ratio(self) -> float:
        return self.incr_ratio

    def set_incr_ratio(self, v) -> None:
        enforce(v > 1.0, "incr_ratio must be > 1")
        self.incr_ratio = float(v)

    def get_decr_ratio(self) -> float:
        return self.decr_ratio

    def set_decr_ratio(self, v) -> None:
        enforce(0.0 < v < 1.0, "decr_ratio must be in (0, 1)")
        self.decr_ratio = float(v)

    def get_incr_every_n_steps(self) -> int:
        return self.incr_every_n_steps

    def set_incr_every_n_steps(self, v) -> None:
        self.incr_every_n_steps = int(v)

    def get_decr_every_n_nan_or_inf(self) -> int:
        return self.decr_every_n_nan_or_inf

    def set_decr_every_n_nan_or_inf(self, v) -> None:
        self.decr_every_n_nan_or_inf = int(v)

    def get_loss_scaling(self) -> float:
        """The current scale (a readback: waits for the card)."""
        return float(self._st["scale"])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._st)

    def load_state_dict(self, sd) -> None:
        dev = self._st["scale"].device
        dtypes = {"scale": torch.float32, "good": torch.int32,
                  "bad": torch.int32}
        self._st = {k: torch.as_tensor(sd[k]).to(device=dev,
                                                 dtype=dtypes[k]).reshape(())
                    for k in dtypes}
