"""paddle.regularizer: the port's own copy of ``paddle_tpu/regularizer.py``
(``L1Decay`` / ``L2Decay``), applied by the optimizer as a gradient
addition: L2 adds ``coeff * param``, L1 adds ``coeff * sign(param)``."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """Lasso: adds ``coeff * sign(param)`` to the gradient."""


class L2Decay(WeightDecayRegularizer):
    """Ridge: adds ``coeff * param`` to the gradient (for the decoupled
    optimizers, AdamW, the coefficient feeds the decoupled decay)."""
