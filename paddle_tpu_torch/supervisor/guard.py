"""Divergence guard: the port's own copy of ``paddle_tpu/supervisor/
guard.py``, rolling loss / grad-norm statistics with a
skip → lower-LR → rollback escalation ladder.

Generalizes hapi's ``nonfinite_skip_budget``, which could only
"skip the batch": a batch is *bad* when its loss (or grad global norm)
is non-finite OR spikes by ``spike_factor``× over the rolling median of
the recent healthy window.  Consecutive bad batches climb the ladder:

    1..skip_budget               SKIP       drop the update, keep going
    next max_lr_backoffs times   LOWER_LR   also multiply LR by
                                            ``lr_backoff`` (sticky until
                                            explicitly restored)
    after that                   ROLLBACK   restore last-good checkpoint

A healthy batch resets the consecutive counter (one cosmic-ray batch
costs one update, not an escalation), but the *lifetime* bad count and
the lowered LR persist — a run that keeps spiking is drifting, not
unlucky.

AMP-awareness: while dynamic loss scaling is active, overflow steps are
an expected part of the scale search — the first ``amp_grace``
non-finite observations are skipped WITHOUT climbing the ladder, exactly
mirroring GradScaler's own "shrink the scale and retry" contract.
"""
from __future__ import annotations

from collections import deque
from statistics import median
from typing import Optional

from ..framework.log import vlog

__all__ = ["GuardAction", "DivergenceGuard"]


def _finite(x: Optional[float]) -> bool:
    return x is not None and x == x and abs(x) != float("inf")


class GuardAction:
    OK = "ok"
    SKIP = "skip"
    LOWER_LR = "lower-lr"
    ROLLBACK = "rollback"


class DivergenceGuard:
    """Feed it every step's host-side loss (and optionally the grad
    global norm); it answers what the training loop should do.

    >>> guard = DivergenceGuard(skip_budget=2)
    >>> guard.observe(step, loss, grad_norm)   # → a GuardAction value
    """

    def __init__(self, window: int = 32, spike_factor: float = 10.0,
                 skip_budget: int = 2, lr_backoff: float = 0.5,
                 max_lr_backoffs: int = 1, amp_grace: int = 3,
                 min_history: int = 4, report=None):
        self.window = deque(maxlen=int(window))
        self.norm_window = deque(maxlen=int(window))
        self.spike_factor = float(spike_factor)
        self.skip_budget = int(skip_budget)
        self.lr_backoff = float(lr_backoff)
        self.max_lr_backoffs = int(max_lr_backoffs)
        self.amp_grace = int(amp_grace)
        self.min_history = int(min_history)
        self.report = report
        self.lr_scale = 1.0
        self.consecutive_bad = 0
        self.total_bad = 0
        self.lr_backoffs = 0
        self.amp_overflows = 0

    # -- classification ----------------------------------------------------
    def _spiking(self, value: Optional[float], history: deque) -> bool:
        if value is None or len(history) < self.min_history:
            return False
        base = abs(median(history))
        return abs(value) > self.spike_factor * max(base, 1e-12)

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None,
                amp_active: bool = False) -> str:
        loss = None if loss is None else float(loss)
        grad_norm = None if grad_norm is None else float(grad_norm)
        nonfinite = not _finite(loss) or (grad_norm is not None
                                          and not _finite(grad_norm))
        if nonfinite and amp_active and self.amp_overflows < self.amp_grace:
            # loss-scale search overflow: skip the update, don't escalate
            self.amp_overflows += 1
            self._event("amp_overflow_skip", step=step, loss=loss,
                        grad_norm=grad_norm)
            return GuardAction.SKIP
        bad = (nonfinite or self._spiking(loss, self.window)
               or self._spiking(grad_norm, self.norm_window))
        if not bad:
            self.consecutive_bad = 0
            if loss is not None:
                self.window.append(loss)
            if grad_norm is not None:
                self.norm_window.append(grad_norm)
            return GuardAction.OK
        self.consecutive_bad += 1
        self.total_bad += 1
        reason = "nonfinite" if nonfinite else "spike"
        if self.consecutive_bad <= self.skip_budget:
            self._event("divergence_skip", step=step, loss=loss,
                        grad_norm=grad_norm, reason=reason,
                        consecutive=self.consecutive_bad)
            return GuardAction.SKIP
        if self.lr_backoffs < self.max_lr_backoffs:
            self.lr_backoffs += 1
            self.lr_scale *= self.lr_backoff
            self._event("lr_backoff", step=step, loss=loss, reason=reason,
                        lr_scale=self.lr_scale)
            return GuardAction.LOWER_LR
        self._event("divergence_rollback", step=step, loss=loss,
                    grad_norm=grad_norm, reason=reason,
                    consecutive=self.consecutive_bad)
        return GuardAction.ROLLBACK

    # -- lifecycle ---------------------------------------------------------
    def reset_after_rollback(self) -> None:
        """Restored state invalidates the rolling statistics; the lowered
        LR persists — whatever diverged once will diverge again at the
        old rate."""
        self.window.clear()
        self.norm_window.clear()
        self.consecutive_bad = 0

    def restore_lr(self) -> None:
        self.lr_scale = 1.0
        self.lr_backoffs = 0

    def _event(self, kind: str, **fields) -> None:
        vlog(0, "guard: %s %s", kind, fields)
        if self.report is not None:
            self.report.record(kind, **fields)
