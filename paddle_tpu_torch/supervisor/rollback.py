"""Auto-rollback to the last-good committed checkpoint: the port's own
copy of ``paddle_tpu/supervisor/rollback.py``.

The storage layer guarantees that ``ElasticTrainState`` always
holds a restorable chain of committed steps; this module decides *when*
to walk back down it.  On escalated divergence or repeated step failure
the :class:`RollbackManager` waits out any in-flight async save, restores
the newest committed good step through ``restore_or`` (which quarantines
anything corrupt on the way), rewinds the step counter to the restored
step, optionally reseeds the data pipeline, and lets training resume.

The whole mechanism is bounded by a **rollback budget**
(``PTPU_ROLLBACK_BUDGET``, default 2): a run that needs a third rollback
is broken, not unlucky, and :class:`RollbackBudgetExceeded` fails it
loudly with the post-mortem report path in the message.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

from ..framework.log import vlog

__all__ = ["RollbackManager", "RollbackBudgetExceeded"]

BUDGET_ENV = "PTPU_ROLLBACK_BUDGET"


def default_budget() -> int:
    return int(os.environ.get(BUDGET_ENV, "2"))


class RollbackBudgetExceeded(RuntimeError):
    """The run kept diverging/failing past its rollback budget."""


class RollbackManager:
    """Bounded restore-and-resume over an ``ElasticTrainState``.

    ``reseed``: optional callable invoked with the restored start step —
    the hook for reshuffling/reseeding the data pipeline so the resumed
    run does not replay the exact batch sequence that diverged.
    """

    def __init__(self, elastic, budget: Optional[int] = None, report=None,
                 reseed: Optional[Callable[[int], None]] = None):
        self.elastic = elastic
        self.budget = default_budget() if budget is None else int(budget)
        self.report = report
        self.reseed = reseed
        self.used = 0

    def remaining(self) -> int:
        return max(0, self.budget - self.used)

    def rollback(self, init_fn: Callable[[], Any],
                 template_fn: Callable[[], Any],
                 reason: str = "divergence") -> Tuple[Any, int]:
        """(restored_state, start_step) from the newest committed good
        checkpoint — ``(init_fn(), 0)`` when none survive.  Raises
        :class:`RollbackBudgetExceeded` once the budget is spent."""
        self.used += 1
        if self.used > self.budget:
            if self.report is not None:
                self.report.record("rollback_budget_exhausted",
                                   reason=reason, budget=self.budget)
                self.report.flush()
            where = getattr(self.report, "path", None)
            raise RollbackBudgetExceeded(
                f"rollback budget of {self.budget} exhausted ({reason}); "
                "the run is failing persistently, not transiently"
                + (f" — post-mortem report: {where}" if where else ""))
        # an async save may still be committing the very step we need
        try:
            self.elastic.wait()
        except Exception as e:
            vlog(0, "rollback: pending async save failed (%s) — restoring "
                 "from the last committed step anyway", e)
        target = self.elastic.last_good_step()
        vlog(0, "rollback: %s — restoring last good step %s (%d/%d used)",
             reason, target, self.used, self.budget)
        state, start = self.elastic.restore_or(init_fn, template_fn)
        if self.report is not None:
            self.report.record("rollback", reason=reason,
                               restored_step=start - 1 if start else None,
                               start_step=start, used=self.used,
                               budget=self.budget)
        if self.reseed is not None:
            self.reseed(start)
        return state, start
