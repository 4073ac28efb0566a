"""Run supervisor: the port of ``paddle_tpu/supervisor/``, the run-level
half of the resilience story.  Cooperating pieces:

- :mod:`watchdog`: a deadline armed around every train step; a hang
  becomes a stack-dumped, reported ``StepTimeout``.
- :mod:`heartbeat`: per-worker beat files through the fsync'd ``fsio``
  seam + a monitor classifying the run healthy / degraded / lost-worker.
- :mod:`guard`: rolling loss / grad-norm statistics escalating
  skip -> lower-LR -> rollback (AMP-aware about loss-scale overflows).
- :mod:`rollback`: budget-bounded restore from the newest committed
  good checkpoint (``ElasticTrainState.restore_or``).
- :mod:`integrity`: cross-worker state fingerprints, the replay audit
  and the healing ladder.

Everything the supervisor sees and does is recorded in
:class:`~paddle_tpu_torch.supervisor.report.SupervisorReport`, the JSON
post-mortem a dead run leaves behind.  :class:`RunSupervisor` composes
them around ``hapi.Model.fit``:

>>> sup = RunSupervisor("runs/gpt", save_interval_steps=100)
>>> model.fit(data, epochs=1, supervisor=sup)

State machine: healthy -> degraded (stale peers / skipped batches) ->
rollback (escalated divergence or repeated step failure,
budget-bounded) -> failed (budget exhausted: ``RollbackBudgetExceeded`` +
report).

Env knobs: ``PTPU_WATCHDOG_SECS`` (step deadline, default 300),
``PTPU_HEARTBEAT_SECS`` (beat interval, default 10),
``PTPU_ROLLBACK_BUDGET`` (restores before failing loudly, default 2),
``PTPU_INTEGRITY_EVERY`` (a default :class:`IntegrityGuard` when > 0).
``begin_run`` also streams the run's records to
``<run_dir>/metrics/worker-<i>.jsonl``, installs a crash flight recorder
(``PTPU_FLIGHT_BUFFER``) dumped to ``<run_dir>/flight/`` on any abnormal
exit, and starts a status server when ``PTPU_MONITOR_PORT`` is set.

Not ported yet: the JAX package's ``ElasticCoordinator`` (a resize of the
data-parallel width on a lost worker), which waits for the port's
multi-GPU slice; ``coordinator=`` raises ``UnimplementedError``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, List, Optional, Tuple

from ..framework.errors import UnimplementedError
from ..framework.log import vlog
from .guard import DivergenceGuard, GuardAction
from .heartbeat import (HeartbeatMonitor, HeartbeatWriter, RunState,
                        heartbeat_dir)
from .integrity import IntegrityGuard, IntegrityVerdict, integrity_dir
from .report import SupervisorReport
from .rollback import RollbackBudgetExceeded, RollbackManager
from .watchdog import (StepTimeout, Watchdog, global_watchdog, guarded,
                       install_global)

__all__ = [
    "RunSupervisor", "SupervisorReport", "Watchdog", "StepTimeout",
    "HeartbeatWriter", "HeartbeatMonitor", "RunState", "DivergenceGuard",
    "GuardAction", "RollbackManager", "RollbackBudgetExceeded",
    "IntegrityGuard", "IntegrityVerdict", "integrity_dir",
    "install_global", "global_watchdog", "guarded", "heartbeat_dir",
]


class RunSupervisor:
    """One object wrapping a training run in the full health loop.

    ``elastic`` may be an existing ``ElasticTrainState``; otherwise one
    is created under ``<run_dir>/checkpoints``.  ``reseed`` (optional)
    is called with the restored start step after every rollback — the
    data-pipeline reseeding hook.
    """

    def __init__(self, run_dir: str, *, elastic=None,
                 save_interval_steps: int = 1000,
                 watchdog_secs: Optional[float] = None,
                 heartbeat_secs: Optional[float] = None,
                 rollback_budget: Optional[int] = None,
                 step_failure_budget: int = 1,
                 guard: Optional[DivergenceGuard] = None,
                 worker_id: Optional[int] = None,
                 expected_workers: Optional[int] = None,
                 reseed: Optional[Callable[[int], None]] = None,
                 report_path: Optional[str] = None,
                 sigterm_handler: bool = True, clock=time.time,
                 coordinator=None, integrity=None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.report = SupervisorReport(
            report_path if report_path is not None
            else os.path.join(run_dir, "supervisor_report.json"),
            clock=clock)
        if elastic is None:
            from ..distributed.elastic import ElasticTrainState
            elastic = ElasticTrainState(
                os.path.join(run_dir, "checkpoints"),
                save_interval_steps=save_interval_steps,
                install_sigterm_handler=sigterm_handler)
        self.elastic = elastic
        if hasattr(self.elastic, "set_event_sink"):
            self.elastic.set_event_sink(self.report.record)
        self.watchdog = Watchdog(timeout=watchdog_secs, report=self.report)
        self.heartbeat = HeartbeatWriter(
            run_dir, worker_id=worker_id, interval=heartbeat_secs,
            clock=clock)
        self.monitor = HeartbeatMonitor(
            run_dir, expected=expected_workers, clock=clock,
            report=self.report)
        self.guard = guard or DivergenceGuard(report=self.report)
        if self.guard.report is None:
            self.guard.report = self.report
        self.rollback = RollbackManager(
            self.elastic, budget=rollback_budget, report=self.report,
            reseed=reseed)
        # elastic resize: the JAX package's ElasticCoordinator re-forms
        # the mesh at the surviving width; the port has none yet
        if coordinator is not None:
            raise UnimplementedError(
                "RunSupervisor(coordinator=...): the elastic coordinator "
                "comes with the port's multi-GPU slice")
        self.coordinator = None
        # state-integrity guard: pass an IntegrityGuard, or
        # set PTPU_INTEGRITY_EVERY > 0 to get the default one; the guard
        # shares its TreeFingerprint with the elastic manager so the
        # checkpoint digest stamp and the cross-worker compare agree
        if integrity is None and int(
                os.environ.get("PTPU_INTEGRITY_EVERY", "0") or "0") > 0:
            integrity = IntegrityGuard(
                run_dir, worker_id=self.heartbeat.worker_id,
                expected=expected_workers, report=self.report,
                clock=clock)
        self.integrity = integrity
        if integrity is not None:
            if integrity.report is None:
                integrity.report = self.report
            if getattr(self.elastic, "fingerprint", None) is None:
                self.elastic.fingerprint = integrity.fingerprint
        self.pending_integrity: Optional[IntegrityVerdict] = None
        self.pending_resize: Optional[dict] = None
        self.step_failure_budget = int(step_failure_budget)
        self.pending_rollback: Optional[str] = None
        self.last_action: Optional[str] = None
        self.initial_state: Any = None
        self.gstep = 0
        self.consecutive_step_failures = 0
        self._clock = clock
        self._last_poll = 0.0
        self._prev_global: Optional[Watchdog] = None
        self._running = False
        self._loss_injectors: List[Callable[[int, float], float]] = []
        self._metrics_sink = None  # run-scoped JSONL writer
        self.status_server = None  # live monitor HTTP thread
        self.flight = None         # crash flight recorder

    # -- lifecycle ---------------------------------------------------------
    def begin_run(self, initial_state: Any = None) -> "RunSupervisor":
        if not self._running:
            self._running = True
            if initial_state is not None:
                self.initial_state = initial_state
            if self.watchdog._closed:  # supervisor reused across runs
                self.watchdog = Watchdog(timeout=self.watchdog.timeout,
                                         report=self.report)
            # run-scoped telemetry: everything emitted while this run is
            # live (step breakdowns and the supervisor's own events)
            # streams to <run_dir>/metrics/worker-<i>.jsonl
            from ..observability.registry import get_registry
            from ..observability.sinks import MetricsWriter
            from ..observability.sinks import metrics_dir as _metrics_dir
            try:
                self._metrics_sink = get_registry().add_sink(
                    MetricsWriter(_metrics_dir(self.run_dir),
                                  worker_id=self.heartbeat.worker_id))
            except OSError as e:
                vlog(0, "supervisor: metrics sink under %s unavailable: "
                     "%s", self.run_dir, e)
            # crash flight recorder: a bounded ring of the
            # newest records, dumped on signals/atexit/this supervisor's
            # fault path so a hard death keeps its last N events
            try:
                from ..observability.flight import FlightRecorder
                self.flight = get_registry().add_sink(FlightRecorder(
                    self.run_dir, worker_id=self.heartbeat.worker_id))
                self.flight.install()
            except Exception as e:
                vlog(0, "supervisor: flight recorder unavailable: %r", e)
                self.flight = None
            # per-worker status server, when PTPU_MONITOR_PORT
            # is set (base port + worker rank; 0 = ephemeral)
            from ..observability.monitor import maybe_start_server
            self.status_server = maybe_start_server(
                supervisor=self, worker_id=self.heartbeat.worker_id)
            self.report.record("run_start", run_dir=self.run_dir,
                               worker=self.heartbeat.worker_id,
                               watchdog_secs=self.watchdog.timeout,
                               heartbeat_secs=self.heartbeat.interval,
                               rollback_budget=self.rollback.budget)
            self.heartbeat.start()
            self._prev_global = install_global(self.watchdog)
        return self

    def end_run(self, status: str = "completed") -> None:
        if not self._running:
            return
        self._running = False
        self.heartbeat.stop()
        install_global(self._prev_global)
        self.watchdog.close()
        # final per-worker instrument snapshot onto this worker's JSONL
        # stream, for cross-worker attribution after the run
        try:
            from ..observability.registry import get_registry
            reg = get_registry()
            reg.emit("metrics.snapshot", step=self.gstep,
                     worker=self.heartbeat.worker_id,
                     snapshot=reg.snapshot())
        except Exception as e:
            vlog(1, "supervisor: final metrics snapshot failed: %r", e)
        self.report.record("run_end", status=status, step=self.gstep,
                           rollbacks=self.rollback.used,
                           timeouts=self.watchdog.timeouts,
                           bad_batches=self.guard.total_bad)
        if self.flight is not None:
            # the supervisor's own fault path: an abnormal end dumps the
            # black box NOW (the signal/atexit hooks cover deaths that
            # never reach end_run); a clean completion leaves no bundle
            if status != "completed":
                self.flight.dump(reason=f"end_run:{status}")
            self.flight.uninstall()
            from ..observability.registry import get_registry
            get_registry().remove_sink(self.flight)
            self.flight = None
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
        if self._metrics_sink is not None:
            from ..observability.registry import get_registry
            get_registry().remove_sink(self._metrics_sink)  # flush+close
            self._metrics_sink = None

    def attach(self, model) -> "RunSupervisor":
        """Bind to a ``hapi.Model`` so ``train_batch`` consults the guard
        and arms the watchdog even outside ``fit``."""
        model._supervisor = self
        return self

    def __enter__(self) -> "RunSupervisor":
        return self.begin_run()

    def __exit__(self, exc_type, *exc) -> None:
        self.end_run("failed" if exc_type else "completed")

    # -- per-step protocol -------------------------------------------------
    def inject_loss(self, fn: Callable[[int, float], float]) -> None:
        """Test seam: ``fn(step, loss) -> loss`` runs on every host-side
        loss before the guard sees it (``testing.faults.diverge_after``
        and ``hang`` plug in here)."""
        self._loss_injectors.append(fn)

    def filter_loss(self, loss: float) -> float:
        for fn in self._loss_injectors:
            loss = fn(self.gstep, loss)
        return loss

    def guard_step(self, loss: float, grad_norm: Optional[float] = None,
                   amp_active: bool = False) -> str:
        """Guard verdict for this step's statistics; a ROLLBACK verdict is
        latched in ``pending_rollback`` for the driving loop to execute."""
        action = self.guard.observe(self.gstep, loss, grad_norm,
                                    amp_active=amp_active)
        self.last_action = action
        if action == GuardAction.ROLLBACK:
            self.pending_rollback = "divergence"
        return action

    def note_step_ok(self, state: Any = None) -> None:
        self.consecutive_step_failures = 0
        self.gstep += 1
        self.heartbeat.maybe_beat(self.gstep)
        self.maybe_poll()
        if state is not None:
            self.elastic.maybe_save(self.gstep, state)
            if self.integrity is not None:
                verdict = self.integrity.maybe_check(self.gstep, state)
                if (verdict is not None and not verdict.ok
                        and self.pending_integrity is None):
                    self.pending_integrity = verdict

    def note_step_failure(self, reason: str = "step-timeout") -> str:
        """SKIP while repeated failures stay inside the budget; beyond it
        the failing step is a symptom, not an accident → ROLLBACK."""
        self.consecutive_step_failures += 1
        self.report.record("step_failure", step=self.gstep, reason=reason,
                           consecutive=self.consecutive_step_failures)
        if self.consecutive_step_failures > self.step_failure_budget:
            self.pending_rollback = reason
            return GuardAction.ROLLBACK
        return GuardAction.SKIP

    def maybe_poll(self) -> None:
        """Heartbeat-health poll, throttled to half the stale window."""
        now = float(self._clock())
        if now - self._last_poll >= self.monitor.stale_after / 2.0:
            self._last_poll = now
            self.monitor.poll()

    # -- elastic resize ----------------------------------------------------
    def request_resize(self, new_dp: int, reason: str = "scale-signal"
                       ) -> None:
        """A resize to ``new_dp`` data-parallel workers needs the JAX
        package's ElasticCoordinator, which the port does not have."""
        raise UnimplementedError(
            "request_resize needs an elastic coordinator, which comes with "
            "the port's multi-GPU slice")

    def perform_resize(self, init_fn: Callable[[], Any],
                       template_fn: Callable[[], Any]) -> Tuple[Any, int]:
        raise UnimplementedError(
            "perform_resize needs an elastic coordinator, which comes with "
            "the port's multi-GPU slice")

    # -- state-integrity healing -------------------------------------------
    def recheck_integrity(self, step: Optional[int] = None
                          ) -> Optional["IntegrityVerdict"]:
        """Fleet-barrier form of the integrity compare: re-vote after
        every member's boards landed (a worker whose ``note_step_ok``
        ran before its peers' saw an incomplete board set), latching a
        mismatch exactly like ``note_step_ok`` does."""
        if self.integrity is None or not self.integrity.enabled:
            return None
        verdict = self.integrity.recheck(step)
        if (verdict is not None and not verdict.ok
                and self.pending_integrity is None):
            self.pending_integrity = verdict
        return verdict

    def perform_integrity_heal(self, init_fn: Callable[[], Any],
                               template_fn: Callable[[], Any],
                               state: Any) -> Tuple[Any, int]:
        """Execute the latched integrity heal: majority members publish
        the resync offer and continue; suspects climb the
        resync → rollback → evict ladder.  Returns ``(state, start)`` —
        unchanged for the majority side."""
        verdict = self.pending_integrity
        self.pending_integrity = None
        if verdict is None or self.integrity is None:
            return state, self.gstep
        st, start, action = self.integrity.heal(
            self, verdict, init_fn, template_fn, state)
        if action in ("rollback", "evict", "resync"):
            self.consecutive_step_failures = 0
        if start != self.gstep:
            vlog(0, "supervisor: integrity heal (%s) rewound step "
                 "counter %d → %d", action, self.gstep, start)
            self.gstep = start
        return st, start

    def perform_rollback(self, init_fn: Callable[[], Any],
                         template_fn: Callable[[], Any],
                         reason: Optional[str] = None) -> Tuple[Any, int]:
        reason = reason or self.pending_rollback or "requested"
        state, start = self.rollback.rollback(init_fn, template_fn,
                                              reason=reason)
        self.pending_rollback = None
        self.consecutive_step_failures = 0
        self.guard.reset_after_rollback()
        vlog(0, "supervisor: rewound step counter %d → %d", self.gstep,
             start)
        self.gstep = start
        return state, start
