"""Fault-tolerant multi-replica serving fleet: the port of
``paddle_tpu/inference/fleet/``.

The layer above the single-host ServingEngine: a :class:`ReplicaManager`
spawns/monitors N engine worker subprocesses (:mod:`.worker`, localhost
HTTP, states starting/healthy/flapping/draining/dead/retired), and a
:class:`Router` dispatches client streams queue-aware least-loaded with
session affinity, fleet-level admission control, bounded
retry-with-backoff, and **token-exact failover**: the router journals
every stream's prompt + accepted tokens, so a SIGKILLed replica's
survivors re-enter a healthy engine through the recompute-prefill path
and finish with exactly the tokens an uninterrupted run would have
produced.  ``rolling_upgrade()`` drains one replica at a time with zero
client-visible drops.

- :mod:`.journal` — the router's crash-safe write-ahead log;
  ``Router(recover=run_dir)`` rebuilds every in-flight stream from
  ``<run_dir>/fleet/journal/`` alone, token-exact after a router
  SIGKILL with zero replica restarts.
- :mod:`.health` — per-replica :class:`CircuitBreaker` (the
  ``flapping`` census state) and the process-wide :class:`RetryBudget`
  that degrades retry storms to load-shed.
- :mod:`.autoscaler` — :class:`FleetAutoscaler`, an SLO burn-rate loop
  driving ``ReplicaManager.spawn`` / ``retire`` between
  ``PTPU_FLEET_MIN`` and ``PTPU_FLEET_MAX``.
- :mod:`.drills` — the SIGKILL, rolling-upgrade, router-crash and
  autoscale drills (``python -m paddle_tpu_torch.inference.fleet.drills
  --sigkill_drill``).

Module and class names, the ``PTPU_FLEET_*`` knobs and their defaults,
the ``fleet.*`` instrument names, the journal's line format and the
worker's handshake line and routes are the JAX package's, so both
packages read the same operator configuration and either package's
router recovers the other's journal directory.
"""
from .autoscaler import (MAX_ENV, MIN_ENV, SCALE_COOLDOWN_SECS_ENV,
                         SCALE_WINDOW_SECS_ENV, FleetAutoscaler,
                         ServingSLO, default_fleet_max,
                         default_fleet_min, default_scale_cooldown_secs,
                         default_scale_window_secs)
from .health import (BREAKER_BACKOFF_SECS_ENV, BREAKER_FAILURES_ENV,
                     BREAKER_WINDOW_SECS_ENV, RETRY_BUDGET_ENV,
                     RETRY_REFILL_ENV, CircuitBreaker, RetryBudget,
                     default_breaker_backoff_secs,
                     default_breaker_failures,
                     default_breaker_window_secs, default_retry_budget,
                     default_retry_refill_per_s, get_retry_budget,
                     reset_retry_budget)
from .journal import JOURNAL_KEEP_ENV, JournalStore, default_journal_keep
from .replica import (DRAIN_SLACK_SECS_ENV, HEARTBEAT_SECS_ENV,
                      PORT_BASE_ENV, REPLICAS_ENV, HttpReplica,
                      LocalReplica, LocalReplicaManager, ReplicaManager,
                      default_drain_slack_secs, default_heartbeat_secs,
                      default_port_base, default_replicas)
from .router import (RETRY_BACKOFF_MS_ENV, RETRY_MAX_ENV,
                     SHED_QUEUE_DEPTH_ENV, DispatchExhausted,
                     FleetOverloaded, Router, StreamJournal,
                     default_retry_backoff_ms, default_retry_max,
                     default_shed_queue_depth)

__all__ = [
    "LocalReplica", "HttpReplica", "ReplicaManager",
    "LocalReplicaManager", "Router", "StreamJournal", "FleetOverloaded",
    "DispatchExhausted", "JournalStore", "CircuitBreaker", "RetryBudget",
    "get_retry_budget", "reset_retry_budget", "FleetAutoscaler",
    "ServingSLO",
    "REPLICAS_ENV", "PORT_BASE_ENV", "HEARTBEAT_SECS_ENV",
    "DRAIN_SLACK_SECS_ENV", "RETRY_MAX_ENV", "RETRY_BACKOFF_MS_ENV",
    "SHED_QUEUE_DEPTH_ENV", "JOURNAL_KEEP_ENV", "BREAKER_FAILURES_ENV",
    "BREAKER_WINDOW_SECS_ENV", "BREAKER_BACKOFF_SECS_ENV",
    "RETRY_BUDGET_ENV", "RETRY_REFILL_ENV", "MIN_ENV", "MAX_ENV",
    "SCALE_WINDOW_SECS_ENV", "SCALE_COOLDOWN_SECS_ENV",
    "default_replicas", "default_port_base", "default_heartbeat_secs",
    "default_drain_slack_secs", "default_retry_max",
    "default_retry_backoff_ms", "default_shed_queue_depth",
    "default_journal_keep", "default_breaker_failures",
    "default_breaker_window_secs", "default_breaker_backoff_secs",
    "default_retry_budget", "default_retry_refill_per_s",
    "default_fleet_min", "default_fleet_max",
    "default_scale_window_secs", "default_scale_cooldown_secs",
]
