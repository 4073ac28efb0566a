"""SLO-driven fleet autoscaler: the port's own copy of
``paddle_tpu/inference/fleet/autoscaler.py``.

:class:`FleetAutoscaler` observes each replica's serving stats against a
declared :class:`ServingSLO`, and when the SLO *burns* for enough of a
sliding window, actuates the :class:`..replica.ReplicaManager`:

    scale up   = manager.spawn()                    (new slot, or a
                 retired slot respawned — replica ids stay stable)
    scale down = router.drain_replica(victim)       (quiesce: migrate
                 live streams to the survivors)
                 manager.retire(victim)             (fence: the slot is
                 marked retired in place, never renumbered)

Control loop, one :meth:`step` per tick:

1. **Sample** — every active replica's ``serving_stats()``: queue
   depth + waiting + running (pressure) and the engine-local
   ``slo.ttft_ms.p99`` / ``slo.tpot_ms.p99`` tails.  A sample is
   *burning* when any declared SLO is violated, *idle* when the fleet
   holds no work at all.
2. **Window** — samples older than ``window_secs`` age out.  Burn
   fraction ≥ ``burn_threshold`` over a *full* window ⇒ scale-up
   pressure; an entirely idle full window ⇒ scale-down pressure.
   Burn-rate-over-window (not instantaneous breach) is what keeps one
   slow request from flapping the fleet size — the autoscaler's own
   hysteresis, mirroring the circuit breaker's.
3. **Actuate** — bounded by ``PTPU_FLEET_MIN`` / ``PTPU_FLEET_MAX``
   and rate-limited by ``PTPU_FLEET_SCALE_COOLDOWN_SECS`` between
   actions.  Every decision — including ``blocked_at_max``, the one
   operators page on — is a ``fleet.autoscale`` timeline record.

Injectable ``clock`` so drills drive the window on fake time.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ...framework.errors import enforce
from ...framework.log import vlog

__all__ = ["MIN_ENV", "MAX_ENV", "SCALE_WINDOW_SECS_ENV",
           "SCALE_COOLDOWN_SECS_ENV", "SLO_SOURCE_ENV",
           "default_fleet_min", "default_fleet_max",
           "default_scale_window_secs", "default_scale_cooldown_secs",
           "default_slo_source", "ServingSLO", "FleetAutoscaler"]

MIN_ENV = "PTPU_FLEET_MIN"
MAX_ENV = "PTPU_FLEET_MAX"
SCALE_WINDOW_SECS_ENV = "PTPU_FLEET_SCALE_WINDOW_SECS"
SCALE_COOLDOWN_SECS_ENV = "PTPU_FLEET_SCALE_COOLDOWN_SECS"
SLO_SOURCE_ENV = "PTPU_FLEET_SLO_SOURCE"


def default_fleet_min() -> int:
    return int(os.environ.get(MIN_ENV, "1"))


def default_fleet_max() -> int:
    return int(os.environ.get(MAX_ENV, "4"))


def default_scale_window_secs() -> float:
    return float(os.environ.get(SCALE_WINDOW_SECS_ENV, "10"))


def default_scale_cooldown_secs() -> float:
    return float(os.environ.get(SCALE_COOLDOWN_SECS_ENV, "30"))


def default_slo_source() -> str:
    """Whose latency tails the autoscaler burns on: ``engine`` =
    per-replica engine-local p99s, ``router`` = the router's
    client-observed ``fleet.ttft_ms``/``fleet.tpot_ms`` tails, which
    include queueing, retries and failover recompute."""
    src = os.environ.get(SLO_SOURCE_ENV, "engine").strip().lower()
    enforce(src in ("engine", "router"),
            f"{SLO_SOURCE_ENV}={src!r}: expected 'engine' or 'router'")
    return src


class ServingSLO:
    """Declared serving objectives; ``None`` disables a dimension.

    ``queue_depth`` is per-replica queued+waiting+running pressure;
    the latency targets are checked against each replica's
    engine-local p99 tails (``stats()["slo"]``)."""

    def __init__(self, queue_depth: Optional[float] = 16.0,
                 ttft_p99_ms: Optional[float] = None,
                 tpot_p99_ms: Optional[float] = None):
        self.queue_depth = queue_depth
        self.ttft_p99_ms = ttft_p99_ms
        self.tpot_p99_ms = tpot_p99_ms

    def violations(self, stats: Dict[str, Any]) -> List[str]:
        """SLO dimensions this one replica's stats snapshot violates."""
        out: List[str] = []
        pressure = (float(stats.get("queue_depth", 0))
                    + float(stats.get("waiting", 0))
                    + float(stats.get("running", 0)))
        if self.queue_depth is not None and pressure > self.queue_depth:
            out.append(f"queue_depth {pressure:.0f} > "
                       f"{self.queue_depth:.0f}")
        slo = stats.get("slo") or {}
        ttft = (slo.get("ttft_ms") or {}).get("p99")
        if (self.ttft_p99_ms is not None and ttft is not None
                and ttft > self.ttft_p99_ms):
            out.append(f"ttft_p99 {ttft:.1f}ms > {self.ttft_p99_ms}ms")
        tpot = (slo.get("tpot_ms") or {}).get("p99")
        if (self.tpot_p99_ms is not None and tpot is not None
                and tpot > self.tpot_p99_ms):
            out.append(f"tpot_p99 {tpot:.1f}ms > {self.tpot_p99_ms}ms")
        return out

    def describe(self) -> Dict[str, Any]:
        return {"queue_depth": self.queue_depth,
                "ttft_p99_ms": self.ttft_p99_ms,
                "tpot_p99_ms": self.tpot_p99_ms}


_ACTIVE_STATES = ("starting", "healthy", "flapping")


class FleetAutoscaler:
    """Burn-rate control loop over a replica manager (+ router).

    ``manager`` must speak the actuator protocol (``spawn`` /
    ``retire`` / ``poll_states`` / ``replicas``) — both
    :class:`..replica.ReplicaManager` and
    :class:`..replica.LocalReplicaManager` do.  ``router`` (optional)
    lets scale-down quiesce first via ``drain_replica``; without one,
    the victim replica is retired cold (its engine's own drain/spill
    discipline still applies)."""

    def __init__(self, manager, *, router=None,
                 slo: Optional[ServingSLO] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 window_secs: Optional[float] = None,
                 burn_threshold: float = 0.5,
                 cooldown_secs: Optional[float] = None,
                 slo_source: Optional[str] = None,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.manager = manager
        self.router = router
        self.slo = slo if slo is not None else ServingSLO()
        self.slo_source = (slo_source if slo_source is not None
                           else default_slo_source())
        enforce(self.slo_source in ("engine", "router"),
                f"bad slo_source {self.slo_source!r}")
        enforce(self.slo_source != "router" or router is not None,
                "slo_source='router' needs a router")
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else default_fleet_min())
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else default_fleet_max())
        enforce(1 <= self.min_replicas <= self.max_replicas,
                f"bad autoscaler bounds [{self.min_replicas}, "
                f"{self.max_replicas}]")
        self.window_secs = float(window_secs if window_secs is not None
                                 else default_scale_window_secs())
        self.burn_threshold = float(burn_threshold)
        self.cooldown_secs = float(
            cooldown_secs if cooldown_secs is not None
            else default_scale_cooldown_secs())
        self._registry = registry
        self.clock = clock
        # (ts, burning, idle) samples — guarded_by: single control
        # thread (the loop owner); never shared
        self._window: Deque[Tuple[float, bool, bool]] = deque()
        self._last_action_at: Optional[float] = None
        self.actions = {"up": 0, "down": 0, "blocked_at_max": 0}

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ...observability.registry import get_registry
        return get_registry()

    # -- observe -----------------------------------------------------------
    def active_ids(self) -> List[int]:
        states = self.manager.poll_states()
        return [i for i, s in states.items() if s in _ACTIVE_STATES]

    def sample(self) -> Dict[str, Any]:
        """One observation: per-replica SLO verdicts folded into a
        (burning, idle) window sample."""
        now = float(self.clock())
        violations: Dict[Any, List[str]] = {}
        pressure = 0.0
        for idx in self.active_ids():
            replica = self.manager.replicas[idx]
            try:
                stats = replica.serving_stats()
            except ConnectionError:
                continue              # census handles dead/flapping
            if self.slo_source == "engine":
                v = self.slo.violations(stats)
                if v:
                    violations[idx] = v
            pressure += (float(stats.get("queue_depth", 0))
                         + float(stats.get("waiting", 0))
                         + float(stats.get("running", 0)))
        if self.slo_source == "router":
            # burn on the client-observed tails: the router's numbers
            # include queueing, retries and failover recompute — the
            # components engine-local p99s cannot see
            v = self.slo.violations(self.router.slo_stats())
            if v:
                violations["router"] = v
        burning = bool(violations)
        idle = pressure == 0.0
        self._window.append((now, burning, idle))
        while self._window and now - self._window[0][0] > self.window_secs:
            self._window.popleft()
        return {"burning": burning, "idle": idle, "pressure": pressure,
                "violations": violations}

    def _window_full(self, now: float) -> bool:
        return bool(self._window
                    and now - self._window[0][0] >= self.window_secs * 0.9)

    def burn_fraction(self) -> float:
        if not self._window:
            return 0.0
        return sum(1 for _, b, _i in self._window if b) / len(self._window)

    def idle_fraction(self) -> float:
        if not self._window:
            return 0.0
        return sum(1 for _, _b, i in self._window if i) / len(self._window)

    # -- actuate -----------------------------------------------------------
    def _emit(self, action: str, active: int, target: int,
              why: str) -> None:
        reg = self._reg()
        self.actions[action] = self.actions.get(action, 0) + 1
        reg.counter("fleet.autoscale").inc()
        reg.emit("fleet.autoscale", action=action, replicas=active,
                 target=target, burn=round(self.burn_fraction(), 3),
                 idle=round(self.idle_fraction(), 3), why=why,
                 slo=self.slo.describe())
        vlog(0, "fleet: autoscale %s %d -> %d (%s)", action, active,
             target, why)

    def _in_cooldown(self, now: float) -> bool:
        return (self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_secs)

    def _pick_victim(self, active: List[int]) -> int:
        """Scale-down victim: the least-loaded active replica (ties →
        highest id, so retired-slot reuse stays compact)."""
        def load(idx: int) -> float:
            try:
                s = self.manager.replicas[idx].serving_stats()
            except ConnectionError:
                return -1.0           # unreachable — cheapest to lose
            return (float(s.get("queue_depth", 0))
                    + float(s.get("waiting", 0))
                    + float(s.get("running", 0)))
        return sorted(active, key=lambda i: (load(i), -i))[0]

    def step(self) -> Optional[str]:
        """Sample + decide + (maybe) actuate.  Returns the action taken
        ("up" / "down" / "blocked_at_max") or None."""
        obs = self.sample()
        now = float(self.clock())
        active = self.active_ids()
        n = len(active)
        if not self._window_full(now) or self._in_cooldown(now):
            return None
        burn = self.burn_fraction()
        if burn >= self.burn_threshold:
            why = "; ".join(
                (f"{i}: {', '.join(v)}" if isinstance(i, str)
                 else f"replica {i}: {', '.join(v)}")
                for i, v in sorted(obs["violations"].items(),
                                   key=str)
                ) or f"burn {burn:.2f} over window"
            if n >= self.max_replicas:
                self._last_action_at = now
                self._emit("blocked_at_max", n, n, why)
                return "blocked_at_max"
            self.manager.spawn()
            self._last_action_at = now
            self._emit("up", n, n + 1, why)
            return "up"
        if self.idle_fraction() >= 1.0 and n > self.min_replicas:
            victim = self._pick_victim(active)
            if self.router is not None:
                self.router.drain_replica(victim)
            self.manager.retire(victim)
            self._last_action_at = now
            self._emit("down", n, n - 1,
                       f"idle through window; retired replica {victim}")
            return "down"
        return None

    def run(self, duration_secs: float,
            interval_secs: float = 1.0, sleep=time.sleep) -> None:
        """Drive the loop for a bounded wall-clock span (drills; a
        real deployment owns its own ticker)."""
        deadline = float(self.clock()) + float(duration_secs)
        while float(self.clock()) < deadline:
            self.step()
            sleep(interval_secs)

    def stats(self) -> Dict[str, Any]:
        return {"bounds": [self.min_replicas, self.max_replicas],
                "window_secs": self.window_secs,
                "burn_threshold": self.burn_threshold,
                "cooldown_secs": self.cooldown_secs,
                "burn": round(self.burn_fraction(), 3),
                "idle": round(self.idle_fraction(), 3),
                "samples": len(self._window),
                "actions": dict(self.actions),
                "slo": self.slo.describe(),
                "slo_source": self.slo_source}
