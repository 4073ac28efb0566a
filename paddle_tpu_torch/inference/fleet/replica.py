"""Replica clients and the ReplicaManager: the port's own copy of
``paddle_tpu/inference/fleet/replica.py``.

A *replica* is one ServingEngine the fleet router can dispatch to.  Two
client shapes speak the same duck-typed protocol:

- :class:`LocalReplica` — wraps an in-process engine; ``pump()`` steps
  it.  This is the deterministic form the router tests and the
  in-process drills use.
- :class:`HttpReplica` — speaks localhost HTTP to a
  :mod:`.worker` subprocess (``/submit`` ``/poll`` ``/drain``
  ``/healthz`` ``/statusz``); ``pump()`` is a no-op because the worker
  steps itself.

The protocol (all a router needs):

    submit(record)          admit one spill-format request record
    poll(rid, start)        {"tokens": output[start:], "finished", "reason"}
    serving_stats()         the /statusz serving section (load score)
    healthz()               (http_code, state_string)
    alive()                 False once the process/engine is gone
    pump()                  advance work (in-process engines only)
    drain(timeout)          {"finished", "spilled_records": [...]}

:class:`ReplicaManager` spawns/monitors N worker subprocesses: states
``starting`` (spawned, /healthz not yet 200) → ``healthy`` (200 +
fresh heartbeat) → ``draining`` (503 draining) → ``dead`` (process
exited or heartbeat older than ``PTPU_FLEET_HEARTBEAT_SECS``), mirrors
the census into ``fleet.replicas[state=...]`` gauges, and can
``restart()`` a slot — the rolling-upgrade primitive.  Two overlay
states: ``flapping`` (alive but its router-side circuit breaker is open
— see :mod:`.health`) and ``retired`` (scaled down by the
:mod:`.autoscaler`; the slot stays in the list so replica ids stay
stable), plus :meth:`spawn` / :meth:`retire` — the autoscaler's
actuators.  :class:`LocalReplicaManager` is the in-process mirror of
that protocol for deterministic drills.

A worker runs ``python -m paddle_tpu_torch.inference.fleet.worker`` on
the device its model spec names (``"device"``; none means ``cuda``, and
a worker without a card dies before its handshake, which :meth:`_spawn`
raises with the exit code).  Several workers may share one card: each
holds its own CUDA context, weights and KV pool.

Env knobs: ``PTPU_FLEET_REPLICAS``, ``PTPU_FLEET_PORT_BASE``,
``PTPU_FLEET_HEARTBEAT_SECS``, ``PTPU_FLEET_DRAIN_SLACK_SECS``.
"""
from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from ...framework.errors import enforce
from ...framework.log import vlog

__all__ = ["REPLICAS_ENV", "PORT_BASE_ENV", "HEARTBEAT_SECS_ENV",
           "DRAIN_SLACK_SECS_ENV", "default_replicas",
           "default_port_base", "default_heartbeat_secs",
           "default_drain_slack_secs", "LocalReplica", "HttpReplica",
           "ReplicaManager", "LocalReplicaManager"]

REPLICAS_ENV = "PTPU_FLEET_REPLICAS"
PORT_BASE_ENV = "PTPU_FLEET_PORT_BASE"
HEARTBEAT_SECS_ENV = "PTPU_FLEET_HEARTBEAT_SECS"
DRAIN_SLACK_SECS_ENV = "PTPU_FLEET_DRAIN_SLACK_SECS"

# the directory holding the paddle_tpu_torch package
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _child_env() -> Dict[str, str]:
    """This process's environment with the checkout first on
    ``PYTHONPATH``: a child imports the package by name, and a parent that
    reached it through ``sys.path`` (a script beside the checkout) must
    pass it on."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_REPO_ROOT if not path
                         else os.pathsep.join((_REPO_ROOT, path)))
    return env


def default_replicas() -> int:
    return int(os.environ.get(REPLICAS_ENV, "2"))


def default_port_base() -> int:
    """0 = every worker binds an ephemeral port and reports it on the
    spawn handshake line — the CI-safe default (no port collisions)."""
    return int(os.environ.get(PORT_BASE_ENV, "0"))


def default_heartbeat_secs() -> float:
    return float(os.environ.get(HEARTBEAT_SECS_ENV, "10"))


def default_drain_slack_secs() -> float:
    """HTTP-read margin over the engine-side drain budget (the worker
    finishes/spills *inside* the /drain call)."""
    return float(os.environ.get(DRAIN_SLACK_SECS_ENV, "30"))


class LocalReplica:
    """In-process replica: a ServingEngine behind the replica protocol.

    The router tests and the in-process drills run whole fleets of
    these in one process — same dispatch/journal/failover code paths as
    the subprocess form, no IPC nondeterminism."""

    def __init__(self, engine, replica_id: int = 0):
        self.engine = engine
        self.replica_id = int(replica_id)
        if engine.replica_id is None:
            engine.replica_id = self.replica_id

    def _check_up(self) -> None:
        # a dead in-process engine fails like a dead worker: the
        # transport error is the router's failover signal
        if self.engine.state == "stopped":
            raise ConnectionError(
                f"replica {self.replica_id}: engine stopped")

    def submit(self, record: Dict[str, Any]) -> None:
        self._check_up()
        self.engine.admit_record(record)

    def poll(self, request_id: str, start: int = 0) -> Dict[str, Any]:
        self._check_up()
        eng = self.engine
        seq = eng.sched.finished.get(request_id)
        if seq is None:
            for s in list(eng.sched.running) + list(eng.sched.waiting):
                if s.request_id == request_id:
                    seq = s
                    break
        enforce(seq is not None,
                f"replica {self.replica_id}: unknown request "
                f"{request_id!r}")
        finished = seq.finish_reason is not None
        return {"tokens": list(seq.output[start:]),
                "finished": finished,
                "reason": seq.finish_reason}

    def pump(self) -> bool:
        """One engine step when work is queued; True when it stepped."""
        if self.engine.state == "serving" and self.engine.has_work():
            self.engine.step()
            return True
        return False

    def serving_stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def healthz(self):
        if self.engine.state != "serving":
            return 503, self.engine.state
        if self.engine.should_shed():
            return 503, \
                f"load-shed:queue_depth={self.engine.sched.queue_depth}"
        return 200, "serving"

    def alive(self) -> bool:
        return self.engine.state != "stopped"

    def drain(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        report = self.engine.drain(timeout=timeout)
        return {"finished": report["finished"],
                "spilled_records": report["spilled_records"]}

    def stop(self) -> None:
        self.engine.stop()


class HttpReplica:
    """Localhost-HTTP client for one :mod:`.worker` subprocess.

    Transport errors surface as ``ConnectionError`` from every call —
    the router's retry/failover signal.  ``process`` (when the manager
    spawned the worker) lets ``alive()`` notice a SIGKILLed worker
    immediately instead of waiting out a connect timeout."""

    def __init__(self, replica_id: int, port: int,
                 host: str = "127.0.0.1", timeout: float = 5.0,
                 process: Optional[subprocess.Popen] = None):
        self.replica_id = int(replica_id)
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.process = process

    def _url(self, path: str) -> str:
        return f"http://{self.host}:{self.port}{path}"

    def _call(self, path: str, payload: Optional[Dict] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self._url(path), data=data,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            raise ConnectionError(
                f"replica {self.replica_id} {path}: HTTP {e.code} "
                f"{body[:200]}") from e
        except (urllib.error.URLError, OSError, TimeoutError,
                http.client.HTTPException) as e:
            # HTTPException: a replica killed mid-response leaves a
            # short body (IncompleteRead), a transport failure like any
            raise ConnectionError(
                f"replica {self.replica_id} {path}: {e}") from e

    def submit(self, record: Dict[str, Any]) -> None:
        self._call("/submit", {"record": record})

    def poll(self, request_id: str, start: int = 0) -> Dict[str, Any]:
        return self._call(f"/poll?rid={request_id}&start={int(start)}")

    def pump(self) -> bool:
        return False                  # the worker steps itself

    def serving_stats(self) -> Dict[str, Any]:
        return self._call("/statusz").get("serving") or {}

    def healthz(self):
        try:
            out = self._call("/healthz")
            return 200, out.get("state", "serving")
        except ConnectionError as e:
            cause = e.__cause__
            if isinstance(cause, urllib.error.HTTPError):
                # the body follows "HTTP <code> " in _call's message
                body = str(e).split(f"HTTP {cause.code} ", 1)[-1]
                try:
                    return cause.code, json.loads(body).get("state",
                                                            "unknown")
                except ValueError:    # health probe must answer
                    return cause.code, "unhealthy"
            raise

    def alive(self) -> bool:
        if self.process is not None and self.process.poll() is not None:
            return False
        try:
            self.healthz()
            return True
        except ConnectionError:
            return False

    def drain(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        http_timeout = (self.timeout if timeout is None
                        else float(timeout) + default_drain_slack_secs())
        return self._call("/drain", {"timeout": timeout},
                          timeout=http_timeout)

    def stop(self) -> None:
        try:
            self._call("/shutdown", {})
        except ConnectionError:
            pass                      # already gone — that is the goal


class ReplicaManager:
    """Spawn + monitor N engine worker subprocesses.

    ``model_spec`` is the JSON-able dict :mod:`.worker` rebuilds the
    decoder from (config kwargs + seed) — every replica seeds
    identically, so greedy decode is token-exact across the fleet and
    failover is provable against a single-engine reference.

    State machine per slot (mirrored into ``fleet.replicas[state=...]``
    gauges by :meth:`poll_states`):

        starting --/healthz 200--> healthy --503 draining--> draining
            |                        |                          |
            +---- process exit / stale heartbeat ----> dead <---+
    """

    def __init__(self, model_spec: Dict[str, Any], *,
                 replicas: Optional[int] = None,
                 port_base: Optional[int] = None,
                 run_dir: Optional[str] = None,
                 registry=None,
                 heartbeat_secs: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 spawn_timeout: float = 120.0):
        self.model_spec = dict(model_spec)
        self.num_replicas = int(replicas if replicas is not None
                                else default_replicas())
        enforce(self.num_replicas >= 1, "fleet needs >= 1 replica")
        self.port_base = int(port_base if port_base is not None
                             else default_port_base())
        self.run_dir = run_dir
        self._registry = registry
        self.heartbeat_secs = float(
            heartbeat_secs if heartbeat_secs is not None
            else default_heartbeat_secs())
        self.env = dict(env or {})
        self.spawn_timeout = float(spawn_timeout)
        self.replicas: List[HttpReplica] = []
        self.states: Dict[int, str] = {}
        self._last_beat: Dict[int, float] = {}
        self.restarts = 0
        self._flapping: set = set()    # router-marked (breaker open)
        self._retired: set = set()     # autoscaler-marked (slot stable)

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ...observability.registry import get_registry
        return get_registry()

    # -- spawning ----------------------------------------------------------
    def _spawn(self, idx: int) -> HttpReplica:
        port = self.port_base + idx if self.port_base > 0 else 0
        cmd = [sys.executable, "-m",
               "paddle_tpu_torch.inference.fleet.worker",
               "--replica-id", str(idx), "--port", str(port),
               "--model", json.dumps(self.model_spec)]
        if self.run_dir:
            cmd += ["--run-dir", self.run_dir]
        env = _child_env()
        env.update(self.env)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True,
                                env=env)
        # handshake: the worker prints ONE line once its server is bound
        # (ephemeral ports make this the only way to learn the port)
        deadline = time.monotonic() + self.spawn_timeout
        line = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("ptpu-fleet-worker"):
                break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker {idx} died before handshake "
                    f"(rc={proc.returncode})")
        enforce(line.startswith("ptpu-fleet-worker"),
                f"fleet worker {idx}: no handshake within "
                f"{self.spawn_timeout}s")
        fields = dict(kv.split("=", 1) for kv in line.split()
                      if "=" in kv)
        replica = HttpReplica(idx, int(fields["port"]), process=proc)
        self.states[idx] = "starting"
        self._last_beat[idx] = time.monotonic()
        vlog(0, "fleet: worker %d up on port %d (pid %s)", idx,
             replica.port, fields.get("pid"))
        return replica

    def start(self) -> List[HttpReplica]:
        enforce(not self.replicas, "fleet already started")
        self.replicas = [self._spawn(i)
                         for i in range(self.num_replicas)]
        self.poll_states()
        return self.replicas

    def restart(self, idx: int) -> HttpReplica:
        """Replace slot ``idx`` with a fresh worker (rolling upgrade /
        post-failover respawn).  The old process, if any, is killed."""
        old = self.replicas[idx]
        if old.process is not None and old.process.poll() is None:
            old.process.kill()
            old.process.wait(timeout=10)
        self.replicas[idx] = self._spawn(idx)
        self.restarts += 1
        self._flapping.discard(idx)   # fresh worker, fresh record
        self._retired.discard(idx)
        self._reg().counter("fleet.restarts").inc()
        self.poll_states()
        return self.replicas[idx]

    # -- autoscaler actuators -----------------------------------------------
    def spawn(self) -> HttpReplica:
        """Scale up: add one fresh worker slot at the end of the list
        (replica ids are stable — slots are never renumbered).  A
        retired slot is reused before the list grows."""
        for idx in sorted(self._retired):
            return self.restart(idx)
        idx = len(self.replicas)
        self.replicas.append(self._spawn(idx))
        self.num_replicas = len(self.replicas)
        self.poll_states()
        return self.replicas[idx]

    def retire(self, idx: int) -> None:
        """Scale down: stop slot ``idx`` and mark it ``retired`` *in
        place* — the list keeps its shape so every other replica id
        (and every router journal naming one) stays valid.  Drain
        first (``router.drain_replica``) — retire only stops."""
        replica = self.replicas[idx]
        replica.stop()
        proc = replica.process
        if proc is not None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self._retired.add(idx)
        self._flapping.discard(idx)
        self.states[idx] = "retired"
        self._reg().emit("fleet.replica_state", replica=idx,
                         prev="draining", state="retired")
        self.update_gauges()

    # -- flap overlay -------------------------------------------------------
    def set_flapping(self, idx: int, flapping: bool) -> None:
        """Router-side breaker verdict for slot ``idx``; reflected as
        the ``flapping`` census state while the probe says healthy."""
        if flapping:
            self._flapping.add(idx)
        else:
            self._flapping.discard(idx)
        self.poll_states()

    # -- monitoring --------------------------------------------------------
    def _probe(self, idx: int, replica: HttpReplica) -> str:
        if idx in self._retired:
            return "retired"
        proc = replica.process
        if proc is not None and proc.poll() is not None:
            return "dead"
        try:
            code, state = replica.healthz()
            self._last_beat[idx] = time.monotonic()
        except ConnectionError:
            age = time.monotonic() - self._last_beat.get(idx, 0.0)
            if age > self.heartbeat_secs:
                return "dead"
            return self.states.get(idx, "starting")
        if code == 200:
            return "flapping" if idx in self._flapping else "healthy"
        if str(state).startswith(("draining", "stopped")):
            return "draining"
        if str(state).startswith("load-shed"):
            return "healthy"          # shedding, but alive and serving
        return self.states.get(idx, "starting")

    def poll_states(self) -> Dict[int, str]:
        """One health sweep: probe every slot, update the state map and
        the ``fleet.replicas[state=...]`` gauges; returns the map."""
        for idx, replica in enumerate(self.replicas):
            new = self._probe(idx, replica)
            old = self.states.get(idx)
            if new != old:
                self._reg().emit("fleet.replica_state", replica=idx,
                                 prev=old, state=new)
                vlog(1, "fleet: replica %d %s -> %s", idx, old, new)
            self.states[idx] = new
        self.update_gauges()
        return dict(self.states)

    def update_gauges(self) -> None:
        reg = self._reg()
        counts = {s: 0 for s in ("starting", "healthy", "flapping",
                                 "draining", "dead", "retired")}
        for s in self.states.values():
            counts[s] = counts.get(s, 0) + 1
        for state, n in counts.items():
            reg.gauge(f"fleet.replicas[state={state}]").set(float(n))

    def kill(self, idx: int, sig=None) -> None:
        """Hard-kill slot ``idx`` (drill seam — see
        ``testing/faults.kill_replica``)."""
        import signal as _signal
        proc = self.replicas[idx].process
        enforce(proc is not None, f"replica {idx} has no process handle")
        os.kill(proc.pid, sig if sig is not None else _signal.SIGKILL)
        proc.wait(timeout=10)
        self.poll_states()

    def stop(self) -> None:
        for replica in self.replicas:
            replica.stop()
        for replica in self.replicas:
            proc = replica.process
            if proc is None:
                continue
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        for idx in range(len(self.replicas)):
            self.states[idx] = "dead"
        self.update_gauges()


class LocalReplicaManager:
    """In-process fleet manager: :class:`LocalReplica` slots behind the
    same census / spawn / retire / flap protocol as
    :class:`ReplicaManager`, so routers, drills and the autoscaler run
    deterministically in one process (no subprocess nondeterminism).

    ``engine_factory(replica_id)`` builds one ServingEngine per slot —
    the caller seeds them identically when token-exactness matters."""

    def __init__(self, engine_factory, *, replicas: int = 2,
                 registry=None):
        enforce(replicas >= 1, "fleet needs >= 1 replica")
        self.engine_factory = engine_factory
        self._registry = registry
        self.replicas: List[LocalReplica] = [
            LocalReplica(engine_factory(i), replica_id=i)
            for i in range(replicas)]
        self.num_replicas = len(self.replicas)
        self.states: Dict[int, str] = {}
        self.restarts = 0
        self._flapping: set = set()
        self._retired: set = set()
        self.poll_states()

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ...observability.registry import get_registry
        return get_registry()

    def _probe(self, idx: int, replica: LocalReplica) -> str:
        if idx in self._retired:
            return "retired"
        if not replica.alive():
            return "dead"
        code, state = replica.healthz()
        if code == 200:
            return "flapping" if idx in self._flapping else "healthy"
        if str(state).startswith(("draining", "stopped")):
            return "draining"
        return "healthy"

    def poll_states(self) -> Dict[int, str]:
        for idx, replica in enumerate(self.replicas):
            new = self._probe(idx, replica)
            old = self.states.get(idx)
            if new != old:
                self._reg().emit("fleet.replica_state", replica=idx,
                                 prev=old, state=new)
            self.states[idx] = new
        self.update_gauges()
        return dict(self.states)

    update_gauges = ReplicaManager.update_gauges
    set_flapping = ReplicaManager.set_flapping

    def restart(self, idx: int) -> LocalReplica:
        old = self.replicas[idx]
        if old.alive():
            old.stop()
        self.replicas[idx] = LocalReplica(self.engine_factory(idx),
                                          replica_id=idx)
        self.restarts += 1
        self._flapping.discard(idx)
        self._retired.discard(idx)
        self._reg().counter("fleet.restarts").inc()
        self.poll_states()
        return self.replicas[idx]

    def spawn(self) -> LocalReplica:
        for idx in sorted(self._retired):
            return self.restart(idx)
        idx = len(self.replicas)
        self.replicas.append(LocalReplica(self.engine_factory(idx),
                                          replica_id=idx))
        self.num_replicas = len(self.replicas)
        self.poll_states()
        return self.replicas[idx]

    def retire(self, idx: int) -> None:
        replica = self.replicas[idx]
        if replica.alive():
            replica.stop()
        self._retired.add(idx)
        self._flapping.discard(idx)
        self.states[idx] = "retired"
        self._reg().emit("fleet.replica_state", replica=idx,
                         prev="draining", state="retired")
        self.update_gauges()

    def stop(self) -> None:
        for replica in self.replicas:
            if replica.alive():
                replica.stop()
        for idx in range(len(self.replicas)):
            self.states[idx] = "dead"
        self.update_gauges()
