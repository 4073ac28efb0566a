"""Fault injectors: the port's own copy of ``paddle_tpu/testing/
faults.py``.

The checkpoint half: every durable byte (shards, manifests, pickles, the
elastic COMMITTED marker, heartbeats, reports) flows through one seam,
``utils/fsio.write_bytes``; :class:`FaultInjector` patches it inside a
``with`` block and fails, truncates, flips, stalls or follows with a
SIGTERM the selected writes.  :func:`flip_byte`, :func:`truncate_file`,
:func:`corrupt_shard` and :func:`corrupt_manifest` damage a committed
checkpoint on disk; :func:`fast_retries` swaps the checkpoint and
``framework.io`` retry policies for a sleepless one.

The training half: :class:`diverge_after` poisons the losses a run
supervisor sees (``RunSupervisor.inject_loss``); :func:`sigkill_self` /
:class:`sigkill_at` are the unmaskable preemption; :func:`flip_tree_bit`
/ :class:`bitflip` flip one bit of a live state tree (the in-memory
corruption the integrity guard must catch).

The serving half:

- :func:`hang` / :func:`slow_call` — an interruptible stall (a hung or a
  slow-but-alive step) for the watchdog drills;
- :class:`poison_request` — plugs into ``ServingEngine(step_fault=...)``
  and poisons one request's step (raise / NaN logits / hang), so the
  quarantine, NaN-guard and watchdog paths are drillable without real
  hardware faults;
- :class:`expire_clock` — a hand-advanced clock for deadline drills.

and the fleet half:

- :class:`kill_replica` — SIGKILL one fleet worker subprocess, optionally
  gated on a ``when()`` predicate the drill polls, so "kill replica 0
  once stream X has 3 accepted tokens" is deterministic;
- :class:`drop_dispatch` — plugs into ``Router.dispatch_fault`` and fails
  the first N dispatch attempts with ``ConnectionError``, driving the
  retry-with-backoff and exhaustion paths without a real network;
- :class:`flaky_replica` — a *live* replica's transport fails / stalls
  intermittently (seeded): alive and healthy by census, yet a fraction
  of its calls raise ``ConnectionError`` — the circuit-breaker and
  retry-budget drill.

The injectors are the JAX package's, so one drill script drives either
package the same way.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import os
import random
import signal as _signal
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils import fsio
from ..utils.retry import RetryPolicy

__all__ = ["FaultInjector", "flip_byte", "truncate_file", "corrupt_shard",
           "corrupt_manifest", "fast_retries", "hang", "slow_call",
           "diverge_after", "sigkill_self", "sigkill_at", "bitflip",
           "flip_tree_bit", "poison_request", "expire_clock",
           "kill_replica", "drop_dispatch", "flaky_replica"]


def _default_transient() -> OSError:
    return OSError("injected transient I/O error")


class FaultInjector:
    """Context manager that intercepts ``fsio.write_bytes`` and injects
    configured faults; every write it does not target passes through to
    the real (fsync'd) implementation.  Writes are numbered from 1 across
    the block; each retry attempt counts as a fresh write.

    >>> with FaultInjector() as fi:
    ...     fi.fail_writes(first=1, times=3)      # 3 transient OSErrors
    ...     save_sharded(state, path)             # retry absorbs them
    """

    def __init__(self):
        self.write_count = 0
        self.injected: List[Tuple[int, str, str]] = []  # (n, kind, path)
        self._rules: List[tuple] = []
        self._orig: Optional[Callable] = None

    # -- rules (chainable) ---------------------------------------------------
    def fail_writes(self, first: int, times: int = 1,
                    exc_factory: Callable[[], BaseException] =
                    _default_transient) -> "FaultInjector":
        """Raise ``exc_factory()`` on writes ``first .. first+times-1``."""
        self._rules.append(("fail", first, times, exc_factory))
        return self

    def truncate_write(self, nth: int, keep_bytes: int = 8
                       ) -> "FaultInjector":
        """Write only the first ``keep_bytes`` of the Nth write (a torn
        write: the file exists but is short)."""
        self._rules.append(("truncate", nth, keep_bytes))
        return self

    def flip_byte_on_write(self, nth: int, offset: int = -1
                           ) -> "FaultInjector":
        """Flip one byte of the Nth write's payload (bit rot at write
        time; the size stays right, the CRC must catch it)."""
        self._rules.append(("flip", nth, offset))
        return self

    def sigterm_on_write(self, nth: int) -> "FaultInjector":
        """Deliver SIGTERM to this process right after the Nth write
        lands (a preemption notice arriving mid-save)."""
        self._rules.append(("sigterm", nth))
        return self

    def hang_on_write(self, nth: int, seconds: float) -> "FaultInjector":
        """Stall the Nth write for ``seconds`` (a wedged file server),
        interruptibly, so a watchdog's ``StepTimeout`` can cut it short."""
        self._rules.append(("hang", nth, seconds))
        return self

    # -- interception ------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        self._orig = fsio.write_bytes
        fsio.write_bytes = self._intercept
        return self

    def __exit__(self, *exc) -> None:
        fsio.write_bytes = self._orig
        self._orig = None

    def _intercept(self, path: str, payload: bytes) -> None:
        self.write_count += 1
        n = self.write_count
        for rule in self._rules:
            kind = rule[0]
            if kind == "fail" and rule[1] <= n < rule[1] + rule[2]:
                self.injected.append((n, kind, path))
                raise rule[3]()
            if kind == "truncate" and n == rule[1]:
                self.injected.append((n, kind, path))
                return self._orig(path, payload[: rule[2]])
            if kind == "flip" and n == rule[1]:
                self.injected.append((n, kind, path))
                mutated = bytearray(payload)
                mutated[rule[2]] ^= 0xFF
                return self._orig(path, bytes(mutated))
            if kind == "sigterm" and n == rule[1]:
                self.injected.append((n, kind, path))
                self._orig(path, payload)
                os.kill(os.getpid(), _signal.SIGTERM)
                return None
            if kind == "hang" and n == rule[1]:
                self.injected.append((n, kind, path))
                hang(rule[2])
                return self._orig(path, payload)
        return self._orig(path, payload)


# -- offline corruption (damage committed bytes on disk) -------------------
def flip_byte(path: str, offset: Optional[int] = None) -> None:
    """XOR one byte of ``path`` in place (default: the middle byte, which
    for .npy files lands in array data, not the header)."""
    with open(path, "r+b") as f:  # noqa: fsio - deliberate corruption
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            raise ValueError(f"{path} is empty, nothing to flip")
        pos = size // 2 if offset is None else offset % size
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_file(path: str, keep_bytes: int = 8) -> None:
    with open(path, "r+b") as f:  # noqa: fsio - deliberate corruption
        f.truncate(keep_bytes)


def corrupt_shard(ckpt_dir: str, index: int = 0,
                  offset: Optional[int] = None) -> str:
    """Flip a byte in the ``index``-th shard file (sorted order) of a
    saved checkpoint; returns the damaged file's path."""
    shards = sorted(glob.glob(os.path.join(ckpt_dir, "*", "shard-*.npy")))
    if not shards:
        raise FileNotFoundError(f"no shard files under {ckpt_dir}")
    flip_byte(shards[index], offset)
    return shards[index]


def corrupt_manifest(ckpt_dir: str, keep_bytes: int = 16) -> str:
    """Truncate the checkpoint's manifest (a torn manifest write); returns
    the damaged file's path."""
    names = (sorted(glob.glob(os.path.join(ckpt_dir, "manifest-p*.json")))
             or [os.path.join(ckpt_dir, "manifest.json")])
    truncate_file(names[0], keep_bytes)
    return names[0]


@contextlib.contextmanager
def fast_retries(max_attempts: int = 4):
    """Swap the checkpoint's and ``framework.io``'s retry policies for a
    sleepless one for the block (fault tests measure behaviour, not
    backoff time)."""
    from ..distributed import checkpoint as ckpt_mod
    from ..framework import io as io_mod

    policy = RetryPolicy(max_attempts=max_attempts, base_delay=0.0,
                         jitter=0.0, sleep=lambda _t: None)
    saved = (ckpt_mod.IO_RETRY_POLICY, io_mod.IO_RETRY_POLICY)
    ckpt_mod.IO_RETRY_POLICY = policy
    io_mod.IO_RETRY_POLICY = policy
    try:
        yield policy
    finally:
        ckpt_mod.IO_RETRY_POLICY, io_mod.IO_RETRY_POLICY = saved


def hang(seconds: float, interval: float = 0.01) -> None:
    """Block for ``seconds`` in short interruptible slices — a simulated
    hung step.  Unlike one long ``time.sleep`` this yields a bytecode
    boundary every ``interval``, so the watchdog's async ``StepTimeout``
    lands promptly instead of after the full hang."""
    deadline = time.monotonic() + float(seconds)
    while time.monotonic() < deadline:
        time.sleep(interval)


def slow_call(fn: Callable, seconds: float) -> Callable:
    """Wrap ``fn`` to stall (interruptibly) for ``seconds`` before every
    call — slow-but-alive, the case a watchdog must NOT fire on when the
    deadline is generous enough (and a slow ``on_token`` consumer, which
    delays only its own stream)."""
    @functools.wraps(fn)
    def slowed(*args, **kwargs):
        hang(seconds)
        return fn(*args, **kwargs)
    return slowed


class poison_request:
    """Step-fault injector for the ServingEngine quarantine drill: plug
    into ``ServingEngine(step_fault=...)``; the engine calls it as
    ``fault(engine, kind, request_ids, logits)`` on every executed step —
    bisection probes included — with the step's logits on the host.

    ``target`` is a request id (str) or a submit-order index (int,
    resolved lazily against ``engine._submit_order``).  Modes:

    - ``"raise"`` — raise a RuntimeError whenever the target is in the
      batch (re-fires on every probe subset containing the target, which
      is what lets the engine's bisection converge on it);
    - ``"nan"`` — overwrite the target's logits row with NaN (the
      silent-corruption shape the NaN guard must catch);
    - ``"hang"`` — stall interruptibly for ``seconds`` (watchdog drill);
      fires at most ``count`` times (default 1) since the target stays in
      the batch after hang recovery.

    ``kinds`` restricts the injector to ``"prefill"`` and / or
    ``"decode"`` steps.  ``fired`` counts activations."""

    def __init__(self, target, mode: str = "raise",
                 seconds: float = 1.0, count: Optional[int] = None,
                 kinds: Tuple[str, ...] = ("prefill", "decode")):
        if mode not in ("raise", "nan", "hang"):
            raise ValueError(f"unknown poison mode {mode!r}")
        self.target = target
        self.mode = mode
        self.seconds = float(seconds)
        self.count = (1 if mode == "hang" else None) \
            if count is None else int(count)
        self.kinds = tuple(kinds)
        self.fired = 0

    def _target_id(self, engine) -> Optional[str]:
        if isinstance(self.target, str):
            return self.target
        order = engine._submit_order
        idx = int(self.target)
        return order[idx] if 0 <= idx < len(order) else None

    def __call__(self, engine, kind: str, request_ids, logits):
        if kind not in self.kinds:
            return None
        rid = self._target_id(engine)
        if rid is None or rid not in request_ids:
            return None
        if self.count is not None and self.fired >= self.count:
            return None
        self.fired += 1
        if self.mode == "raise":
            raise RuntimeError(f"injected poisoned step ({rid})")
        if self.mode == "hang":
            hang(self.seconds)
            return None
        out = np.array(logits, copy=True)
        out[request_ids.index(rid)] = np.nan
        return out


class expire_clock:
    """Controllable clock for deadline drills: pass as
    ``ServingEngine(clock=...)``, then ``advance(secs)`` to expire
    deadlines without real waiting.  Starts at ``start`` (default 1000.0
    — any fixed epoch; deadline math is all relative)."""

    def __init__(self, start: float = 1000.0):
        self.now = float(start)

    def advance(self, seconds: float) -> float:
        self.now += float(seconds)
        return self.now

    def __call__(self) -> float:
        return self.now


# ---------------------------------------------------------------------------
# run-level injectors (supervisor and integrity drills)
# ---------------------------------------------------------------------------
class diverge_after:
    """Loss injector for the divergence-guard path: identity until
    ``step``, then poisons every observed loss: ``mode="spike"`` grows it
    by ``factor`` each step (a finite blow-up), ``mode="nan"`` /
    ``mode="inf"`` go non-finite at once.  Plugs into
    ``RunSupervisor.inject_loss`` (called as ``fn(step, loss)``).
    ``triggered`` counts poisoned steps; ``count`` bounds them (None:
    keep diverging, the broken-run drill)."""

    def __init__(self, step: int, mode: str = "spike",
                 factor: float = 100.0, count: Optional[int] = None):
        if mode not in ("spike", "nan", "inf"):
            raise ValueError(f"unknown divergence mode {mode!r}")
        self.step = int(step)
        self.mode = mode
        self.factor = float(factor)
        self.count = count
        self.triggered = 0

    def __call__(self, step: int, loss: float) -> float:
        if step < self.step or (self.count is not None
                                and self.triggered >= self.count):
            return loss
        self.triggered += 1
        if self.mode == "nan":
            return float("nan")
        if self.mode == "inf":
            return float("inf")
        return (abs(loss) + 1.0) * self.factor ** self.triggered


def sigkill_self() -> None:
    """SIGKILL this process: the unmaskable preemption, with no grace
    window and no final checkpoint flush."""
    os.kill(os.getpid(), _signal.SIGKILL)


class sigkill_at:
    """Step-triggered SIGKILL: call per step (``fault(step)``); fires
    :func:`sigkill_self` once ``step >= trigger`` and ``generation ==
    gen`` (None: any generation)."""

    def __init__(self, step: int, generation: Optional[int] = 0):
        self.step = int(step)
        self.generation = generation

    def __call__(self, step: int, generation: Optional[int] = None
                 ) -> None:
        if step < self.step:
            return
        if (self.generation is not None and generation is not None
                and int(generation) != self.generation):
            return
        sigkill_self()


def flip_tree_bit(tree, leaf: str, bit: int = 0, index: int = 0):
    """XOR one bit of one element of one named leaf of a live state tree:
    the in-memory corruption that CRCs on disk never see.  ``leaf`` is
    the "/"-joined name (the checkpoint's), ``bit`` indexes the leaf's
    raw bytes (0 = the low bit of byte 0) after ``index`` whole elements.
    Returns a new tree whose named leaf is a flipped copy; every other
    leaf is the same object."""
    import torch
    from ..distributed.checkpoint import _flatten
    from ..utils.tree import tree_map_with_path

    names = [n for n, _x in _flatten(tree)]
    if leaf not in names:
        raise KeyError(f"no leaf {leaf!r} (have {sorted(names)[:8]}...)")

    def _flip(x):
        if torch.is_tensor(x):
            out = x.detach().clone().contiguous()
            raw = out.reshape(-1).view(torch.uint8)
            pos = (index * out.element_size() + bit // 8) % raw.numel()
            raw[pos] ^= 1 << (bit % 8)
            return out
        arr = np.array(x, copy=True)
        raw = arr.reshape(-1).view(np.uint8)
        pos = index * arr.dtype.itemsize + bit // 8
        raw[pos % raw.size] ^= np.uint8(1 << (bit % 8))
        return arr

    return tree_map_with_path(
        lambda path, x: _flip(x) if path == leaf else x, tree)


class bitflip:
    """Step-triggered single-bit corruptor for integrity drills: call per
    step with the live state (``state = fault(step, state, worker=i)``);
    at ``step >= trigger`` on the targeted ``worker`` it flips ``bit`` of
    ``leaf`` once and stays quiet after.  ``fired`` records the step.

    The flip happens outside the computed path (between steps): replays
    from the stashed pre-state agree with each other but not with the
    live digest, the ``sdc_suspect`` signature."""

    def __init__(self, leaf: str, bit: int = 0, step: int = 1,
                 worker: Optional[int] = None, index: int = 0):
        self.leaf = leaf
        self.bit = int(bit)
        self.step = int(step)
        self.worker = worker
        self.index = int(index)
        self.fired: Optional[int] = None

    def __call__(self, step: int, tree, worker: Optional[int] = None):
        if self.fired is not None or step < self.step:
            return tree
        if (self.worker is not None and worker is not None
                and int(worker) != self.worker):
            return tree
        self.fired = int(step)
        return flip_tree_bit(tree, self.leaf, self.bit, self.index)


# ---------------------------------------------------------------------------
# fleet injectors
# ---------------------------------------------------------------------------
class kill_replica:
    """SIGKILL one fleet worker subprocess, deterministically.

    ``target`` is anything with a live process: a ``ReplicaManager``
    plus ``index``, an ``HttpReplica`` (its ``.process``), a
    ``subprocess.Popen``, or a bare pid.  With ``when`` (a no-arg
    predicate) the drill polls ``maybe()`` in its pump loop and the
    kill fires exactly once, the first time the predicate holds —
    e.g. ``when=lambda: len(journal.tokens) >= 3`` pins "die
    mid-stream after 3 accepted tokens".  Calling the injector
    directly fires unconditionally.

    >>> k = kill_replica(manager, index=0,
    ...                  when=lambda: len(j.tokens) >= 3)
    >>> while router.pump() > 0:
    ...     k.maybe()
    >>> k.fired
    1
    """

    def __init__(self, target, index: Optional[int] = None,
                 sig: int = _signal.SIGKILL,
                 when: Optional[Callable[[], bool]] = None):
        self.target = target
        self.index = index
        self.sig = sig
        self.when = when
        self.fired = 0

    def _pid(self) -> int:
        t = self.target
        if isinstance(t, int):
            return t
        if self.index is not None and hasattr(t, "replicas"):
            t = t.replicas[self.index]          # ReplicaManager slot
        proc = getattr(t, "process", t)          # HttpReplica -> Popen
        return int(proc.pid)

    def __call__(self) -> int:
        """Fire now; returns the killed pid."""
        pid = self._pid()
        t = self.target
        if self.index is not None and hasattr(t, "replicas"):
            t.kill(self.index, self.sig)       # marks the slot signalled
            t.poll_states()
        else:
            if hasattr(t, "signalled"):        # an HttpReplica
                t.signalled = True
            os.kill(pid, self.sig)
        self.fired += 1
        return pid

    def maybe(self) -> bool:
        """Fire once when ``when()`` first holds; True if it fired."""
        if self.fired or (self.when is not None and not self.when()):
            return False
        self()
        return True


class drop_dispatch:
    """Router-visible network fault: assigned to
    ``Router.dispatch_fault``, it raises ``ConnectionError`` for the
    first ``count`` dispatch attempts (optionally only toward
    ``replica_id``), then passes everything — the deterministic way to
    drill retry-with-backoff and ``DispatchExhausted``.

    >>> router.dispatch_fault = drop_dispatch(count=2)
    >>> router.submit(...)      # two retries burned, third attempt lands
    """

    def __init__(self, count: int, replica_id: Optional[int] = None):
        self.count = int(count)
        self.replica_id = replica_id
        self.fired = 0

    def __call__(self, replica_id: int, record) -> None:
        if self.replica_id is not None and replica_id != self.replica_id:
            return
        if self.fired >= self.count:
            return
        self.fired += 1
        raise ConnectionError(
            f"injected dispatch drop {self.fired}/{self.count} "
            f"(replica {replica_id}, request "
            f"{record.get('request_id')!r})")


class flaky_replica:
    """Intermittent transport faults on a LIVE replica.

    Unlike :class:`kill_replica`, the replica keeps running and its
    ``healthz`` stays 200 — only the router-facing transport methods
    (``submit`` / ``poll`` / ``serving_stats``) are wrapped so that a
    seeded fraction of calls raise ``ConnectionError`` (``error_rate``)
    and/or stall (``latency_ms``).  That is exactly the *flapping*
    regime: the binary census says healthy, yet every few calls storm
    the retry path — the scenario the circuit breaker + retry budget
    must absorb.

    ``target`` is a ``ReplicaManager``/``LocalReplicaManager`` plus
    ``index``, or a replica object directly.  ``when`` (no-arg
    predicate, like ``kill_replica``) gates injection per call, so
    "start flaking once stream X has 2 tokens" is deterministic.
    Restores the original methods on ``stop()`` / context exit.

    >>> with flaky_replica(manager, index=1, error_rate=0.3,
    ...                    seed=7) as flake:
    ...     router.run(timeout=30)
    >>> flake.injected_errors > 0
    True
    """

    METHODS = ("submit", "poll", "serving_stats")

    def __init__(self, target, index: Optional[int] = None,
                 error_rate: float = 0.0, latency_ms: float = 0.0,
                 seed: int = 0,
                 when: Optional[Callable[[], bool]] = None,
                 sleep=time.sleep):
        if index is not None and hasattr(target, "replicas"):
            target = target.replicas[index]     # manager slot
        self.replica = target
        self.error_rate = float(error_rate)
        self.latency_ms = float(latency_ms)
        self.when = when
        self.rng = random.Random(seed)
        self._sleep = sleep
        self.calls = 0
        self.injected_errors = 0
        self.injected_delays = 0
        self._saved: dict = {}
        self._install()

    _MISSING = object()   # name was class-level, not an instance attr

    def _install(self) -> None:
        for name in self.METHODS:
            orig = getattr(self.replica, name)
            self._saved[name] = self.replica.__dict__.get(
                name, self._MISSING)

            def wrapper(*a, _orig=orig, _name=name, **kw):
                return self._intercept(_orig, _name, *a, **kw)

            setattr(self.replica, name, wrapper)

    def _intercept(self, orig, name, *a, **kw):
        self.calls += 1
        if self.when is None or self.when():
            if self.latency_ms > 0:
                self.injected_delays += 1
                self._sleep(self.latency_ms / 1e3)
            if self.rng.random() < self.error_rate:
                self.injected_errors += 1
                raise ConnectionError(
                    f"injected flake #{self.injected_errors} "
                    f"({name} on replica "
                    f"{getattr(self.replica, 'replica_id', '?')})")
        return orig(*a, **kw)

    def stop(self) -> None:
        """Restore the wrapped transport (idempotent)."""
        for name, prev in self._saved.items():
            if prev is self._MISSING:
                delattr(self.replica, name)   # class method shows again
            else:
                setattr(self.replica, name, prev)
        self._saved = {}

    def __enter__(self) -> "flaky_replica":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
