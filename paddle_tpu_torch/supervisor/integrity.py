"""State-integrity guard: the port of ``paddle_tpu/supervisor/
integrity.py``, which detects, attributes and heals silent corruption and
replica desync.

The failures that cost long runs are the silent ones: a bit flips in
device memory, a replica's parameters drift from its peers', or a restore
path quietly mangles state, and the run trains on garbage until the loss
betrays it.  The :class:`IntegrityGuard` closes that gap with four
cooperating pieces, all built on ``distributed/fingerprint.py``'s
``mlh32/1`` tree digest (rank-private leaves excluded with accounting):

1. **Periodic fingerprint**: every ``PTPU_INTEGRITY_EVERY`` steps the
   live state is digested on the card (one scalar readback) and
   published to ``<run_dir>/integrity/worker-<i>.fp.json`` through the
   fsync'd ``fsio`` seam.
2. **Cross-worker compare + attribution**: the guard reads every
   member's board, compares digests at the newest step all members have
   published, and majority-votes: the minority workers are the suspects.
   A 2-way split with no majority blames nobody (``ambiguous``).
3. **Replay audit**: re-run the last microbatch from the stashed
   pre-step state with identical inputs, twice.  Replays that disagree
   with each other -> software **nondeterminism**; replays that agree
   with each other but not with the live state -> hardware **SDC**;
   replays that match the live state -> clean **desync**.  The JAX
   package stashes references (its arrays are immutable); the port's
   tensors change in place, so :meth:`stash_replay` clones the pre-state
   on the card, and the training loop stashes only before the steps at
   which a check is due (:meth:`due`).  ``stash_bytes`` / ``stash_ms``
   hold the last clone's cost.
4. **Healing ladder** (``PTPU_INTEGRITY_ACTION``, default ``resync``)::

       resync    suspect adopts the majority state published under
                 <run_dir>/integrity/resync-step-N/ (the majority side
                 writes it once); rank-private leaves reset to zeros
         | no source in time / repeat offense
         v
       rollback  RollbackManager -> newest digest-verified checkpoint
         | strikes exhausted + an elastic coordinator
         v
       evict     the coordinator shrinks the fleet (the port has no
                 coordinator yet, so this rung degrades to rollback)

   ``report`` detects and records but never heals (forensics mode).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.fingerprint import (DEFAULT_EXCLUDE, Fingerprint,
                                       TreeFingerprint, is_rank_private)
from ..framework.log import vlog
from ..utils import fsio
from ..utils.tree import tree_map, tree_map_with_path

__all__ = ["IntegrityGuard", "IntegrityVerdict", "integrity_dir",
           "default_interval", "default_action", "INTERVAL_ENV",
           "ACTION_ENV"]

INTERVAL_ENV = "PTPU_INTEGRITY_EVERY"
ACTION_ENV = "PTPU_INTEGRITY_ACTION"

_BOARD_PREFIX = "worker-"
_BOARD_SUFFIX = ".fp.json"
_RESYNC_PREFIX = "resync-step-"
_HISTORY = 8          # (step, digest) pairs kept per board file
_RESYNC_KEEP = 2      # newest resync checkpoints kept on disk

_ACTIONS = ("report", "resync", "rollback", "evict")


def default_interval() -> int:
    return int(os.environ.get(INTERVAL_ENV, "50"))


def default_action() -> str:
    return os.environ.get(ACTION_ENV, "resync")


def integrity_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "integrity")


def _board_path(run_dir: str, worker_id: int) -> str:
    return os.path.join(integrity_dir(run_dir),
                        f"{_BOARD_PREFIX}{int(worker_id)}{_BOARD_SUFFIX}")


def _reset_rank_private(tree, exclude: Sequence[str]):
    """Zero every rank-private leaf (adopting another replica's EF
    residuals would be wrong: they describe its quantization errors)."""
    def zero(path, leaf):
        if leaf is None or not is_rank_private(path, exclude):
            return leaf
        return (torch.zeros_like(leaf) if torch.is_tensor(leaf)
                else np.zeros_like(np.asarray(leaf)))
    return tree_map_with_path(zero, tree)


def _clone_tree(tree):
    """A deep copy of a state tree: tensors cloned on their device, the
    rest as they are.  Returns ``(copy, bytes cloned)``."""
    nbytes = [0]

    def copy(x):
        if not torch.is_tensor(x):
            return x
        nbytes[0] += x.numel() * x.element_size()
        return x.detach().clone()
    return tree_map(copy, tree), nbytes[0]


class IntegrityVerdict(dict):
    """A compare outcome — a dict (JSON/report-friendly) with attribute
    sugar: ``{"ok", "step", "digests", "majority", "suspects",
    "ambiguous"}``."""

    @property
    def ok(self) -> bool:
        return bool(self["ok"])

    @property
    def suspects(self) -> List[int]:
        return list(self["suspects"])


class IntegrityGuard:
    """Per-worker integrity state machine (one per RunSupervisor).

    ``fingerprint`` may be a shared :class:`TreeFingerprint` (the
    supervisor hands the same instance to ``ElasticTrainState`` so the
    checkpoint stamp and the cross-worker compare use one digest).
    ``expected`` is the member-id set taking part in the vote (count or
    iterable; ``None`` = whoever has published).  ``strike_budget`` is
    how many desyncs a worker may heal by resync before the ladder
    escalates past it.
    """

    def __init__(self, run_dir: str, *, worker_id: int = 0,
                 every: Optional[int] = None, action: Optional[str] = None,
                 exclude: Sequence[str] = DEFAULT_EXCLUDE,
                 expected=None, report=None,
                 fingerprint: Optional[TreeFingerprint] = None,
                 strike_budget: int = 1, resync_timeout: float = 10.0,
                 clock=time.time):
        self.run_dir = run_dir
        self.worker_id = int(worker_id)
        self.every = default_interval() if every is None else int(every)
        self.action = (default_action() if action is None
                       else str(action))
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown integrity action {self.action!r} "
                             f"(one of {_ACTIONS})")
        self.fingerprint = fingerprint or TreeFingerprint(exclude)
        self.expected = expected
        self.report = report
        self.strike_budget = int(strike_budget)
        self.resync_timeout = float(resync_timeout)
        self.generation: Optional[int] = None
        self._clock = clock
        self._history: List[Tuple[int, str]] = []
        self.last_fingerprint: Optional[Fingerprint] = None
        self.last_verdict: Optional[IntegrityVerdict] = None
        self.checks = 0
        self.mismatches = 0
        self.strikes: Dict[int, int] = {}
        #: newest step a heal already handled — boards keep the stale
        #: mismatching digests until the next publish, and re-latching
        #: the same verdict would climb the ladder a second time
        self.resolved_step: Optional[int] = None
        #: replay-audit stash: (step, cloned pre_state, inputs)
        self._stash: Optional[Tuple[int, Any, Any]] = None
        #: the last stash's clone: bytes and host milliseconds (on the
        #: card the clone is queued, not waited for)
        self.stash_bytes = 0
        self.stash_ms = 0.0
        #: ``fn(state, inputs) -> state`` — a deterministic re-run of one
        #: train step, registered by the training loop for the audit
        self.replay_fn: Optional[Callable[[Any, Any], Any]] = None

    @property
    def enabled(self) -> bool:
        return self.every > 0

    # -- plumbing -----------------------------------------------------------
    def _record(self, kind: str, **fields) -> None:
        if self.report is not None:
            try:
                self.report.record(kind, **fields)
            except Exception as e:
                vlog(0, "integrity: report sink failed for %s: %s", kind, e)
        try:
            from ..observability.registry import get_registry
            get_registry().emit(kind, worker=self.worker_id, **fields)
        except Exception as e:
            vlog(1, "integrity: metrics emit failed: %r", e)

    def _metrics(self, counters: Sequence[str] = (), **gauges) -> None:
        try:
            from ..observability.registry import get_registry
            reg = get_registry()
            for name in counters:
                reg.counter(f"integrity.{name}").inc()
            for name, value in gauges.items():
                reg.gauge(f"integrity.{name}").set(float(value))
        except Exception as e:
            vlog(1, "integrity: metrics failed: %r", e)

    def _expected_ids(self) -> Optional[set]:
        if self.expected is None:
            return None
        if isinstance(self.expected, int):
            return set(range(self.expected))
        return {int(w) for w in self.expected}

    def set_expected(self, expected) -> None:
        """Adopt new membership (eviction)."""
        self.expected = expected

    # -- publication channel ------------------------------------------------
    def publish(self, step: int, fpr: Fingerprint) -> None:
        """Write this worker's digest board (newest ``_HISTORY`` entries
        — peers at slightly different steps still find a common step)."""
        self._history = ([(int(step), fpr.hex())] + self._history)[:_HISTORY]
        payload = {"worker": self.worker_id, "time": float(self._clock()),
                   "digests": [{"step": s, "digest": d}
                               for s, d in self._history],
                   "excluded": len(fpr.excluded)}
        if self.generation is not None:
            payload["generation"] = int(self.generation)
        os.makedirs(integrity_dir(self.run_dir), exist_ok=True)
        try:
            fsio.atomic_write_bytes(
                _board_path(self.run_dir, self.worker_id),
                json.dumps(payload).encode("utf-8"))
        except OSError as e:
            # like a failed heartbeat: absence is itself a signal
            vlog(0, "integrity: board write failed: %s", e)

    def _read_boards(self) -> Dict[int, Dict[int, str]]:
        """{worker: {step: digest}} from every board file."""
        d = integrity_dir(self.run_dir)
        out: Dict[int, Dict[int, str]] = {}
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            if not (name.startswith(_BOARD_PREFIX)
                    and name.endswith(_BOARD_SUFFIX)):
                continue
            try:
                payload = json.loads(fsio.read_bytes(os.path.join(d, name)))
                hist: Dict[int, str] = {}
                for e in payload["digests"]:  # newest-first: a re-publish
                    hist.setdefault(int(e["step"]), str(e["digest"]))
                out[int(payload["worker"])] = hist  # shadows a stale entry
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn read → that worker just has no board yet
        return out

    # -- compare + attribution ---------------------------------------------
    def compare(self, step: Optional[int] = None) -> IntegrityVerdict:
        """Majority-vote the boards at the newest step every expected
        member has published (or exactly ``step`` when given)."""
        boards = self._read_boards()
        expected = self._expected_ids()
        if expected is not None:
            boards = {w: h for w, h in boards.items() if w in expected}
        members = sorted(expected if expected is not None else boards)
        common: Optional[int] = step
        if common is None:
            steps = [set(h) for h in boards.values()]
            if expected is not None and set(boards) != expected:
                steps = []  # someone hasn't published at all yet
            shared = set.intersection(*steps) if steps else set()
            common = max(shared) if shared else None
        if common is None:
            return IntegrityVerdict(
                ok=True, step=None, digests={}, majority=None,
                suspects=[], ambiguous=False, members=members)
        digests = {w: h[common] for w, h in boards.items() if common in h}
        votes: Dict[str, List[int]] = {}
        for w, dgt in digests.items():
            votes.setdefault(dgt, []).append(w)
        if len(votes) <= 1:
            return IntegrityVerdict(
                ok=True, step=common, digests=digests,
                majority=next(iter(votes), None), suspects=[],
                ambiguous=False, members=members)
        ranked = sorted(votes.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        top, runner = ranked[0], ranked[1]
        ambiguous = len(top[1]) == len(runner[1])
        suspects = ([] if ambiguous else
                    sorted(w for d, ws in ranked[1:] for w in ws))
        return IntegrityVerdict(
            ok=False, step=common, digests=digests,
            majority=None if ambiguous else top[0],
            suspects=suspects, ambiguous=ambiguous, members=members)

    # -- the per-interval check --------------------------------------------
    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_check` runs at ``step``: the steps whose
        pre-state the training loop stashes."""
        return self.enabled and step > 0 and step % self.every == 0

    def stash_replay(self, step: int, state, inputs) -> None:
        """Keep a clone of this step's pre-state and references to its
        inputs: the replay audit's raw material.  The clone is taken
        because the live tensors change in place at the step."""
        t0 = time.perf_counter()
        state, nbytes = _clone_tree(state)
        self.stash_ms = (time.perf_counter() - t0) * 1e3
        self.stash_bytes = nbytes
        self._stash = (int(step), state, inputs)

    def maybe_check(self, step: int, state) -> Optional[IntegrityVerdict]:
        """Digest + publish + compare on interval boundaries.  Returns
        the verdict when a check ran (mismatch verdicts carry suspects
        for the supervisor to latch), else None."""
        if not self.due(step):
            return None
        fpr = self.fingerprint.digest(state)
        self.last_fingerprint = fpr
        self.checks += 1
        self.publish(step, fpr)
        self._metrics(counters=["checks"], last_step=step,
                      interval=self.every, digest=fpr.tree)
        return self._adjudicate(self.compare(step))

    def recheck(self, step: Optional[int] = None
                ) -> Optional[IntegrityVerdict]:
        """Re-run the compare after peers published (a fleet barrier):
        a worker whose ``maybe_check`` ran before its peers' saw an
        incomplete board set and voted on a stale common step.  Full
        strike/record accounting, same as ``maybe_check``, minus the
        digest + publish; a verdict identical to the last one is
        returned without double-counting."""
        if not self.enabled:
            return None
        verdict = self.compare(step)
        if (not verdict.ok and self.resolved_step is not None
                and verdict["step"] is not None
                and verdict["step"] <= self.resolved_step):
            return None  # stale boards from a step a heal already handled
        if (self.last_verdict is not None
                and dict(verdict) == dict(self.last_verdict)):
            return self.last_verdict
        return self._adjudicate(verdict)

    def _adjudicate(self, verdict: IntegrityVerdict) -> IntegrityVerdict:
        self.last_verdict = verdict
        self._metrics(workers=len(verdict["digests"]),
                      suspects=len(verdict["suspects"]))
        if verdict.ok:
            self._record("integrity.check", step=verdict["step"],
                         digest=(self.last_fingerprint.hex()
                                 if self.last_fingerprint else None),
                         workers=len(verdict["digests"]), ok=True)
            return verdict
        self.mismatches += 1
        for w in (verdict.suspects or verdict["digests"]):
            if not verdict["ambiguous"] or w in verdict.suspects:
                self.strikes[w] = self.strikes.get(w, 0) + 1
        self._metrics(counters=["mismatches"])
        self._record("integrity.desync", step=verdict["step"],
                     digests=dict(verdict["digests"]),
                     majority=verdict["majority"],
                     suspects=verdict.suspects,
                     ambiguous=verdict["ambiguous"])
        vlog(0, "integrity: DESYNC at step %s — digests %s, suspects %s%s",
             verdict["step"], verdict["digests"], verdict.suspects,
             " (ambiguous: no majority)" if verdict["ambiguous"] else "")
        return verdict

    # -- replay audit -------------------------------------------------------
    def audit(self, replay_fn: Optional[Callable[[Any, Any], Any]] = None
              ) -> Dict[str, Any]:
        """Re-run the stashed microbatch twice with identical inputs and
        classify this replica (see module docstring):

        - ``nondeterminism`` — the two replays disagree;
        - ``sdc_suspect``    — replays agree with each other, not with
          the live digest: state damaged outside the computed path;
        - ``desync``         — replays reproduce the live state: this
          replica computes consistently, the divergence is upstream.
        """
        replay_fn = replay_fn or self.replay_fn
        if replay_fn is None or self._stash is None:
            return {"verdict": "unavailable",
                    "reason": ("no replay_fn registered"
                               if replay_fn is None else "nothing stashed")}
        step, pre_state, inputs = self._stash
        d1 = self.fingerprint.digest(replay_fn(pre_state, inputs)).hex()
        d2 = self.fingerprint.digest(replay_fn(pre_state, inputs)).hex()
        live = (self.last_fingerprint.hex()
                if self.last_fingerprint is not None else None)
        if d1 != d2:
            verdict = "nondeterminism"
        elif live is not None and d1 != live:
            verdict = "sdc_suspect"
        else:
            verdict = "desync"
        out = {"verdict": verdict, "step": step, "replay": d1,
               "replay2": d2, "live": live}
        self._metrics(counters=["audits"])
        self._record("integrity.audit", **out)
        vlog(0, "integrity: replay audit at step %d → %s "
             "(replay=%s/%s live=%s)", step, verdict, d1, d2, live)
        return out

    # -- healing ladder -----------------------------------------------------
    def _resync_path(self, step: int) -> str:
        return os.path.join(integrity_dir(self.run_dir),
                            f"{_RESYNC_PREFIX}{int(step)}")

    def offer_resync(self, step: int, state) -> str:
        """Majority side: publish the known-good state once (idempotent
        across majority members — first writer wins) and gc old offers."""
        from ..distributed.checkpoint import save_sharded
        path = self._resync_path(step)
        done = os.path.join(path, "COMMITTED")
        if os.path.exists(done):
            return path
        fpr = self.fingerprint.digest(state)
        meta = fpr.meta()
        meta["exclude"] = list(self.fingerprint.exclude)
        save_sharded(state, path, integrity=meta)
        fsio.write_bytes(done, b"")
        fsio.fsync_dir(integrity_dir(self.run_dir))
        self._gc_resync()
        self._record("integrity.resync_offered", step=step,
                     digest=fpr.hex(), path=path)
        return path

    def _gc_resync(self) -> None:
        import shutil
        d = integrity_dir(self.run_dir)
        offers = sorted(
            (int(n[len(_RESYNC_PREFIX):]), n) for n in os.listdir(d)
            if n.startswith(_RESYNC_PREFIX)
            and n[len(_RESYNC_PREFIX):].isdigit())
        for _s, name in offers[:-_RESYNC_KEEP]:
            shutil.rmtree(os.path.join(d, name), ignore_errors=True)

    def take_resync(self, step: int, template_fn: Callable[[], Any]
                    ) -> Optional[Any]:
        """Suspect side: wait for a majority offer and adopt it (digest-
        verified by ``load_sharded``; rank-private leaves reset).  None
        when no offer lands inside ``resync_timeout``."""
        from ..distributed.checkpoint import load_sharded
        path = self._resync_path(step)
        done = os.path.join(path, "COMMITTED")
        deadline = float(self._clock()) + self.resync_timeout
        while not os.path.exists(done):
            if float(self._clock()) >= deadline:
                return None
            time.sleep(0.05)
        state = load_sharded(path, template_fn())
        return _reset_rank_private(state, self.fingerprint.exclude)

    def heal(self, supervisor, verdict: IntegrityVerdict,
             init_fn: Callable[[], Any], template_fn: Callable[[], Any],
             state) -> Tuple[Any, int, str]:
        """Run the ladder for a latched mismatch verdict; returns
        ``(state, start_step, action_taken)``.  Majority members serve
        the resync offer and continue; suspects climb
        resync → rollback → evict as far as circumstance requires."""
        step = int(verdict["step"])
        self.resolved_step = max(step, self.resolved_step or 0)
        suspect = self.worker_id in verdict.suspects
        audit = (self.audit() if suspect else None)
        rung = self.action
        if rung == "report":
            self._record("integrity.heal", step=step, action="report",
                         suspect=suspect)
            return state, supervisor.gstep, "report"
        if not suspect and not verdict["ambiguous"]:
            # healthy majority: serve the known-good state, keep going
            if rung == "resync":
                self.offer_resync(step, state)
            self._record("integrity.heal", step=step, action="offer",
                         suspect=False)
            return state, supervisor.gstep, "offer"
        # ambiguous splits can't name a donor → everyone rolls back
        if verdict["ambiguous"] and rung == "resync":
            rung = "rollback"
        strikes = self.strikes.get(self.worker_id, 1)
        if rung == "resync" and strikes > self.strike_budget:
            rung = "rollback"  # repeat offender: resync isn't sticking
        if rung == "resync":
            healed = self.take_resync(step, template_fn)
            if healed is not None:
                # shadow the stale board entry with the adopted state's
                # digest — peers comparing at this step must now agree
                fpr = self.fingerprint.digest(healed)
                self.last_fingerprint = fpr
                self.publish(step, fpr)
                self._metrics(counters=["resyncs"])
                self._record("integrity.heal", step=step, action="resync",
                             suspect=True, audit=audit,
                             strikes=strikes)
                return healed, supervisor.gstep, "resync"
            vlog(0, "integrity: no resync offer within %.1fs — "
                 "escalating to rollback", self.resync_timeout)
            rung = "rollback"
        if rung == "evict" or (strikes > self.strike_budget + 1
                               and supervisor.coordinator is not None):
            coord = supervisor.coordinator
            if coord is not None:
                target = coord.clamp((coord.dp or coord.max_dp) - 1)
                self._metrics(counters=["evictions"])
                self._record("integrity.heal", step=step, action="evict",
                             suspect=True, audit=audit, new_dp=target)
                supervisor.request_resize(
                    target, reason=f"integrity-evict:{self.worker_id}")
                st, start = supervisor.perform_resize(init_fn, template_fn)
                return st, start, "evict"
            rung = "rollback"  # nothing to shrink: degrade
        self._metrics(counters=["rollbacks"])
        self._record("integrity.heal", step=step, action="rollback",
                     suspect=True, audit=audit, strikes=strikes)
        st, start = supervisor.perform_rollback(
            init_fn, template_fn, reason=f"integrity:{step}")
        return st, start, "rollback"
