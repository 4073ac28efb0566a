"""Elastic / preemption handling: the port of ``paddle_tpu/distributed/
elastic.py`` for one process (reference: fleet/elastic/manager.py
``ElasticManager``:130; fluid/incubate/checkpoint/auto_checkpoint.py).

What the framework owes a preemptible job is **surviving preemption**:
periodic async checkpoints, a SIGTERM hook that flushes one final
checkpoint inside the grace window, and a restore-on-restart.

Atomic commit protocol: every save is staged into ``step-N.<seq>.tmp/``
(shards + manifest fsync'd there by ``save_sharded``), then
``os.replace``d to ``step-N/``, then the COMMITTED marker is written and
the parent directory fsync'd.  A crash at any point leaves either a
``.tmp`` staging dir (never eligible for restore) or a fully durable
committed step: restore never observes a torn checkpoint.  On restore,
``restore_or`` walks committed steps newest -> oldest, quarantining
(``step-N/`` -> ``step-N.corrupt/``) any that fail manifest, checksum or
digest validation, and falls back to a fresh init only when none
survive.  The on-disk format is the JAX package's, so either package
restores the other's chain.

The **world descriptor** (``<run_dir>/world.json``) is the
generation-stamped membership record a launcher owns; a worker holding a
stale generation is *fenced*: its commits are refused
(:class:`StaleGeneration`).  The JAX package's ``ElasticCoordinator``
(re-forming the mesh at a new data-parallel width) waits for the port's
multi-GPU slice and is not here.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from ..framework.log import vlog
from ..utils import fsio
from . import get_world_size
from .checkpoint import (AsyncSaveHandle, CheckpointCorruption,
                         DigestMismatch, load_sharded, save_sharded)

__all__ = ["ElasticTrainState", "StaleGeneration",
           "latest_checkpoint", "committed_checkpoints", "read_world",
           "write_world", "world_path"]

_STEP_PREFIX = "step-"
_TMP_SUFFIX = ".tmp"
_CORRUPT_SUFFIX = ".corrupt"

#: newest quarantined ``step-N.corrupt/`` dirs kept by gc (forensics);
#: older ones are swept so a corrupt-prone disk can't fill itself.
CORRUPT_KEEP_ENV = "PTPU_CORRUPT_KEEP"

_WORLD_FILE = "world.json"


class StaleGeneration(RuntimeError):
    """This worker's world generation is older than the fleet's — it was
    declared lost (or retired) and must not commit checkpoints or act on
    the run; restart and rejoin at the current generation."""


# ---------------------------------------------------------------------------
# world descriptor (generation-stamped membership, owned by the launcher)
# ---------------------------------------------------------------------------
def world_path(run_dir: str) -> str:
    return os.path.join(run_dir, _WORLD_FILE)


def write_world(run_dir: str, *, generation: int, members: Iterable[int],
                min_size: int = 1, max_size: Optional[int] = None,
                reason: str = "init", clock=time.time) -> Dict[str, Any]:
    """Durably publish a new world descriptor.  The launcher (or a test
    harness) is the single writer; workers only read.  The atomic write
    means a reader never observes a torn descriptor."""
    members = sorted(int(m) for m in members)
    desc = {"generation": int(generation), "members": members,
            "world_size": len(members), "min_size": int(min_size),
            "max_size": (len(members) if max_size is None
                         else int(max_size)),
            "reason": str(reason), "updated": float(clock())}
    os.makedirs(run_dir, exist_ok=True)
    fsio.atomic_write_bytes(world_path(run_dir),
                            json.dumps(desc, indent=1).encode("utf-8"))
    return desc


def read_world(run_dir: str) -> Optional[Dict[str, Any]]:
    """The current world descriptor, or None when absent/unreadable (a
    torn read is indistinguishable from "not published yet" — callers
    poll)."""
    try:
        return json.loads(fsio.read_bytes(world_path(run_dir)))
    except (OSError, ValueError):
        return None


def _step_of(name: str) -> Optional[int]:
    """Step number of a ``step-N[.seq][.tmp|.corrupt]`` entry name (else
    None)."""
    if not name.startswith(_STEP_PREFIX):
        return None
    stem = name[len(_STEP_PREFIX):]
    for suffix in (_TMP_SUFFIX, _CORRUPT_SUFFIX):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    stem = stem.split(".")[0]  # drop the per-save staging token
    try:
        return int(stem)
    except ValueError:
        return None


def committed_checkpoints(directory: str) -> List[str]:
    """Every committed checkpoint path under ``directory``, newest first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX) or name.endswith(
                (_TMP_SUFFIX, _CORRUPT_SUFFIX)):
            continue
        full = os.path.join(directory, name)
        if not os.path.exists(os.path.join(full, "COMMITTED")):
            continue  # partial write (crashed mid-save)
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue
        found.append((step, full))
    return [path for _, path in sorted(found, reverse=True)]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest complete checkpoint path under ``directory`` (or None)."""
    done = committed_checkpoints(directory)
    return done[0] if done else None


class ElasticTrainState:
    """Preemption-aware checkpoint manager.

    >>> mgr = ElasticTrainState("ckpts", save_interval_steps=100)
    >>> state, start = mgr.restore_or(init_state, template_fn)
    >>> for step in range(start, total):
    ...     state = train_step(state)
    ...     mgr.maybe_save(step, state)     # async, every interval
    >>> mgr.finalize(step, state)

    On SIGTERM (a scheduler's preemption notice) the handler saves one
    final checkpoint synchronously before re-raising the default handler;
    a restart resumes from it.  ≙ ElasticManager's
    watch→checkpoint→relaunch cycle with the relaunch owned by the cluster
    scheduler.
    """

    def __init__(self, directory: str, save_interval_steps: int = 1000,
                 keep: int = 2, install_sigterm_handler: bool = True,
                 event_sink: Optional[Callable] = None,
                 corrupt_keep: Optional[int] = None,
                 fingerprint=None):
        self.directory = directory
        self._event_sink = event_sink
        #: optional TreeFingerprint: when set, every save
        #: stamps the live tree digest into the manifest and every
        #: restore re-verifies it (load_sharded's round-trip check) —
        #: the supervisor's IntegrityGuard shares the instance so the
        #: checkpoint stamp and the cross-worker compare use one digest
        self.fingerprint = fingerprint
        self.save_interval_steps = int(save_interval_steps)
        self.keep = keep
        self.corrupt_keep = (int(os.environ.get(CORRUPT_KEEP_ENV, "2"))
                             if corrupt_keep is None else int(corrupt_keep))
        #: generation fencing: when bound to a world descriptor
        #: (or an explicit fence callable), a commit whose generation is
        #: older than the fleet's is refused with StaleGeneration
        self.generation: Optional[int] = None
        self._fence: Optional[Callable[[], Optional[int]]] = None
        self._pending: Optional[AsyncSaveHandle] = None
        self._save_seq = 0
        self._latest_state: Any = None
        self._latest_step: int = -1
        self._lock = threading.Lock()
        self._prev_handler = None
        if install_sigterm_handler:
            try:
                self._prev_handler = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except ValueError:  # not the main thread
                self._prev_handler = None

    # -- supervision hookup ------------------------------------------------
    def set_event_sink(self, sink: Optional[Callable]) -> None:
        """``sink(kind, **fields)`` — the run supervisor's report; every
        quarantine/restore decision becomes a recorded event so rollback
        can target (and post-mortems can explain) the right step."""
        self._event_sink = sink

    def _emit(self, kind: str, **fields) -> None:
        if self._event_sink is not None:
            try:
                self._event_sink(kind, **fields)
            except Exception as e:
                vlog(0, "elastic: event sink failed for %s: %s", kind, e)

    # -- generation fencing ------------------------------------------------
    def set_generation(self, generation: Optional[int],
                       fence: Optional[Callable[[], Optional[int]]] = None
                       ) -> None:
        """Stamp this worker's world generation; ``fence()`` (when given)
        returns the fleet's CURRENT generation at commit time."""
        self.generation = None if generation is None else int(generation)
        if fence is not None:
            self._fence = fence

    def bind_world(self, run_dir: str,
                   generation: Optional[int] = None,
                   worker_id: Optional[int] = None) -> None:
        """Fence commits against ``<run_dir>/world.json``: reads the
        live descriptor's generation at every commit.  ``generation``
        defaults to the descriptor's current value (joining worker).

        With ``worker_id`` given, a worker that is STILL A MEMBER of a
        newer world may commit before it has polled the bump (it will
        rewind at its next poll); only a worker the fleet retired — the
        actual zombie — is fenced.  Without it, any newer generation
        fences (strict mode)."""
        if generation is None:
            desc = read_world(run_dir)
            generation = desc["generation"] if desc else 0

        def fence() -> Optional[int]:
            desc = read_world(run_dir)
            if not desc:
                return None
            if worker_id is not None and int(worker_id) in desc.get(
                    "members", []):
                return None   # still a member: no objection
            return desc.get("generation")

        self.set_generation(generation, fence=fence)

    def _check_fence(self, step: int) -> None:
        if self.generation is None or self._fence is None:
            return
        current = self._fence()
        if current is None or int(current) <= self.generation:
            return
        self._emit("elastic.fence_rejected", step=step,
                   generation=self.generation, current_generation=current)
        raise StaleGeneration(
            f"refusing to commit step {step}: this worker holds world "
            f"generation {self.generation} but the fleet is at "
            f"{current} — the run moved on without it")

    def last_good_step(self) -> int:
        """Newest committed (restorable) step number, -1 when none exist —
        the step auto-rollback will land on."""
        done = committed_checkpoints(self.directory)
        if not done:
            return -1
        return int(os.path.basename(done[0])[len(_STEP_PREFIX):])

    # -- save --------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step}")

    def _commit(self, step: int, stage: str) -> None:
        """Promote the staging dir to a durable committed ``step-N/``.

        Fenced: a worker whose world generation went stale
        between save() and commit must NOT publish — the staging dir is
        dropped and :class:`StaleGeneration` surfaces out of ``wait()``
        (or synchronously for ``use_async=False`` saves)."""
        final = self._path(step)
        try:
            self._check_fence(step)
        except StaleGeneration:
            if stage != final and os.path.isdir(stage):
                shutil.rmtree(stage, ignore_errors=True)
            raise
        if stage != final:
            if os.path.isdir(final):
                # leftover from an earlier crashed/uncommitted save of the
                # same step — the fresh staging dir supersedes it
                shutil.rmtree(final)
            os.replace(stage, final)  # noqa: fsio — dir rename; parent fsync'd below
        # multi-host: every process wrote its own shards straight into
        # ``final`` (no per-process rename possible over a shared dir);
        # the COMMITTED marker below is still the only eligibility gate
        fsio.write_bytes(os.path.join(final, "COMMITTED"), b"")
        fsio.fsync_dir(self.directory)
        self._gc()

    def _stage_path(self, step: int) -> str:
        # single-host saves stage into step-N.<seq>.tmp then os.replace
        # into place; the per-manager sequence number makes the staging dir
        # unique per save attempt, so a SIGTERM handler re-entering save()
        # mid-write can never clobber the interrupted save's staging area.
        # Multi-host processes share one directory and rely on the
        # COMMITTED marker alone.
        if get_world_size() == 1:
            self._save_seq += 1
            return f"{self._path(step)}.{self._save_seq}{_TMP_SUFFIX}"
        return self._path(step)

    def _integrity_meta(self, step: int, state) -> Optional[Dict[str, Any]]:
        """Manifest fingerprint stamp for ``state`` (None when digesting
        is off).  Computed synchronously BEFORE the save serializes
        anything — the whole point is that the digest describes the live
        tree, so corruption between here and the shard writes is caught
        at restore even though every CRC passes."""
        if self.fingerprint is None:
            return None
        fpr = self.fingerprint.digest(state)
        meta = fpr.meta()
        meta["exclude"] = list(self.fingerprint.exclude)
        self._emit("checkpoint_digest", step=step, digest=fpr.hex(),
                   excluded=len(fpr.excluded))
        return meta

    def save(self, step: int, state, *, use_async: bool = True) -> None:
        self.wait()
        stage = self._stage_path(step)
        if stage.endswith(_TMP_SUFFIX) and os.path.isdir(stage):
            shutil.rmtree(stage)  # stale staging dir from a crashed save
        vlog(1, "elastic: saving checkpoint %s", self._path(step))
        integrity = self._integrity_meta(step, state)
        if use_async:
            handle = save_sharded(state, stage, use_async=True,
                                  integrity=integrity)
            mgr = self
            errors: list = []

            def _finish(h=handle, s=step, st=stage):
                try:
                    h.wait()
                    mgr._commit(s, st)
                except Exception as e:  # surfaced by self.wait()
                    errors.append(e)

            t = threading.Thread(target=_finish, daemon=True)
            t.start()
            self._pending = AsyncSaveHandle(t, errors)
        else:
            save_sharded(state, stage, integrity=integrity)
            self._commit(step, stage)

    def maybe_save(self, step: int, state) -> bool:
        """Track the live state; checkpoint every save_interval_steps."""
        with self._lock:
            self._latest_state = state
            self._latest_step = step
        if step > 0 and step % self.save_interval_steps == 0:
            self.save(step, state)
            return True
        return False

    def finalize(self, step: int, state) -> None:
        self.save(step, state, use_async=False)
        self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

    # -- restore -----------------------------------------------------------
    def _fallback_kind(self, e: Exception) -> str:
        if isinstance(e, DigestMismatch):
            return "digest mismatch"
        if isinstance(e, CheckpointCorruption):
            return "corruption"
        return "load failure"

    def _note_fallback(self, step: Optional[int], path: str, reason: str,
                       error: str = "") -> None:
        """every step the restore chain skips gets a named
        ``restore.fallback`` event + counter — older-step fallback used
        to be silent in the timeline, which hid exactly the evidence an
        SDC post-mortem needs (which steps were skipped and why)."""
        self._emit("restore.fallback", step=step, path=path,
                   reason=reason, error=error)
        try:
            from ..observability.registry import get_registry
            reg = get_registry()
            reg.counter("restore.fallbacks").inc()
            reg.emit("restore.fallback", step=step, reason=reason,
                     path=path)
        except Exception as e:
            vlog(1, "elastic: fallback metrics failed: %r", e)

    def _note_uncommitted(self) -> None:
        """Fallback events for step dirs that never got a COMMITTED
        marker (crashed mid-save): the restore walk silently ignores
        them, the timeline should not."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in sorted(entries, reverse=True):
            if (not name.startswith(_STEP_PREFIX)
                    or name.endswith((_TMP_SUFFIX, _CORRUPT_SUFFIX))):
                continue
            full = os.path.join(self.directory, name)
            if not os.path.exists(os.path.join(full, "COMMITTED")):
                self._note_fallback(_step_of(name), full,
                                    "missing COMMITTED")

    def restore_or(self, init_fn: Callable[[], Any],
                   template_fn: Callable[[], Any]):
        """(state, start_step): restore the newest VALID committed
        checkpoint into ``template_fn()``'s placement, else
        ``(init_fn(), 0)``.

        Fallback chain: committed steps are tried newest→oldest; any that
        fail manifest/checksum validation, tree-digest re-verification,
        or raise during load are quarantined to ``step-N.corrupt/`` and
        the next one is tried — each skip named by a ``restore.fallback``
        event (corrupt / digest mismatch / missing COMMITTED).  A single
        flipped bit therefore costs one checkpoint interval, not the run.
        """
        self._note_uncommitted()
        for path in committed_checkpoints(self.directory):
            step = int(os.path.basename(path)[len(_STEP_PREFIX):])
            vlog(1, "elastic: restoring %s", path)
            try:
                return load_sharded(path, template_fn()), step + 1
            except Exception as e:
                kind = self._fallback_kind(e)
                vlog(0, "elastic: %s restoring %s (%s) — quarantining and "
                     "falling back to the previous committed step",
                     kind, path, e)
                self._note_fallback(step, path, kind, error=str(e))
                self._quarantine(path, reason=kind, error=str(e))
        return init_fn(), 0

    def _quarantine(self, path: str, reason: str = "corruption",
                    error: str = "") -> None:
        dst = path + _CORRUPT_SUFFIX
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.replace(path, dst)  # noqa: fsio — dir rename; parent fsync'd below
        fsio.fsync_dir(self.directory)
        self._emit("checkpoint_quarantined", path=path, step=_step_of(
            os.path.basename(path)), reason=reason, error=error,
            next_good_step=self.last_good_step())

    # -- preemption --------------------------------------------------------
    def _on_sigterm(self, signum, frame) -> None:
        with self._lock:
            state, step = self._latest_state, self._latest_step
        if state is not None:
            vlog(0, "elastic: SIGTERM — flushing checkpoint at step %d", step)
            # a pending async save may be mid-flight (or mid-failure): its
            # _finish thread can surface an exception out of save()'s
            # wait() INSIDE this signal handler — absorb it and still
            # write the final synchronous checkpoint, which is the one
            # restart depends on
            try:
                self.wait()
            except Exception as e:
                vlog(0, "elastic: pending async save failed during SIGTERM "
                     "(%s) — writing final checkpoint anyway", e)
                self._pending = None
            try:
                self.save(step, state, use_async=False)
            except Exception as e:
                vlog(0, "elastic: final checkpoint flush failed: %s", e)
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _gc(self) -> None:
        """Prune old committed steps (keep newest ``self.keep``) and sweep
        stale debris — uncommitted ``step-*`` dirs, ``.tmp`` staging dirs
        and ``.corrupt`` quarantines STRICTLY OLDER than the newest
        committed step (crashed async saves must not leak disk forever;
        newer-or-equal debris is left alone: it may be another process's
        in-flight save or evidence worth keeping).  Quarantines are
        additionally bounded to the newest ``corrupt_keep``
        (``PTPU_CORRUPT_KEEP``, default 2) REGARDLESS of age — a
        corrupt-prone volume otherwise accumulates evidence forever."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        committed = sorted(
            (int(n[len(_STEP_PREFIX):]) for n in entries
             if n.startswith(_STEP_PREFIX)
             and not n.endswith((_TMP_SUFFIX, _CORRUPT_SUFFIX))
             and os.path.exists(
                 os.path.join(self.directory, n, "COMMITTED"))),
            reverse=True)
        corrupt = sorted(
            ((_step_of(n), n) for n in entries
             if n.endswith(_CORRUPT_SUFFIX) and _step_of(n) is not None),
            reverse=True)
        kept_corrupt = {n for _s, n in corrupt[:max(0, self.corrupt_keep)]}
        for _step, name in corrupt[max(0, self.corrupt_keep):]:
            vlog(1, "elastic: gc bounding quarantine %s", name)
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
        if not committed:
            return
        if self.keep:
            for step in committed[self.keep:]:
                shutil.rmtree(self._path(step), ignore_errors=True)
        newest = committed[0]
        for name in entries:
            step = _step_of(name)
            if step is None or step >= newest or name in kept_corrupt:
                continue
            full = os.path.join(self.directory, name)
            is_stale = (name.endswith((_TMP_SUFFIX, _CORRUPT_SUFFIX))
                        or not os.path.exists(
                            os.path.join(full, "COMMITTED")))
            if is_stale:
                vlog(1, "elastic: gc removing stale %s", full)
                shutil.rmtree(full, ignore_errors=True)
