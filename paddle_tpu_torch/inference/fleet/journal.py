"""Crash-safe stream journal, the router's write-ahead log: the port's
own copy of ``paddle_tpu/inference/fleet/journal.py``.

:class:`..router.StreamJournal` lives in a dict, so a router crash would
lose every in-flight stream even though each replica survives.
:class:`JournalStore` makes the journal durable: one JSONL file per stream
under ``<run_dir>/fleet/journal/``, every accepted token batch appended
through the fsync'd :mod:`~paddle_tpu_torch.utils.fsio` seam *before* the
in-memory journal advances (write-ahead), so a fresh
``Router(recover=run_dir)`` rebuilds each stream from the directory alone
and completions stay token-exact across a router SIGKILL.

File format (one JSON object per line), the JAX package's byte for byte,
so a journal directory written by either package's router recovers in
the other's:

    {"v": 1, "kind": "open", "request_id": ..., "prompt": [...],
     "max_new_tokens": N, "eos_token_id": E, "session": S,
     "trace_id": T}
    {"kind": "disp", "replica": R, "trace_id": T}   # dispatched/failed-over
    {"kind": "tok", "t": [t0, t1, ...]}        # accepted tokens
    {"kind": "fin", "reason": "length"}         # terminal marker

Every line additionally carries ``ts`` (wall clock) and ``mono``
(monotonic) stamps so a trace assembler can align WAL events with router
and worker spans and order them within a file even across wall-clock
steps.

Recovery reads complete lines only: a torn tail (the append the crash
interrupted) is dropped with accounting, never an error, and cut off the
live file, so the recovered router's next append starts a fresh line.  (The
JAX store leaves the torn bytes in place; its next append then extends
them into one unreadable line, and the recovery after that loses the
tokens that line carried.)  A dropped
token line merely shrinks the accepted prefix; the replica (or a
recompute re-dispatch) regenerates the same tokens, greedy decode being
deterministic.  A file whose ``open`` header is unreadable is quarantined
to ``*.corrupt`` — the stream is lost to recovery (the prompt never became
durable) but the directory stays parseable.

On completion a stream's file is retired (renamed ``*.done``) and retired
files are GC'd down to the newest ``PTPU_FLEET_JOURNAL_KEEP``, so a
long-lived router never accumulates evidence without bound.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence

from ...utils import fsio

__all__ = ["JOURNAL_KEEP_ENV", "default_journal_keep", "JournalStore"]

JOURNAL_KEEP_ENV = "PTPU_FLEET_JOURNAL_KEEP"

_SUFFIX = ".jsonl"
_DONE_SUFFIX = ".jsonl.done"
_CORRUPT_SUFFIX = ".jsonl.corrupt"


def default_journal_keep() -> int:
    """Retired journal files kept per directory (newest first)."""
    return int(os.environ.get(JOURNAL_KEEP_ENV, "16"))


def journal_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "fleet", "journal")


class JournalStore:
    """Durable per-stream WAL under ``<run_dir>/fleet/journal/``.

    All writes go through ``fsio.append_bytes`` (fsync'd, fault-
    injectable); :meth:`recover` is torn-tail tolerant.  ``drops``
    accounts for what recovery discarded (mirroring the worker-stream
    readers): ``torn_lines`` and ``corrupt_files``.
    """

    def __init__(self, run_dir: str, keep: Optional[int] = None):
        self.run_dir = run_dir
        self.directory = journal_dir(run_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep if keep is not None
                        else default_journal_keep())
        self.appends = 0
        self.drops: Dict[str, int] = {"torn_lines": 0,
                                      "corrupt_files": 0}

    def _path(self, request_id: str) -> str:
        safe = re.sub(r"[^\w.-]", "_", str(request_id))
        return os.path.join(self.directory, safe + _SUFFIX)

    def _append(self, request_id: str, payload: Dict[str, Any]) -> None:
        # every WAL line is timestamped: wall clock for
        # cross-process trace alignment, monotonic for intra-file
        # ordering that survives wall-clock steps
        payload.setdefault("ts", time.time())
        payload.setdefault("mono", time.monotonic())
        fsio.append_bytes(self._path(request_id),
                          (json.dumps(payload) + "\n").encode())
        self.appends += 1

    # -- writing -----------------------------------------------------------
    def open(self, request_id: str, prompt: Sequence[int],
             max_new_tokens: int, eos_token_id: Optional[int],
             session: Optional[str] = None,
             tokens: Sequence[int] = (),
             trace_id: Optional[str] = None) -> None:
        """Durably record a stream's existence (before first dispatch).
        ``tokens`` seeds an already-accepted prefix — the re-journal
        path when recovery itself crashes before finishing."""
        self._append(request_id,
                     {"v": 1, "kind": "open", "request_id": request_id,
                      "prompt": [int(t) for t in prompt],
                      "max_new_tokens": int(max_new_tokens),
                      "eos_token_id": eos_token_id, "session": session,
                      "trace_id": trace_id})
        if tokens:
            self.append_tokens(request_id, tokens)

    def append_tokens(self, request_id: str,
                      tokens: Sequence[int]) -> None:
        """Write-ahead one accepted token batch."""
        self._append(request_id,
                     {"kind": "tok", "t": [int(t) for t in tokens]})

    def retire(self, request_id: str,
               reason: Optional[str] = None) -> None:
        """Mark a stream finished and move its file out of the live
        set; bounded GC runs afterward.  Missing files are fine (the
        stream may predate journaling or have been retired already)."""
        path = self._path(request_id)
        if not os.path.exists(path):
            return
        self._append(request_id, {"kind": "fin", "reason": reason})
        os.replace(path, path[: -len(_SUFFIX)] + _DONE_SUFFIX)  # noqa: fsio — rename of an already-fsync'd file; dir fsync'd below
        fsio.fsync_dir(self.directory)
        self.gc()

    def discard(self, request_id: str) -> None:
        """Drop a stream's journal without the finished marker (the
        admission it recorded was refused)."""
        try:
            os.remove(self._path(request_id))
        except OSError:
            pass

    # -- recovery ----------------------------------------------------------
    def _read_one(self, path: str,
                  quarantine: bool = True) -> Optional[Dict[str, Any]]:
        """Parse one journal file, complete lines only."""
        try:
            raw = fsio.read_bytes(path)
        except OSError:
            return None
        end = raw.rfind(b"\n")
        if end >= 0 and end + 1 < len(raw):
            self.drops["torn_lines"] += 1     # mid-append tail dropped
            if quarantine:
                # cut the torn tail off the live file: the next append must
                # start a line of its own, not extend the torn one into an
                # unreadable line that a later recovery drops whole (with
                # the tokens it carried, leaving a gap in the stream)
                fsio.truncate_bytes(path, end + 1)
        lines = raw[: end + 1].decode("utf-8", errors="replace") \
            .splitlines() if end >= 0 else []
        header: Optional[Dict[str, Any]] = None
        tokens: List[int] = []
        finished = False
        reason = None
        replica: Optional[int] = None
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                self.drops["torn_lines"] += 1
                continue
            kind = rec.get("kind")
            if kind == "open" and header is None:
                header = rec
            elif kind == "disp":
                replica = rec.get("replica")
            elif kind == "tok":
                tokens.extend(int(t) for t in rec.get("t", []))
            elif kind == "fin":
                finished = True
                reason = rec.get("reason")
        if header is None:
            # the prompt never became durable — nothing to resume
            self.drops["corrupt_files"] += 1
            if quarantine:
                os.replace(path,  # noqa: fsio — quarantine rename; dir fsync'd below
                           path[: -len(_SUFFIX)] + _CORRUPT_SUFFIX)
                fsio.fsync_dir(self.directory)
            return None
        return {"request_id": header["request_id"],
                "prompt": [int(t) for t in header.get("prompt", [])],
                "max_new_tokens": int(header.get("max_new_tokens", 0)),
                "eos_token_id": header.get("eos_token_id"),
                "session": header.get("session"),
                "tokens": tokens, "finished": finished,
                "reason": reason, "replica": replica,
                "trace_id": header.get("trace_id"),
                "opened_ts": header.get("ts")}

    def recover(self) -> List[Dict[str, Any]]:
        """Every stream's durable state, oldest-first — the input
        ``Router(recover=...)`` rebuilds its journals from.  Live files
        first; retired (``.done``) files ride along as finished streams
        so a client that re-asks the recovered router for a stream that
        completed JUST before the crash still gets its tokens (bounded
        by the ``.done`` GC keep, not forever)."""
        try:
            listing = os.listdir(self.directory)
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        seen = set()
        for name in sorted(n for n in listing if n.endswith(_SUFFIX)):
            rec = self._read_one(os.path.join(self.directory, name))
            if rec is not None:
                seen.add(rec["request_id"])
                out.append(rec)
        for name in sorted(n for n in listing
                           if n.endswith(_DONE_SUFFIX)):
            rec = self._read_one(os.path.join(self.directory, name),
                                 quarantine=False)
            if rec is not None and rec["request_id"] not in seen:
                rec["finished"] = True   # the rename IS the fin marker
                seen.add(rec["request_id"])
                out.append(rec)
        return out

    # -- hygiene -----------------------------------------------------------
    def gc(self, keep: Optional[int] = None) -> int:
        """Bound retired/corrupt files to the newest ``keep`` of each
        kind regardless of age (bounded quarantine);
        returns how many were removed."""
        keep = self.keep if keep is None else int(keep)
        removed = 0
        for suffix in (_DONE_SUFFIX, _CORRUPT_SUFFIX):
            try:
                done = [n for n in os.listdir(self.directory)
                        if n.endswith(suffix)]
            except OSError:
                return removed
            done.sort(key=lambda n: os.path.getmtime(
                os.path.join(self.directory, n)), reverse=True)
            for name in done[keep:]:
                try:
                    os.remove(os.path.join(self.directory, name))
                    removed += 1
                except OSError:
                    pass
        return removed

    def live_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.directory)
                       if n.endswith(_SUFFIX))
        except OSError:
            return 0
