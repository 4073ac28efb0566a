"""Durable small-file I/O: the port's own copy of ``paddle_tpu/utils/
fsio.py``.

Every durable byte the serving engine and the fleet router write
(quarantine records, the drain spill file, the JSONL metric stream, the
router's journal) passes through these helpers:

- **durability**: every write is flushed and fsync'd before it counts;
- **atomicity**: :func:`atomic_write_bytes` stages through
  ``path + ".tmp"`` and ``os.replace``s into place, so a reader only ever
  sees an absent or a complete file;
- **one seam**: a fault harness can patch these functions to fail or tear
  every durable write from one place.
"""
from __future__ import annotations

import os

__all__ = ["write_bytes", "atomic_write_bytes", "append_bytes",
           "truncate_bytes", "read_bytes", "fsync_dir"]


def write_bytes(path: str, payload: bytes) -> None:
    """Write ``payload`` to ``path`` and fsync it (durable, not atomic)."""
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def append_bytes(path: str, payload: bytes) -> None:
    """Append ``payload`` to ``path`` and fsync it (the JSONL streams)."""
    with open(path, "ab") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def truncate_bytes(path: str, size: int) -> None:
    """Cut ``path`` to its first ``size`` bytes and fsync it (a JSONL
    stream's torn tail)."""
    with open(path, "r+b") as f:
        f.truncate(size)
        f.flush()
        os.fsync(f.fileno())


def atomic_write_bytes(path: str, payload: bytes) -> None:
    """Durably write ``payload`` so ``path`` is only ever absent or
    complete: stage into ``path + ".tmp"``, fsync, ``os.replace``."""
    tmp = path + ".tmp"
    write_bytes(tmp, payload)
    os.replace(tmp, path)


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def fsync_dir(path: str) -> None:
    """fsync a directory so renames and creates inside it are durable (a
    no-op where directory fds reject fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems reject fsync on a directory fd
    finally:
        os.close(fd)
