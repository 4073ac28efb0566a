"""The persistent compilation cache, the port of
``paddle_tpu/observability/compilecache.py``.

The JAX package persists XLA executables to disk when
``PTPU_COMPILE_CACHE_DIR`` is set, so a second process skips the
compiler.  The port's compiled artefacts are its kernel libraries, and
their cache is always on: ``_kernels.BUILD_DIR``, where a library's file
name carries the digest of its sources and flags, so a process finds a
library built by any earlier one and compiles only what changed.
``PTPU_COMPILE_CACHE_DIR``, when set, names that directory, as it names
JAX's cache.

``_kernels.build`` counts ``compile.persistent_cache_requests`` (the
libraries a call wanted) and ``compile.persistent_cache_hits`` (those it
found built), so a warm start shows hits equal to requests.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

__all__ = ["maybe_enable_persistent_cache", "persistent_cache_dir",
           "reset_for_tests"]

ENV = "PTPU_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_state = {"dir": None}


def persistent_cache_dir() -> Optional[str]:
    """The directory :func:`maybe_enable_persistent_cache` returned last
    (None before its first call)."""
    return _state["dir"]


def maybe_enable_persistent_cache(registry=None) -> str:
    """The kernel build directory, after pointing it at
    ``PTPU_COMPILE_CACHE_DIR`` when that is set.  Idempotent; the cache
    itself needs no switch.  ``registry`` is accepted for the JAX call
    shape: ``_kernels.build`` counts into the global registry."""
    from .. import _kernels
    with _lock:
        want = os.environ.get(ENV, "").strip()
        if want and Path(want) != _kernels.BUILD_DIR:
            _kernels.BUILD_DIR = Path(want)
        _state["dir"] = str(_kernels.BUILD_DIR)
        return _state["dir"]


def reset_for_tests() -> None:
    """Forget the returned directory and put the build directory back to
    its default (the package's ``build/``)."""
    from .. import _kernels
    with _lock:
        _state["dir"] = None
        _kernels.BUILD_DIR = _kernels.DEFAULT_BUILD_DIR
