"""``paddle.utils.unique_name``: the port of ``paddle_tpu/utils/
unique_name.py`` (reference fluid/unique_name.py: ``generate`` / ``guard``
/ ``switch``, used to name parameters and ops).

``generate(key)`` gives ``key_0``, ``key_1``, ... from a per-thread
generator; ``switch`` swaps in another generator (a fresh one by default)
and returns the old one; ``guard`` does so for a ``with`` block."""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]

_state = threading.local()


def _gen() -> dict:
    g = getattr(_state, "generator", None)
    if g is None:
        g = defaultdict(int)
        _state.generator = g
    return g


def generate(key: str) -> str:
    g = _gen()
    name = f"{key}_{g[key]}"
    g[key] += 1
    return name


def switch(new_generator=None):
    old = _gen()
    _state.generator = (new_generator if new_generator is not None
                        else defaultdict(int))
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        _state.generator = old
