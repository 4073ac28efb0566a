"""Retry with exponential backoff: the port's own copy of
``paddle_tpu/utils/retry.py``.

Checkpoint writes and manifest reads on a shared filesystem meet transient
``OSError``s as a matter of course.  One policy object covers them:

- exponential backoff with full jitter (``base * mult ** k``, then a
  uniform draw in ``[delay * (1 - jitter), delay]``, so hosts retrying one
  flaky server do not retry in lockstep);
- a wall-clock ``deadline``, so a shutdown's grace window is not spent
  sleeping;
- a ``retryable`` exception filter: anything else propagates on the first
  raise (a corrupt checkpoint must not be retried into).

``sleep`` is injectable, so tests count attempts without waiting.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "retry_call", "retryable", "RetriesExhausted"]


class RetriesExhausted(OSError):
    """Raised when every attempt failed; ``__cause__`` is the last error."""


class RetryPolicy:
    """Immutable description of a retry schedule.

    >>> policy = RetryPolicy(max_attempts=4, base_delay=0.05)
    >>> retry_call(flaky_write, path, data, policy=policy)
    """

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 jitter: float = 0.5, deadline: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...] = (OSError,),
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.sleep = sleep

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 - self.jitter * random.random()
        return d


#: the default for small-file checkpoint I/O: up to 4 attempts (absorbs 3
#: transient errors in a row), ~0.35 s of backoff at worst
DEFAULT_IO_POLICY = RetryPolicy()


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Non-retryable exceptions propagate at once.  When the attempts (or the
    deadline) run out, raises :class:`RetriesExhausted` chained to the last
    error, so callers still see the root cause.
    """
    policy = policy or DEFAULT_IO_POLICY
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except policy.retryable as e:
            last = e
            if attempt == policy.max_attempts:
                break
            d = policy.delay(attempt)
            if (policy.deadline is not None
                    and time.monotonic() - start + d > policy.deadline):
                break
            policy.sleep(d)
    raise RetriesExhausted(
        f"{getattr(fn, '__name__', fn)!s} failed after "
        f"{policy.max_attempts} attempts: {last}") from last


def retryable(policy: Optional[RetryPolicy] = None):
    """Decorator form of :func:`retry_call`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, **kwargs)
        return inner
    return wrap
