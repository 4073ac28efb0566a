"""Legacy reader decorators and ``paddle.batch``: the port of
``paddle_tpu/reader.py`` (reference python/paddle/reader/decorator.py and
batch.py).

Generator combinators on the host, the JAX module's line for line, so
one seeded reader gives both packages the same samples in the same order
(``shuffle`` draws from Python's ``random`` module).  ``xmap_readers``
and ``multiprocess_reader`` keep their signatures and run in-process;
``io.DataLoader(num_workers=...)`` is the parallel loader.
"""
from __future__ import annotations

import itertools
import random as _random
from typing import Callable

__all__ = ["batch", "cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "multiprocess_reader",
           "retry_reader"]


def retry_reader(reader: Callable, max_attempts: int = 3,
                 retryable=(OSError,), base_delay: float = 0.05,
                 sleep=None):
    """Absorb transient errors from a flaky reader (resilience layer).

    Remote/filesystem-backed readers raise transient ``OSError``s under
    the fleet-style workload.  A generator is dead the moment it raises,
    so a plain retry loses the epoch; this combinator re-creates the
    underlying iterator and fast-forwards past the samples already
    delivered, with exponential backoff between attempts.  The error
    budget resets after each successfully delivered sample, so one flaky
    sample can't starve a long epoch.  Non-retryable exceptions propagate
    immediately; when the budget is exhausted a
    :class:`~paddle_tpu_torch.utils.retry.RetriesExhausted` (an ``OSError``)
    carrying the attempt count is raised, chained to the final
    underlying error."""
    from .utils.retry import RetriesExhausted, RetryPolicy

    policy = RetryPolicy(max_attempts=max_attempts, base_delay=base_delay,
                         retryable=tuple(retryable),
                         **({"sleep": sleep} if sleep is not None else {}))

    def robust():
        delivered = 0
        failures = 0
        while True:
            it = reader()
            try:
                for i, sample in enumerate(it):
                    if i < delivered:
                        continue  # replayed prefix after a retry
                    yield sample
                    delivered += 1
                    failures = 0
                return
            except policy.retryable as e:
                failures += 1
                if failures >= policy.max_attempts:
                    raise RetriesExhausted(
                        f"reader failed after {failures} attempt(s) at "
                        f"sample {delivered}; last error: {e!r}") from e
                policy.sleep(policy.delay(failures))
    return robust


def batch(reader: Callable, batch_size: int, drop_last: bool = False,
          retries: int = 0):
    """paddle.batch (reference batch.py:18): group samples into lists.

    ``retries > 0`` wraps the sample fetch in :func:`retry_reader` so up
    to ``retries`` consecutive transient ``OSError``s per sample are
    absorbed instead of killing the epoch."""
    if retries:
        reader = retry_reader(reader, max_attempts=retries + 1)

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def cache(reader: Callable):
    """Cache all samples in memory on first pass (decorator.py:52).
    The cache commits atomically: a reader that raises mid-pass leaves
    nothing cached, so a retry re-reads from scratch (no duplicates)."""
    data = []
    filled = []

    def cached():
        if not filled:
            fresh = list(reader())      # all-or-nothing
            data.extend(fresh)
            filled.append(True)
        return iter(data)
    return cached


def map_readers(func: Callable, *readers):
    """Zip readers, map func over the tuples (decorator.py:92)."""
    def mapped():
        its = [r() for r in readers]
        for args in zip(*its):
            yield func(*args)
    return mapped


def shuffle(reader: Callable, buf_size: int):
    """Buffered shuffle (decorator.py:134)."""
    def shuffled():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    """Concatenate readers end to end (decorator.py:183)."""
    def chained():
        return itertools.chain(*(r() for r in readers))
    return chained


def compose(*readers, **kwargs):
    """Zip readers into flat tuples (decorator.py:248).
    check_alignment=True raises when readers run out unevenly."""
    check_alignment = kwargs.pop("check_alignment", True)

    def _flatten(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    _END = object()

    def composed():
        its = [r() for r in readers]
        if check_alignment:
            # zip() would silently eat one extra element from earlier
            # readers; a sentinel-padded zip sees EVERY ragged tail
            for items in itertools.zip_longest(*its, fillvalue=_END):
                if any(i is _END for i in items):
                    raise ValueError("readers have different lengths "
                                     "(check_alignment=True)")
                yield sum((_flatten(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*its, fillvalue=_END):
                yield sum((_flatten(i) for i in items if i is not _END),
                          ())
    return composed


def buffered(reader: Callable, size: int):
    """Read-ahead buffer (decorator.py:308), kept for API parity as a
    pass-through buffer (the DataLoader's prefetch thread reads ahead)."""
    def buffered_reader():
        buf = []
        it = reader()
        for sample in it:
            buf.append(sample)
            if len(buf) >= size:
                yield from buf
                buf = []
        yield from buf
    return buffered_reader


def firstn(reader: Callable, n: int):
    """First n samples (decorator.py:367)."""
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def xmap_readers(mapper: Callable, reader: Callable, process_num: int,
                 buffer_size: int, order: bool = False):
    """Signature-compatible mapper (decorator.py:412); the mapper runs
    in-process; io.DataLoader(num_workers=...) gives host parallelism."""
    def xmapped():
        for sample in reader():
            yield mapper(sample)
    return xmapped


def multiprocess_reader(readers, use_pipe: bool = True,
                        queue_size: int = 1000):
    """Signature-compatible merge of readers (decorator.py:505),
    sequential in-process; see xmap_readers note."""
    def merged():
        for r in readers:
            yield from r()
    return merged
