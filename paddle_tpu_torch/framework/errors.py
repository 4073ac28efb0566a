"""Enforce-style error machinery: the port's own copy of the parts of
``paddle_tpu/framework/errors.py`` that it raises (reference:
paddle/fluid/platform/enforce.h PADDLE_ENFORCE_*, phi/core/errors.h).
Exceptions carry an error class so callers can branch on category."""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base error (reference: platform/enforce.h EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


def enforce(cond: bool, msg: str = "", exc=InvalidArgumentError) -> None:
    """PADDLE_ENFORCE analog: raise ``exc`` with ``msg`` when cond is false."""
    if not cond:
        raise exc(msg)
