"""Deadline propagation: ``X-PIO-Deadline`` header ⇄ per-request budget.

The header carries the caller's **remaining budget in milliseconds**
(like gRPC's ``grpc-timeout``), never an absolute wall time, so clock
skew between hosts cannot corrupt it. On receipt, ``JsonHandler``
converts it to an absolute ``time.monotonic()`` deadline in a
ContextVar; the query server's handler and its micro-batch dispatcher
read `remaining()` and shed work whose deadline already passed (503 +
``Retry-After``) before the device is touched.

Counterpart of the JAX package's ``resilience/deadline.py``; the same
functions with the same semantics.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Iterator, Optional

HEADER = "X-PIO-Deadline"

_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "pio_deadline", default=None
)


class DeadlineExceeded(Exception):
    """The work's deadline passed before (or while) it ran."""


def current() -> Optional[float]:
    """Absolute ``time.monotonic()`` deadline, or None when unset."""
    return _deadline.get()


def set_deadline(at: Optional[float]) -> contextvars.Token:
    return _deadline.set(at)


def reset(token: contextvars.Token) -> None:
    _deadline.reset(token)


def remaining() -> Optional[float]:
    at = _deadline.get()
    return None if at is None else at - time.monotonic()


def expired() -> bool:
    rem = remaining()
    return rem is not None and rem <= 0


def from_budget(seconds: float) -> float:
    """Budget in seconds → absolute monotonic deadline."""
    return time.monotonic() + seconds


def parse_header(value: Optional[str]) -> Optional[float]:
    """Header string (remaining ms) → absolute monotonic deadline.
    Malformed or absurd values are ignored (None): a bad client header
    must not 500 the request."""
    if not value:
        return None
    try:
        ms = float(value)
    except ValueError:
        return None
    if not -1e12 < ms < 1e12:  # rejects inf, nan and absurd values
        return None
    return time.monotonic() + ms / 1000.0


def header_value(at: Optional[float] = None) -> Optional[str]:
    """Remaining budget as the header string (floored at 0, so that an
    expired deadline propagates as expired, not as unset)."""
    at = at if at is not None else _deadline.get()
    if at is None:
        return None
    return str(max(0, int((at - time.monotonic()) * 1000)))


@contextmanager
def deadline_scope(at: Optional[float]) -> Iterator[None]:
    """Scope an absolute deadline over a block (no-op when None)."""
    if at is None:
        yield
        return
    token = _deadline.set(at)
    try:
        yield
    finally:
        _deadline.reset(token)
