"""Request tracing: X-Request-ID propagation + structured JSON access logs.

The port's own copy of the JAX package's ``obs/tracing.py``.

A request's trace id is either taken from its `X-Request-ID` header or
generated at parse time, stored in a ContextVar for the duration of the
handler (each connection runs on its own thread, so the var is
effectively request-scoped), echoed back in the response headers, and
stamped onto the structured access-log record. Anything that logs while
handling the request can pick the id up via `current_trace_id()` and
correlate across processes."""

from __future__ import annotations

import contextvars
import json
import logging
import time
import uuid
from contextlib import contextmanager
from typing import Iterator, Optional

_trace_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pio_trace_id", default=None
)

# one logger for all servers' access lines; records are single JSON
# objects so a collector ingests them without a parse grammar
access_log = logging.getLogger("predictionio_tpu_torch.access")


def new_request_id() -> str:
    return uuid.uuid4().hex


def current_trace_id() -> Optional[str]:
    return _trace_id.get()


def set_trace_id(trace_id: Optional[str]) -> contextvars.Token:
    return _trace_id.set(trace_id)


def reset_trace_id(token: contextvars.Token) -> None:
    _trace_id.reset(token)


@contextmanager
def trace_context(trace_id: Optional[str] = None) -> Iterator[str]:
    """Scope a trace id over a block (non-HTTP entry points: CLI, tests)."""
    tid = trace_id or new_request_id()
    token = set_trace_id(tid)
    try:
        yield tid
    finally:
        reset_trace_id(token)


def log_access(
    server: str,
    method: str,
    path: str,
    status: int,
    duration_s: float,
    trace_id: Optional[str] = None,
) -> None:
    """Emit one structured access-log record for a completed request."""
    if not access_log.isEnabledFor(logging.INFO):
        return
    record = {
        "ts": round(time.time(), 3),
        "server": server,
        "method": method,
        "path": path,
        "status": status,
        "duration_ms": round(duration_s * 1e3, 3),
        "trace_id": trace_id or current_trace_id(),
    }
    access_log.info(json.dumps(record, separators=(",", ":")))
