"""Resilience of the port's servers and storage client: fault
injection, retry, circuit breaking, deadline propagation and the event
write-ahead spill (the JAX package's ``resilience/``).

- `faults`   — the deterministic fault-injection registry that makes the
               shed paths, the canary rollback, the fold-in's drift guard
               and the storage outages testable in one process.
- `retry`    — exponential backoff with jitter under a per-call deadline
               (the remote storage client's).
- `breaker`  — the circuit breaker per endpoint and DAO (closed, open,
               half-open with one recovery probe); its transitions are
               metrics.
- `deadline` — the ``X-PIO-Deadline`` header as a per-request ambient
               deadline, so expired work is shed before it costs device
               time.
- `wal`      — the durable local write-ahead log the Event Server spills
               accepted events into while storage is unreachable, with
               ordered replay under request ids (no event lost).

No module here loads torch: the Event Server and the storage daemon
import them.
"""

from predictionio_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
    get_breaker,
)
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.resilience.faults import FaultInjected, FaultSpec
from predictionio_tpu_torch.resilience.retry import RetryPolicy
from predictionio_tpu_torch.resilience.wal import EventWAL

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceeded",
    "EventWAL",
    "FaultInjected",
    "FaultSpec",
    "RetryPolicy",
    "get_breaker",
]
