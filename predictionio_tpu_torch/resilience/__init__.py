"""Resilience of the port's servers: deadline propagation and fault
injection (the JAX package's ``resilience/``, cut to what the port's
servers use).

- `deadline` — the ``X-PIO-Deadline`` header as a per-request ambient
               deadline, so expired work is shed before it costs device
               time.
- `faults`   — the deterministic fault-injection registry that makes the
               shed paths, the canary rollback and the fold-in's drift
               guard testable in one process.

Neither module loads torch: the Event Server imports both. The JAX
package's retry, circuit breaker and write-ahead log serve its remote
storage backends, none of which the port has.
"""

from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.resilience.faults import FaultInjected, FaultSpec

__all__ = ["DeadlineExceeded", "FaultInjected", "FaultSpec"]
