"""The training worker fleet on one host.

Counterpart of the JAX package's ``fleet/`` cut to its coordinator
(``coordinator.py``): N ``TrainScheduler`` workers over one shared job
queue, with compare-and-set claims, heartbeating worker records and
``fleet status``, and the compare-and-set election the replicated
event store fails over through (``election.py``). The JAX package's
multi-host wiring
(``distributed.py``) and its sharded serving runtime (``runtime.py``)
are not ported. Importing the package loads no torch.
"""

from predictionio_tpu_torch.fleet.coordinator import (
    WORKER_ENTITY,
    FleetConfig,
    FleetMember,
    WorkerInfo,
    WorkerRegistry,
    fleet_status,
    measure_write_visibility_skew,
    worker_device_info,
)

__all__ = [
    "FleetConfig",
    "FleetMember",
    "WORKER_ENTITY",
    "WorkerInfo",
    "WorkerRegistry",
    "fleet_status",
    "measure_write_visibility_skew",
    "worker_device_info",
]
