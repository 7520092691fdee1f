"""The model lifecycle of the port: the version registry and its
records (``registry.py``), the train-job queue and its supervising
worker (``scheduler.py``) and the train job's subprocess
(``worker.py``). Counterpart of the JAX package's ``deploy/``; canary
rollout is not ported."""

from predictionio_tpu_torch.deploy.registry import (
    LIFECYCLE_APP_ID,
    VERSION_STATUSES,
    ModelRegistry,
    ModelVersion,
)
from predictionio_tpu_torch.deploy.scheduler import (
    JobQueue,
    SchedulerConfig,
    TrainJob,
    TrainScheduler,
)

__all__ = [
    "LIFECYCLE_APP_ID",
    "JobQueue",
    "ModelRegistry",
    "ModelVersion",
    "SchedulerConfig",
    "TrainJob",
    "TrainScheduler",
    "VERSION_STATUSES",
]
