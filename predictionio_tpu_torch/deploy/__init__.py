"""The model lifecycle of the port: the version registry and its
records (``registry.py``), the train-job queue and its supervising
worker (``scheduler.py``), the train job's subprocess (``worker.py``)
and the canary rollout of a version on a query server, with its verdict
loop and its persisted state (``rollout.py``). Counterpart of the JAX
package's ``deploy/``."""

from predictionio_tpu_torch.deploy.registry import (
    LIFECYCLE_APP_ID,
    VERSION_STATUSES,
    ModelRegistry,
    ModelVersion,
)
from predictionio_tpu_torch.deploy.rollout import (
    RolloutConfig,
    RolloutController,
    resume_rollout,
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
    "RolloutConfig",
    "RolloutController",
    "SchedulerConfig",
    "TrainJob",
    "TrainScheduler",
    "VERSION_STATUSES",
    "resume_rollout",
]
