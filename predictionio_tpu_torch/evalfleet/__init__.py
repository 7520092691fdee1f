"""The fleet evaluation and the tuning loop.

Counterpart of the JAX package's ``evalfleet/``:

- specs:   the param-space language, the metric specs, combinable partials
- records: the durable EvalRun and per-point results (exactly once by shape)
- driver:  shard jobs on the job queue, live status, re-dispatch, winner
- worker:  the eval shard's subprocess (started by the scheduler)
- tuning:  winner → retrain preset → periodic retrain; the canary's prior

Importing the package loads no torch: the eval driver and the records run on
hosts that train nothing; only the shard subprocesses reach the device.
"""

from predictionio_tpu_torch.evalfleet.driver import EvalDriver, EvalDriverConfig
from predictionio_tpu_torch.evalfleet.records import EvalRecordStore, EvalRun
from predictionio_tpu_torch.evalfleet.specs import (
    EvalSpec,
    HeldOutRMSE,
    MAPAtK,
    NDCGAtK,
    ParamAxis,
    PrecisionAtK,
    expand_points,
    group_points,
    resolve_metric,
)
from predictionio_tpu_torch.evalfleet.tuning import (
    PresetStore,
    RetrainPreset,
    apply_preset,
    offline_prior_multiplier,
    park_winner,
    tune,
)

__all__ = [
    "EvalDriver",
    "EvalDriverConfig",
    "EvalRecordStore",
    "EvalRun",
    "EvalSpec",
    "HeldOutRMSE",
    "MAPAtK",
    "NDCGAtK",
    "ParamAxis",
    "PrecisionAtK",
    "PresetStore",
    "RetrainPreset",
    "apply_preset",
    "expand_points",
    "group_points",
    "offline_prior_multiplier",
    "park_winner",
    "resolve_metric",
    "tune",
]
