"""The user-facing DASE SDK of the port (the JAX package's
``controller``: stages, engines, params, persistence, evaluation,
metrics and fast eval)."""

from predictionio_tpu_torch.controller.dase import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
    SimpleEngine,
    resolve_engine,
)
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    QPAMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.params import (
    EmptyParams,
    ParamsError,
    extract_params,
    load_symbol,
    params_class_of,
    params_to_json,
)
from predictionio_tpu_torch.controller.persistent import (
    PersistentModel,
    RetrainOnDeploy,
    deserialize_models,
    load_persistent_model,
    serialize_models,
)
from predictionio_tpu_torch.core.base import (
    PersistentModelManifest,
    RuntimeContext,
    SanityCheck,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
)

__all__ = [
    "Algorithm",
    "AverageMetric",
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "EngineParamsGenerator",
    "Evaluation",
    "FastEvalEngine",
    "FirstServing",
    "IdentityPreparator",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "ParamsError",
    "PersistentModel",
    "PersistentModelManifest",
    "Preparator",
    "QPAMetric",
    "RetrainOnDeploy",
    "RuntimeContext",
    "SanityCheck",
    "Serving",
    "SimpleEngine",
    "StdevMetric",
    "StopAfterPrepareInterruption",
    "StopAfterReadInterruption",
    "SumMetric",
    "WorkflowParams",
    "ZeroMetric",
    "deserialize_models",
    "extract_params",
    "load_persistent_model",
    "load_symbol",
    "params_class_of",
    "params_to_json",
    "resolve_engine",
    "serialize_models",
]
