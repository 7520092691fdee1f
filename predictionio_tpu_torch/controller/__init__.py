"""The user-facing DASE SDK of the port (the JAX package's
``controller``, without evaluation, metrics and fast eval)."""

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
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "ParamsError",
    "PersistentModel",
    "PersistentModelManifest",
    "Preparator",
    "RetrainOnDeploy",
    "RuntimeContext",
    "SanityCheck",
    "Serving",
    "SimpleEngine",
    "StopAfterPrepareInterruption",
    "StopAfterReadInterruption",
    "WorkflowParams",
    "deserialize_models",
    "extract_params",
    "load_persistent_model",
    "load_symbol",
    "params_class_of",
    "params_to_json",
    "resolve_engine",
    "serialize_models",
]
