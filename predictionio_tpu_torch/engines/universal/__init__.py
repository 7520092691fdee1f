from predictionio_tpu_torch.engines.universal.engine import (
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    URAlgorithm,
    URAlgorithmParams,
    URDataSource,
    UniversalRecommenderEngine,
)

__all__ = [
    "DataSourceParams",
    "ItemScore",
    "PredictedResult",
    "Query",
    "URAlgorithm",
    "URAlgorithmParams",
    "URDataSource",
    "UniversalRecommenderEngine",
]
