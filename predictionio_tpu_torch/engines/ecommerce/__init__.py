from predictionio_tpu_torch.engines.ecommerce.engine import (
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommerceDataSource,
    ECommerceEngine,
    ECommModel,
    ECommServing,
    ItemScore,
    PredictedResult,
    Query,
    TrainingData,
)

__all__ = [
    "DataSourceParams",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommerceDataSource",
    "ECommerceEngine",
    "ECommModel",
    "ECommServing",
    "ItemScore",
    "PredictedResult",
    "Query",
    "TrainingData",
]
